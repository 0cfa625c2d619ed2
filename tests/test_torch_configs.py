"""The port's flag parser, configs and camera presets against the JAX
package's: the same command line gives the same values, for every config the
JAX package has; the same sequence arguments give the same (camera, frame)
sequence."""
import dataclasses
from pathlib import Path

import pytest

import humanrf_torch.evaluation.presets as t_presets
import humanrf_tpu.evaluation.presets as j_presets
from humanrf_torch.configs import args as t_args
from humanrf_torch.r4 import r4_flags
from humanrf_tpu.configs import args as j_args

REPO = Path(__file__).resolve().parent.parent
CONFIGS = sorted(p.stem for p in (REPO / "humanrf_tpu" / "configs").glob("example_*.py"))


def test_the_port_has_every_config_of_the_jax_package():
    ported = sorted(p.stem for p in (REPO / "humanrf_torch" / "configs").glob("example_*.py"))
    assert CONFIGS and ported == CONFIGS


COMMAND_LINES = {
    "defaults": [],
    **{name: ["--config", name] for name in CONFIGS},
    "override": ["--config", "example_synthetic", "--training.max_steps", "50_001", "--dataset.frame_numbers",
                 "3", "4", "--test.trajectory_via_keycams", "1", "2", "--tpu.profile_dir", "prof",
                 "--training.bce_loss_weight", "0.5", "--dataset.crop_center_square", "yes"],
    "r4": r4_flags(Path("scene"), Path("ws"), 600, 300, device="cuda"),
}


def _without_port_only(tree: dict) -> dict:
    """The parsed flags without the port's own (`args.PORT_ONLY_FLAGS`)."""
    tree = {k: dict(v) if isinstance(v, dict) else v for k, v in tree.items()}
    for name in t_args.PORT_ONLY_FLAGS:
        section, key = name.split(".")
        del tree[section][key]
    return tree


@pytest.mark.parametrize("name", sorted(COMMAND_LINES))
def test_parse_args_matches_the_jax_cli(name):
    """The same values as the JAX CLI's, flag for flag, where the port's own
    flags (`PORT_ONLY_FLAGS`, which the JAX CLI lacks) stay at their defaults."""
    argv = COMMAND_LINES[name]
    ported = dataclasses.asdict(t_args.parse_args(argv))
    defaults = dataclasses.asdict(t_args.parse_args([]))
    for flag in t_args.PORT_ONLY_FLAGS:
        section, key = flag.split(".")
        assert ported[section][key] == defaults[section][key], flag
    assert _without_port_only(ported) == dataclasses.asdict(j_args.parse_args(argv))


@pytest.mark.parametrize("argv", [["--model.nope", "1"], ["--train", "maybe"], ["--training.max_steps", "x"]])
def test_bad_flags_exit_as_in_the_jax_cli(argv):
    for parse in (t_args.parse_args, j_args.parse_args):
        with pytest.raises(SystemExit):
            parse(argv)


@pytest.mark.parametrize("knobs", [
    [],
    ["--tpu.sampling", "proposal"],
    ["--tpu.sampling", "proposal", "--tpu.march_grid_factor", "4", "--tpu.proposal_resolution", "192",
     "--tpu.proposal_samples_per_ray", "64", "--tpu.proposal_uniform_bonus", "0.02",
     "--tpu.render_samples_per_ray", "8"],
])
def test_knob_warnings_match_the_jax_cli(knobs):
    assert t_args._TPU_KNOB_HELP == j_args._TPU_KNOB_HELP
    assert (t_args.warn_pipeline_knobs(t_args.parse_args(knobs).tpu)
            == j_args.warn_pipeline_knobs(j_args.parse_args(knobs).tpu))


SYNTHETIC_SPLIT = {"siggraph_train": (0, 1, 2, 4, 5, 7, 8, 10), "siggraph_train_validation": (3, 6, 9),
                   "siggraph_test": (11,), "siggraph_vmaf": (11,)}


def test_preset_constants_match():
    assert t_presets.camera_configs == j_presets.camera_configs
    assert t_presets.frame_configs == j_presets.frame_configs
    assert t_presets._SIGGRAPH_LANDSCAPE_ROTATION == j_presets._SIGGRAPH_LANDSCAPE_ROTATION


@pytest.mark.parametrize("override", [None, SYNTHETIC_SPLIT], ids=["actorshq", "synthetic"])
@pytest.mark.parametrize("coverage,preset", [
    ("siggraph_test", "siggraph_test"),
    ("exhaustive", "siggraph_train_validation"),
    ("uniform", "siggraph_train_validation"),
    ("uniform", "siggraph_train"),
])
def test_render_sequences_match(coverage, preset, override):
    for frames, repeat_cameras, repeat_frames in [(list(range(15, 65)), 1, 1), ([0, 7, 3], 2, 2), ([4], 1, 1)]:
        kwargs = dict(coverage=coverage, camera_preset=preset, frame_numbers=frames, repeat_cameras=repeat_cameras,
                      repeat_frames=repeat_frames, camera_configs_override=override)
        assert t_presets.get_render_sequence(**kwargs) == j_presets.get_render_sequence(**kwargs)
    with pytest.raises(NotImplementedError):
        t_presets.get_render_sequence("nope", preset, [0], camera_configs_override=override)
