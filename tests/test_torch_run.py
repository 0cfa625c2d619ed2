"""`python -m humanrf_torch.run` against `python -m humanrf_tpu.run` on the
CPU: one scene written by the JAX generator, one step-0 checkpoint written by
the JAX package that both CLIs resume, the deterministic loader, the same
flags. Both train with validation, save, render the test frame and evaluate.

- The first step's loss matches within 1e-5 relative: same parameters, the
  same batch (the loaders are bit-equal) and the same step key.
- The validation PSNRs after VAL_STEPS steps are within 0.5 dB. Past the
  first step the runs part by fp32 rounding (summation order, bf16 ties in
  the MLP), so this is a bound on training, not on arithmetic.
- The workspaces hold the same files apart from TensorBoard's `run/`, and
  `config.yaml` reads back equal (PyYAML `safe_load`).
- `--training.checkpoint latest` resumes the port's run from its last save.
- Each flag whose feature is not ported raises.
"""
import functools
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import humanrf_torch.train.trainer as t_trainer
import humanrf_tpu.train.trainer as j_trainer
from humanrf_torch.run import main as t_main
from humanrf_tpu.core.synthetic import SyntheticSceneConfig, generate_synthetic_dataset
from humanrf_tpu.models.humanrf import HumanRFConfig, HumanRFModel
from humanrf_tpu.run import main as j_main
from humanrf_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint

torch.set_num_threads(2)

VAL_STEPS = 60
PSNR_GAP_DB = 0.5

_MODEL_FLAGS = {
    "--model.log2_hashmap_size": "12", "--model.n_levels": "4", "--model.finest_resolution": "128",
    "--model.density_scale": "10", "--tpu.proposal_rank": "8", "--tpu.proposal_resolution": "64",
}
_FLAGS = [
    "--config", "example_synthetic", "--device", "cpu",
    "--dataset.deterministic_loader", "true", "--dataset.max_buffer_size", "3",
    "--training.max_steps", str(VAL_STEPS), "--training.rays_initial_batch_size", "256",
    "--training.save_checkpoint_every_n_steps", str(VAL_STEPS // 2),
    "--validation.every_n_steps", str(VAL_STEPS), "--validation.rays_batch_size", "400",
    "--test.rays_batch_size", "400",
    "--tpu.sampling", "proposal", "--tpu.proposal_samples_per_ray", "32", "--tpu.render_samples_per_ray", "16",
    "--tpu.candidate_rays_factor", "2",
    "--evaluate", "true", "--evaluation.frame_numbers", "0",
    *[x for kv in _MODEL_FLAGS.items() for x in kv],
]


def _step0_checkpoint(path: Path):
    """A fresh JAX model (the CLI's model for these flags) and its fresh
    optimizer state, saved at step 0."""
    model = HumanRFModel(HumanRFConfig(
        sorted_frame_numbers=(0, 1), segment_sizes=(2,), density_scale=10.0, log2_hashmap_size=12, n_levels=4,
        finest_resolution=128, proposal_rank=8, proposal_resolution=64,
    ))
    params = model.init_params(jax.random.PRNGKey(7))
    opt_state = j_trainer.make_optimizer(1e-2, 0.5, VAL_STEPS, weight_decay=0.03).init(params)
    stats = {"lpips_vals": [], "psnr_vals": [], "ssim_vals": [], "checkpoints": [],
             "best_lpips": float("inf"), "best_psnr": 0.0, "best_ssim": 0.0}
    j_save_checkpoint(path, params, opt_state, 0, 0, stats)


def _recording(module, loss_index, losses):
    """`module.make_train_step`, wrapped to record each step's loss."""
    make = module.make_train_step

    @functools.wraps(make)
    def wrapped(*args, **kwargs):
        step = make(*args, **kwargs)

        def run(*step_args):
            out = step(*step_args)
            losses.append(out[loss_index])
            return out

        return run

    return wrapped


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    generate_synthetic_dataset(root, SyntheticSceneConfig(num_cameras=6, width=40, height=40, num_frames=2, grid_resolution=32))
    ckpt = root / "step0.ckpt"
    _step0_checkpoint(ckpt)
    flags = [*_FLAGS, "--dataset.path", str(root), "--training.checkpoint", str(ckpt)]
    losses = {"jax": [], "torch": []}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_trainer, "make_train_step", _recording(j_trainer, 2, losses["jax"]))
        mp.setattr(t_trainer, "make_train_step", _recording(t_trainer, 0, losses["torch"]))
        j_main([*flags, "--workspace", str(root / "jax")])
        result = t_main([*flags, "--workspace", str(root / "torch")])
        resumed = t_main([*flags, "--workspace", str(root / "torch"), "--training.checkpoint", "latest",
                          "--training.max_steps", str(VAL_STEPS + 5), "--evaluate", "false"])
    return {"root": root, "losses": losses, "result": result, "resumed": resumed}


def _validation_psnrs(ws: Path):
    return [float(p.split("=")[1]) for line in (ws / "validation.txt").read_text().splitlines()
            for p in line.split() if p.startswith("psnr=")]


def test_first_step_loss_matches_jax(runs):
    jl, tl = float(runs["losses"]["jax"][0]), float(runs["losses"]["torch"][0])
    assert np.isfinite(tl) and abs(tl - jl) <= 1e-5 * abs(jl), (tl, jl)


def test_validation_psnr_matches_jax(runs):
    jp, tp = _validation_psnrs(runs["root"] / "jax"), _validation_psnrs(runs["root"] / "torch")
    assert len(jp) == len(tp) == 1, (jp, tp)
    assert abs(tp[0] - jp[0]) <= PSNR_GAP_DB, (tp, jp)
    assert runs["result"]["averages"]["PSNR"] > 0


def test_workspace_layout_matches_jax(runs):
    def files(ws):
        return sorted(str(p.relative_to(ws)) for p in ws.rglob("*") if p.is_file() and p.relative_to(ws).parts[0] != "run")

    jax_files = files(runs["root"] / "jax")
    assert "checkpoints/best.ckpt" in jax_files and "results/averages.csv" in jax_files
    # The port's resume added no step checkpoint (no save point past 60).
    assert files(runs["root"] / "torch") == jax_files


def test_config_yaml_reads_back_as_the_jax_one(runs):
    jcfg = yaml.safe_load((runs["root"] / "jax" / "config.yaml").read_text())
    tcfg = yaml.safe_load((runs["root"] / "torch" / "config.yaml").read_text())
    # The port's config.yaml is the resumed run's: its three flags differ.
    tcfg["training"].update(checkpoint=jcfg["training"]["checkpoint"], max_steps=VAL_STEPS)
    tcfg.update(evaluate=True, workspace=jcfg["workspace"])
    assert tcfg == jcfg


def test_resume_from_latest_continues_from_the_saved_step(runs):
    """The first run takes steps 1..61 (the loop's max_steps + 1 bound), the
    resume 61..66 from step_00000060.ckpt."""
    assert len(runs["losses"]["torch"]) == (VAL_STEPS + 1) + 6
    stats = runs["resumed"]["train"]
    assert (stats["start_step"], stats["end_step"], stats["skipped_nonfinite"]) == (VAL_STEPS, VAL_STEPS + 6, 0)


def test_yaml_emitter_round_trips_every_scalar_kind():
    from humanrf_torch.run import yaml_dump

    tree = {"a": {"b": 1e-05, "c": 2.5, "d": 100.0, "e": "true", "f": "", "g": None, "h": [], "i": [1, 2],
                  "j": "x: y # z", "k": float("inf"), "l": 1e20, "m": Path("/p q"), "n": False, "o": {}},
            "p": ["a", "1.5"]}
    back = yaml.safe_load(yaml_dump(tree))
    assert back == {**tree, "a": {**tree["a"], "m": "/p q"}}


@pytest.mark.parametrize("flags", [
    ["--dataset.filter_light_bloom", "true"],
    ["--tpu.num_devices", "2"],
    ["--tpu.param_sharding", "fsdp"],
    ["--test.trajectory_via_keycams", "0", "1"],
    ["--test.trajectory_via_calibration_file", "calibration.csv"],
    ["--tpu.profile_dir", "profile"],
])
def test_unported_flags_raise(flags, tmp_path):
    base = ["--config", "example_synthetic", "--device", "cpu", "--workspace", str(tmp_path / "ws")]
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        t_main([*base, *flags])
    assert not (tmp_path / "ws").exists()
