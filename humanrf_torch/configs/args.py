"""The CLI's flags: nested dataclasses parsed with `argparse`.

The same flags, defaults and `--config` semantics as the JAX package's
`humanrf_tpu/configs/args.py`, kept as the port's own copy so that the port
loads nothing of the JAX package; `tests/test_torch_configs.py` holds the
two parsers equal on every config. Flags are `--<section>.<field>`;
`--config NAME` imports `humanrf_torch.configs.NAME` and puts its `config`
argv list *before* the command line's, so explicit flags override it.

The `tpu` section keeps its name so that one command line drives both CLIs;
`humanrf_torch/run.py::check_ported` says which of its knobs the port
raises on and which it accepts as moot. The port adds `PORT_ONLY_FLAGS`,
which the JAX CLI does not take; at their defaults the two parse alike.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import sys
import typing
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional, Tuple


@dataclass
class _shallow_mlp_args:
    geometry_feature_dim: int = 15
    n_neurons: int = 64
    n_hidden_layers_density: int = 1
    n_hidden_layers_color: int = 2
    sh_degree: int = 4


@dataclass
class _decomposition4d_args:
    log2_hashmap_size: int = 19
    n_features_per_level: int = 2
    n_levels: int = 16
    coarsest_resolution: int = 32
    finest_resolution: int = 2048


@dataclass
class _kplanes_args:
    """K-Planes (hybrid) widths and regulariser weights, read under
    `--model.representation kplanes` (`models/kplanes.py`; the port's own)."""

    kplanes_feature_dim: int = 32
    kplanes_resolution: int = 64
    kplanes_time_resolution: int = 25
    kplanes_multiscales: Tuple[int, ...] = (1, 2, 4, 8)
    kplanes_proposal_feature_dim: int = 8
    kplanes_proposal_resolutions: Tuple[int, ...] = (128, 256)
    kplanes_proposal_n_neurons: int = 64
    kplanes_plane_tv_weight: float = 1e-4
    kplanes_time_smoothness_weight: float = 0.1
    kplanes_l1_time_planes_weight: float = 1e-4
    kplanes_proposal_plane_tv_weight: float = 1e-4
    kplanes_proposal_time_smoothness_weight: float = 1e-3
    kplanes_proposal_l1_time_planes_weight: float = 1e-4


@dataclass
class _model_args(_shallow_mlp_args, _decomposition4d_args, _kplanes_args):
    # The field: humanrf (the 4D decomposition) | kplanes (the port's own).
    representation: str = "humanrf"
    temporal_partitioning: str = "adaptive"  # adaptive | fixed | none
    expansion_factor_threshold: float = 1.25
    fixed_segment_size: int = 12
    density_scale: float = 100
    camera_embedding_dim: int = 0


@dataclass
class _training_args:
    camera_preset: str = "siggraph_train"
    max_steps: int = 50_001
    scaler_growth_interval: int = 100_000  # accepted, inert (no GradScaler)
    checkpoint: str = "latest"
    lr: float = 1e-2
    lr_decay: float = 0.5
    # Decoupled AdamW weight decay (0 = plain Adam): the restoring force for
    # alpha-saturated regions whose rendering gradients are dead.
    weight_decay: float = 0.03
    rays_initial_batch_size: int = 8192
    samples_max_batch_size: int = 768_000
    bce_loss_weight: Optional[float] = 1e-3
    save_checkpoint_every_n_steps: int = 2500
    # The photometric loss: huber (delta 0.01) | mse (the port's own).
    photometric: str = "huber"


@dataclass
class _validation_args:
    camera_preset: str = "siggraph_train_validation"
    coverage: str = "uniform"  # exhaustive | uniform
    repeat_cameras: int = 1
    every_n_steps: int = 2500
    rays_batch_size: int = 8192


@dataclass
class _test_args:
    checkpoint: str = "best"
    trajectory_via_keycams: Optional[Tuple[int, ...]] = None
    trajectory_num_cameras: int = 200
    trajectory_via_calibration_file: Optional[Path] = None
    rays_batch_size: int = 16384


@dataclass
class _evaluation_args:
    camera_preset: str = "siggraph_test"
    coverage: str = "siggraph_test"  # siggraph_test | exhaustive | uniform
    frame_numbers: Optional[Tuple[int, ...]] = None
    rays_batch_size: int = 16384


@dataclass
class _dataset_args:
    path: Path = Path(".")
    actor: str = "Actor01"
    sequence: str = "Sequence1"
    scale: int = 4
    crop_center_square: bool = True
    filter_light_bloom: bool = False
    frame_numbers: Tuple[int, ...] = ()
    max_buffer_size: int = 200
    max_num_frames_per_batch: int = 8
    # Replace one training-pool entry synchronously per batch instead of a
    # free-running replacer thread: reproducible batches (data/loader.py).
    deterministic_loader: bool = False


@dataclass
class _tpu_args:
    """Pipeline knobs of the JAX package (no reference equivalent)."""

    samples_per_ray: int = 1024
    candidate_budget: int = 0
    use_visibility_prune: bool = True
    num_devices: int = 1
    param_sharding: str = "replicated"  # replicated | fsdp
    # Synthetic-rig camera splits instead of the frozen ActorsHQ ones.
    synthetic_presets: bool = False
    field_backend: str = "gather"  # gather | onehot | fused
    sampling: str = "dense"  # dense | proposal
    proposal_samples_per_ray: int = 32
    render_samples_per_ray: int = 32
    # Second proposal level (0 = single-level cascade).
    proposal_mid_samples_per_ray: int = 0
    proposal_uniform_bonus: float = 5e-2
    proposal_rank: int = 32
    # The tmin/tmax march runs on a max-pooled grid this many times coarser.
    march_grid_factor: int = 2
    proposal_resolution: int = 128
    proposal_loss_weight: float = 1.0
    # Candidate pixels per render slot: the step compacts hull-hitting rays
    # into the slots (train/pipeline.py). 1 disables.
    candidate_rays_factor: int = 1
    profile_dir: Optional[Path] = None
    steps_per_dispatch: int = 1


@dataclass
class _run_args:
    train: bool = False
    evaluate: bool = False
    workspace: Path = Path("workspace")
    model: _model_args = field(default_factory=_model_args)
    training: _training_args = field(default_factory=_training_args)
    validation: _validation_args = field(default_factory=_validation_args)
    evaluation: _evaluation_args = field(default_factory=_evaluation_args)
    dataset: _dataset_args = field(default_factory=_dataset_args)
    tpu: _tpu_args = field(default_factory=_tpu_args)
    config: Optional[str] = None
    random_seed: int = 123
    device: str = "tpu"  # 'tpu' (the accelerator) | 'cuda' | 'cpu'
    test: _test_args = field(default_factory=_test_args)


# The flags the port has and the JAX package has not: the second field and
# its loss (`--model.representation kplanes`, `--training.photometric`).
PORT_ONLY_FLAGS = (
    "model.representation",
    *(f"model.{f.name}" for f in dataclasses.fields(_kplanes_args)),
    "training.photometric",
)


# Measured quality trade-offs of the sampler knobs (the JAX package's knob
# probes, PERF_TPU_v5e.md: 2k-step runs on a synthetic sweep scene, best
# validation PSNR against the defaults). Quality numbers, not device times.
_TPU_KNOB_HELP = {
    "tpu.march_grid_factor": (
        "tmin/tmax march grid coarsening. Measured: 2 (default) is "
        "quality-neutral; 4 gives +16%% rays/s but -3.2 dB (wider spans "
        "dilute the proposal PDF)."
    ),
    "tpu.proposal_resolution": (
        "CP proposal factor resolution. Measured: 128 (default) validated; "
        "192 costs -2.0 dB (sharper factors concentrate before the proposal "
        "is trained)."
    ),
    "tpu.proposal_samples_per_ray": (
        "coarse proposal bins per ray (Kc). Measured: 32 (default) "
        "validated; 64 costs -1.5 dB."
    ),
    "tpu.proposal_uniform_bonus": (
        "exploration floor mixed into the resampling CDF. Measured: 5e-2 "
        "(default) validated; 2e-2 costs -1.9 dB (saturated-proposal "
        "deadlock); 0 additionally risks empty-ray degenerate CDFs."
    ),
    "tpu.render_samples_per_ray": (
        "field samples per ray (Kf). Measured: 16 (default) is the quality "
        "floor on the sweep scene; 8 (via the mid cascade) costs -3.2 dB."
    ),
}


def warn_pipeline_knobs(tpu) -> list:
    """Warnings for sampler knobs in measured-bad regions → the strings (the
    CLI prints them). Only the proposal sampler's knobs warn, and the march
    grid's."""
    out = []
    if tpu.march_grid_factor > 2:
        out.append(
            f"--tpu.march_grid_factor {tpu.march_grid_factor}: measured -3.2 dB at 4 "
            "(vs 2) — wider marched spans dilute the proposal PDF."
        )
    if tpu.sampling != "proposal":
        return out
    if tpu.proposal_resolution > 128:
        out.append(
            f"--tpu.proposal_resolution {tpu.proposal_resolution}: measured -2.0 dB at 192 "
            "(vs 128) — over-sharp proposal factors concentrate too early."
        )
    if tpu.proposal_samples_per_ray > 32:
        out.append(
            f"--tpu.proposal_samples_per_ray {tpu.proposal_samples_per_ray}: measured "
            "-1.5 dB at 64 (vs 32)."
        )
    if tpu.proposal_uniform_bonus < 5e-2:
        out.append(
            f"--tpu.proposal_uniform_bonus {tpu.proposal_uniform_bonus}: measured -1.9 dB "
            "at 2e-2 (vs 5e-2); below the exploration floor a wrongly-opaque "
            "proposal can deadlock the sampler (PERF.md round-2b)."
        )
    if 0 < tpu.render_samples_per_ray < 16:
        out.append(
            f"--tpu.render_samples_per_ray {tpu.render_samples_per_ray}: measured -3.2 dB "
            "at 8 (vs 16) — 16 render samples is the quality floor."
        )
    return out


def _parse_bool(v: str) -> bool:
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise argparse.ArgumentTypeError(f"Expected bool, got {v!r}")


def _unwrap_optional(tp):
    origin = typing.get_origin(tp)
    if origin is typing.Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0], True
    return tp, False


def _add_dataclass_args(parser: argparse.ArgumentParser, cls, prefix: str) -> None:
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        tp = hints[f.name]
        name = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(tp):
            _add_dataclass_args(parser, tp, prefix=f"{name}.")
            continue
        tp, _ = _unwrap_optional(tp)
        origin = typing.get_origin(tp)
        help_text = _TPU_KNOB_HELP.get(name)
        if origin in (tuple, list):
            elem = typing.get_args(tp)[0]
            parser.add_argument(f"--{name}", nargs="*", type=elem, default=argparse.SUPPRESS, help=help_text)
        elif tp is bool:
            parser.add_argument(f"--{name}", type=_parse_bool, default=argparse.SUPPRESS, help=help_text)
        elif tp in (int, float, str, Path):
            # int fields accept "50_001" style underscores like python literals.
            conv = (lambda s: int(s.replace("_", ""))) if tp is int else tp
            parser.add_argument(f"--{name}", type=conv, default=argparse.SUPPRESS, help=help_text)
        else:
            parser.add_argument(f"--{name}", type=str, default=argparse.SUPPRESS, help=help_text)


def _build_dataclass(cls, values: dict, prefix: str):
    kwargs = {}
    hints = typing.get_type_hints(cls)
    for f in dataclasses.fields(cls):
        tp = hints[f.name]
        name = f"{prefix}{f.name}"
        if dataclasses.is_dataclass(tp):
            kwargs[f.name] = _build_dataclass(tp, values, prefix=f"{name}.")
            continue
        if name in values:
            v = values[name]
            inner, _ = _unwrap_optional(tp)
            if typing.get_origin(inner) in (tuple, list):
                v = tuple(v)
            kwargs[f.name] = v
    return cls(**kwargs)


def parse_args(argv: Optional[list] = None) -> _run_args:
    """`--config NAME` prepends humanrf_torch.configs.NAME's `config` argv
    list (flags on the command line override its values)."""
    cli_args = list(sys.argv[1:] if argv is None else argv)

    if "--config" in cli_args:
        module_name = cli_args[cli_args.index("--config") + 1]
        module = importlib.import_module(f"humanrf_torch.configs.{module_name}")
        cli_args = list(module.config) + cli_args

    # allow_abbrev=False: prefix-matching would make e.g. --train ambiguous
    # with --training.*.
    parser = argparse.ArgumentParser(prog="humanrf_torch.run", allow_abbrev=False)
    _add_dataclass_args(parser, _run_args, prefix="")
    ns = parser.parse_args(cli_args)
    values = vars(ns)
    args = _build_dataclass(_run_args, values, prefix="")
    if "config" in values:
        args.config = values["config"]
    return args
