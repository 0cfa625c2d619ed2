"""CLI entry point: the train, trajectory and evaluate phases on one GPU (or
the CPU), training on several with `--tpu.num_devices`.

Counterpart of `humanrf_tpu/run.py`, with the same flags: `configs/args.py`
and `configs/example_*.py` are the port's copies of the JAX package's, held
equal by `tests/test_torch_configs.py`, so the two CLIs take the same command
lines. The workspace has the JAX
package's layout: `config.yaml`, `derived_split.json`,
`checkpoints/step_%08d.ckpt` and `best.ckpt`, `validation.txt`,
`validation/*.png`, TensorBoard events under `run/`, the trajectory
phases' `results/test_keycams/%06d.png` and
`results/test_calibration_file/%06d.png` (with `results/video_*.mp4` where
ffmpeg exists), `results/test_frames/*.png`, `results/metrics.csv` and
`results/averages.csv`; `--tpu.profile_dir` adds a trace of steps 20–24.

`--device tpu` (the flag's default: the accelerator) and `--device cuda` run
on `cuda:0` and raise without a GPU; `--device cpu` runs on the CPU, where
the CUDA kernels' plain versions stand in.

`--tpu.num_devices N` (N > 1; 0 means every visible GPU, and 1 on the CPU)
trains on N ranks, one process each (`parallel/launch.py`): rank r on
`cuda:r` over NCCL, or N CPU ranks over gloo with `--device cpu`. Training
is data-parallel, with the segment tables sharded under
`--tpu.param_sharding fsdp` (`parallel/mesh.py`, `parallel/fsdp.py`); rank 0
alone loads the data and writes the workspace, which has the single-process
layout, and runs the trajectory and evaluate phases on its device after
training, as the JAX CLI runs them unsharded. Asking for more GPUs than are
visible raises before anything is written.

Usage:
    python -m humanrf_torch.run --config example_synthetic --dataset.path <synth_root> --workspace ws --device cuda
"""
from __future__ import annotations

import dataclasses
import functools
import json
import random
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import humanrf_torch.evaluation.presets as presets
from humanrf_torch.configs.args import parse_args, warn_pipeline_knobs
from humanrf_torch.core.dataset import VolumetricDataset
from humanrf_torch.data.loader import DataLoader
from humanrf_torch.data.trajectory import (
    get_trajectory_dataloader_from_calibration,
    get_trajectory_dataloader_from_keycams,
)
from humanrf_torch.evaluation.evaluate import evaluate
from humanrf_torch.models.humanrf import HumanRFConfig, HumanRFModel
from humanrf_torch.parallel.collectives import broadcast_object
from humanrf_torch.parallel.launch import launch
from humanrf_torch.train.partitioning import compute_adaptive_segment_sizes
from humanrf_torch.train.pipeline import PipelineConfig
from humanrf_torch.train.trainer import Trainer, make_optimizer


def resolve_device(name: str) -> torch.device:
    """'tpu' (the accelerator) and 'cuda' → cuda:0, raising without a GPU;
    'cpu' → the CPU."""
    if name == "cpu":
        return torch.device("cpu")
    if name in ("tpu", "cuda"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name} needs a CUDA GPU and none is available (use --device cpu)")
        return torch.device("cuda", 0)
    raise ValueError(f"unknown --device {name!r} (tpu, cuda or cpu)")


def resolve_num_devices(config) -> int:
    """--tpu.num_devices → the number of ranks: N, or for 0 every visible GPU
    (1 on --device cpu, or without a GPU, where the device check raises)."""
    if config.tpu.num_devices:
        return config.tpu.num_devices
    return 1 if config.device == "cpu" else max(torch.cuda.device_count(), 1)


def check_ported(config) -> None:
    """Print one line for the flags whose choice the port's single path
    makes moot. (Every flag of the JAX CLI is ported.)"""
    if config.tpu.field_backend != "gather":
        print(f"[INFO] --tpu.field_backend {config.tpu.field_backend}: the port has one field path, "
              "the gather contract through the field_interp kernels")
    if config.tpu.steps_per_dispatch != 1:
        print(f"[INFO] --tpu.steps_per_dispatch {config.tpu.steps_per_dispatch}: the port dispatches one "
              "step at a time (the K-step scan is a TPU workaround); the loop keeps K = 1's semantics")


def build_pipeline_config(config) -> PipelineConfig:
    candidate = config.tpu.candidate_budget or 2 * config.training.samples_max_batch_size
    return PipelineConfig(
        num_rays=config.training.rays_initial_batch_size,
        samples_per_ray=config.tpu.samples_per_ray,
        candidate_budget=candidate,
        sample_budget=config.training.samples_max_batch_size,
        use_visibility_prune=config.tpu.use_visibility_prune,
        sampling=config.tpu.sampling,
        bce_loss_weight=config.training.bce_loss_weight,
        march_grid_factor=config.tpu.march_grid_factor,
        proposal_samples_per_ray=config.tpu.proposal_samples_per_ray,
        render_samples_per_ray=config.tpu.render_samples_per_ray,
        proposal_mid_samples_per_ray=config.tpu.proposal_mid_samples_per_ray,
        proposal_loss_weight=config.tpu.proposal_loss_weight,
        proposal_uniform_bonus=config.tpu.proposal_uniform_bonus,
        candidate_rays_factor=config.tpu.candidate_rays_factor,
    )


def optimizer_factory(config):
    """The training optimizer the flags describe, as a function of the
    model's named parameters."""
    return functools.partial(
        make_optimizer, lr=config.training.lr, lr_decay=config.training.lr_decay,
        max_steps=config.training.max_steps, weight_decay=config.training.weight_decay,
    )


def build_model(config, segment_sizes, device) -> HumanRFModel:
    """The HumanRF model the flags describe, over `segment_sizes`."""
    return HumanRFModel(
        HumanRFConfig(
            sorted_frame_numbers=tuple(sorted(config.dataset.frame_numbers)),
            segment_sizes=tuple(segment_sizes),
            density_scale=config.model.density_scale,
            n_features_per_level=config.model.n_features_per_level,
            log2_hashmap_size=config.model.log2_hashmap_size,
            n_levels=config.model.n_levels,
            coarsest_resolution=config.model.coarsest_resolution,
            finest_resolution=config.model.finest_resolution,
            geometry_feature_dim=config.model.geometry_feature_dim,
            n_neurons=config.model.n_neurons,
            n_hidden_layers_density=config.model.n_hidden_layers_density,
            n_hidden_layers_color=config.model.n_hidden_layers_color,
            sh_degree=config.model.sh_degree,
            camera_embedding_dim=config.model.camera_embedding_dim,
            proposal_rank=config.tpu.proposal_rank if config.tpu.sampling == "proposal" else 0,
            proposal_resolution=config.tpu.proposal_resolution,
        ),
        device=device,
    )


def derive_synthetic_presets(dataset) -> dict:
    """Camera splits of a synthetic rig: the last camera is the test view;
    three validation cameras spread over the rest on rigs of ≥ 8 cameras,
    else one (camera n − 2). The JAX package's `derive_synthetic_presets`."""
    n = len(dataset.cameras)
    if n < 3:
        raise ValueError(f"synthetic presets need >= 3 cameras, the rig has {n}")
    if n < 8:
        val = (n - 2,)
        train = tuple(range(n - 2))
    else:
        val = tuple(sorted({int(round((i + 1) * (n - 1) / 4)) for i in range(3)}))
        train = tuple(c for c in range(n - 1) if c not in set(val))
    return {
        "siggraph_train": train,
        "siggraph_train_validation": val,
        "siggraph_test": (n - 1,),
        "siggraph_vmaf": (n - 1,),
    }


def compute_segment_sizes(config, data_folder: Path, frame_numbers):
    if config.model.temporal_partitioning == "none":
        return [len(frame_numbers)]
    if config.model.temporal_partitioning == "adaptive":
        return compute_adaptive_segment_sizes(
            dataset=VolumetricDataset(data_folder),
            sorted_frame_numbers=sorted(frame_numbers),
            expansion_factor_threshold=config.model.expansion_factor_threshold,
        )
    if config.model.temporal_partitioning == "fixed":
        fixed = config.model.fixed_segment_size
        return [fixed for _ in range(int(np.ceil(len(frame_numbers) / fixed)))]
    raise NotImplementedError("Unknown temporal partitioning type!")


# ------------------------------------------------------------ config.yaml


def _yaml_scalar(v) -> str:
    """A scalar as PyYAML's safe_load reads it back: strings double-quoted
    (JSON escapes are YAML escapes), floats with the '.' PyYAML's resolver
    needs."""
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if v != v:
            return ".nan"
        if v in (float("inf"), float("-inf")):
            return ".inf" if v > 0 else "-.inf"
        text = repr(v).lower()
        return text.replace("e", ".0e", 1) if "." not in text and "e" in text else text
    if isinstance(v, (str, Path)):
        return json.dumps(str(v))
    raise TypeError(f"config.yaml cannot hold a {type(v).__name__}")


def yaml_dump(tree: dict, indent: int = 0) -> str:
    """Block-style YAML of nested dicts of scalars and lists of scalars,
    keys in order (what `yaml.safe_dump(..., default_flow_style=False,
    sort_keys=False)` writes, up to quoting)."""
    pad = " " * indent
    lines = []
    for key, v in tree.items():
        if isinstance(v, dict):
            lines.append(f"{pad}{key}:" + ("\n" + yaml_dump(v, indent + 2) if v else " {}"))
        elif isinstance(v, (list, tuple)):
            lines.append(f"{pad}{key}:" + "".join(f"\n{pad}- {_yaml_scalar(x)}" for x in v) if v else f"{pad}{key}: []")
        else:
            lines.append(f"{pad}{key}: {_yaml_scalar(v)}")
    return "\n".join(lines)


# ------------------------------------------------------------------- main


def main(argv=None, allow_shared_device: bool = False) -> dict:
    """Run the phases the flags ask for → {"segment_sizes", "train": the
    train loop's throughput (`Trainer.run_stats`) or None, "averages": the
    evaluation's averages or None}, rank 0's in a multi-rank run.
    `allow_shared_device` puts every rank on `cuda:0` over gloo (the one-card
    harness; not a flag)."""
    config = parse_args(argv)
    for warning in warn_pipeline_knobs(config.tpu):
        print(f"[WARNING] quality cliff: {warning}")
    check_ported(config)
    num_ranks = resolve_num_devices(config)
    if num_ranks == 1:
        return run(None, resolve_device(config.device), config)
    device_type = resolve_device(config.device).type
    print(f"[INFO] training on {num_ranks} ranks ({device_type}"
          f"{', sharing cuda:0 over gloo' if allow_shared_device else ''}), "
          f"--tpu.param_sharding {config.tpu.param_sharding}")
    return launch(run, num_ranks, config, device_type=device_type, allow_shared_device=allow_shared_device)


def run(group, device: torch.device, config) -> dict:
    """`main`'s phases on `device`: alone with no `group`, else as one rank
    of a multi-rank run (`parallel/launch.py` calls it; see the module
    docstring)."""
    is_rank0 = group is None or dist.get_rank(group) == 0
    log = print if is_rank0 else (lambda *args: None)
    random.seed(config.random_seed)
    np.random.seed(config.random_seed)

    frame_numbers = tuple(config.dataset.frame_numbers)
    if not frame_numbers:
        raise ValueError("--dataset.frame_numbers is required")

    workspace = Path(config.workspace)
    if is_rank0:
        workspace.mkdir(parents=True, exist_ok=True)
        (workspace / "config.yaml").write_text(yaml_dump(dataclasses.asdict(config)) + "\n")

    data_folder = Path(config.dataset.path) / config.dataset.actor / config.dataset.sequence / f"{config.dataset.scale}x"
    segment_sizes = compute_segment_sizes(config, data_folder, frame_numbers)
    log(f"[INFO] segment sizes: {segment_sizes}")

    model = build_model(config, segment_sizes, device)
    pcfg = build_pipeline_config(config)

    camera_configs = presets.camera_configs
    if config.tpu.synthetic_presets:
        camera_configs = derive_synthetic_presets(VolumetricDataset(data_folder))
        split = {k: list(v) for k, v in camera_configs.items()}
        log(f"[INFO] derived synthetic camera split: {split}")
        # A workspace's checkpoints belong to the split they were trained
        # under: rank 0 writes the stamp when absent and never overwrites it.
        if is_rank0:
            split_path = workspace / "derived_split.json"
            have_ckpts = any((workspace / "checkpoints").glob("*.ckpt"))
            if split_path.exists():
                old = json.loads(split_path.read_text())
                if old != split:
                    print(
                        "[WARNING] this workspace's derived_split.json records a DIFFERENT camera split "
                        f"({old}); it is kept as it is"
                        + ("; validation/best-PSNR history is not comparable across the split change — use a "
                           "fresh workspace unless you know what you are doing" if have_ckpts else "")
                    )
            else:
                if have_ckpts:
                    print(
                        "[WARNING] resuming a workspace with no derived_split.json stamp "
                        "(pre-split-change checkpoints?); validation history may not be "
                        "comparable to the current camera split"
                    )
                split_path.write_text(json.dumps(split))

    result = {"segment_sizes": list(segment_sizes), "train": None, "averages": None}
    loader_args = dict(
        space_pruning_mode=DataLoader.SpacePruningMode.OCCUPANCY_GRID, frame_numbers=frame_numbers,
        seed=config.random_seed, device=device,
    )
    if config.train:
        # Rank 0 alone loads the data; the other ranks train on its batches
        # (`parallel/feed.py`) and write nothing.
        training_data_loader = validation_data_loader = resolution = None
        if is_rank0:
            training_data_loader = DataLoader(
                dataset=VolumetricDataset(data_folder, config.dataset.crop_center_square),
                mode=DataLoader.Mode.TRAINING,
                batch_size=config.training.rays_initial_batch_size * config.tpu.candidate_rays_factor,
                camera_numbers=camera_configs[config.training.camera_preset],
                max_buffer_size=config.dataset.max_buffer_size,
                max_num_frames_per_batch=config.dataset.max_num_frames_per_batch,
                use_mask=True,
                filter_light_bloom=config.dataset.filter_light_bloom,
                deterministic=config.dataset.deterministic_loader,
                **loader_args,
            )
            render_sequence_validation = presets.get_render_sequence(
                coverage=config.validation.coverage,
                camera_preset=config.validation.camera_preset,
                frame_numbers=list(frame_numbers),
                repeat_cameras=config.validation.repeat_cameras,
                camera_configs_override=camera_configs,
            )
            validation_data_loader = DataLoader(
                dataset=VolumetricDataset(data_folder, config.dataset.crop_center_square),
                mode=DataLoader.Mode.VALIDATION,
                batch_size=config.validation.rays_batch_size,
                camera_numbers=camera_configs[config.validation.camera_preset],
                max_buffer_size=1,
                use_mask=True,
                filter_light_bloom=config.dataset.filter_light_bloom,
                render_sequence=render_sequence_validation,
                **loader_args,
            )
            resolution = training_data_loader.resolution
        if group is not None:
            resolution = broadcast_object(resolution, group)
        trainer = Trainer(
            config=config,
            workspace=workspace,
            checkpoint=config.training.checkpoint,
            model=model,
            pipeline_config=pcfg,
            optimizer=optimizer_factory(config),
            resolution=resolution,
            seed=config.random_seed,
            group=group,
        )
        try:
            trainer.train(training_data_loader, validation_data_loader, max_steps=config.training.max_steps)
        finally:
            if is_rank0:
                training_data_loader.shutdown()
                validation_data_loader.shutdown()
        result["train"] = trainer.run_stats
        if group is not None:
            # Training may have sharded the model's tables; the later
            # phases load their checkpoint into a model of their own.
            model = build_model(config, segment_sizes, device)
    if not is_rank0:
        return result  # the later phases run in rank 0 alone

    results_folder = workspace / "results"
    trajectory_loaders = []
    if config.test.trajectory_via_keycams is not None:
        trajectory_loaders.append(("test_keycams", lambda: get_trajectory_dataloader_from_keycams(
            trajectory=config.test.trajectory_via_keycams, base_data_folder=data_folder,
            space_pruning_mode=DataLoader.SpacePruningMode.OCCUPANCY_GRID, batch_size=config.test.rays_batch_size,
            frame_numbers=frame_numbers, trajectory_num_cameras=config.test.trajectory_num_cameras, device=device)))
    if config.test.trajectory_via_calibration_file is not None:
        trajectory_loaders.append(("test_calibration_file", lambda: get_trajectory_dataloader_from_calibration(
            calibration_path=config.test.trajectory_via_calibration_file, base_data_folder=data_folder,
            space_pruning_mode=DataLoader.SpacePruningMode.OCCUPANCY_GRID, batch_size=config.test.rays_batch_size,
            frame_numbers=frame_numbers, device=device)))
    for name, make_loader in trajectory_loaders:
        loader = make_loader()
        trainer = Trainer(
            config=config,
            workspace=workspace,
            checkpoint=config.test.checkpoint,
            model=model,
            pipeline_config=pcfg,
            optimizer=None,
            resolution=loader.resolution,
            seed=config.random_seed,
        )
        try:
            trainer.test(loader, results_folder / name, render_video=True)
        finally:
            loader.shutdown()

    if config.evaluate:
        eval_frame_numbers = frame_numbers
        if config.evaluation.frame_numbers is not None:
            eval_frame_numbers = tuple(config.evaluation.frame_numbers)
        render_sequence_evaluation = presets.get_render_sequence(
            coverage=config.evaluation.coverage,
            camera_preset=config.evaluation.camera_preset,
            frame_numbers=list(eval_frame_numbers),
            camera_configs_override=camera_configs,
        )
        evaluation_data_loader = DataLoader(
            dataset=VolumetricDataset(data_folder, crop_center_square=False),
            mode=DataLoader.Mode.TEST,
            batch_size=config.test.rays_batch_size,
            camera_numbers=camera_configs[config.evaluation.camera_preset],
            max_buffer_size=1,
            render_sequence=render_sequence_evaluation,
            **dict(loader_args, frame_numbers=eval_frame_numbers),
        )
        trainer = Trainer(
            config=config,
            workspace=workspace,
            checkpoint=config.test.checkpoint,
            model=model,
            pipeline_config=pcfg,
            optimizer=None,
            resolution=evaluation_data_loader.resolution,
            seed=config.random_seed,
        )
        try:
            trainer.test(evaluation_data_loader, results_folder / "test_frames")
        finally:
            evaluation_data_loader.shutdown()
        result["averages"] = evaluate(
            results_directory=results_folder,
            output_directory=results_folder,
            coverage=config.evaluation.coverage,
            camera_preset=config.evaluation.camera_preset,
            frame_numbers=list(eval_frame_numbers),
            data_folder=data_folder,
            result_suffix=".png",
            camera_configs_override=camera_configs if config.tpu.synthetic_presets else None,
        )
    return result


if __name__ == "__main__":
    main()
