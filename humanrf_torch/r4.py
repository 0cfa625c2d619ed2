"""The r4 configuration: the JAX package's measured synthetic scene and its
flagship training command, for the port's CLI.

The scene is `scripts/full_schedule_run.py::make_scene` at 748²: 12 cameras,
50 frames, a 0.3 sphere drifting from z = −0.08 to 0.08 (adaptive temporal
partitioning then gives segments [25, 25]), a 128³ occupancy grid, texture
frequency 30 and 12 rods of radius 0.015 and length 0.25. The flags are that
script's `humanrf_tpu.run` command: L8/F4 grids with log2 hashmap 13 (T =
2048 per 25-frame segment), finest resolution 2048, camera embedding 2,
proposal sampling Kc = 32, Kf = 16 with 2× candidate rays, 8,192 rays per
step, 16,384-ray validation batches, a 48-image pool of ≤ 8 frames.

    python -m humanrf_torch.r4 --root <dir> --steps 2500 --every 2500 [--device cuda] [-- <more CLI flags>]

writes the scene under <dir>/scene (unless it is there), then trains and
validates into <dir>/workspace; flags after `--` go to the CLI after the r4
ones, so they override them (`PAPER_DENSE_FLAGS` gives the paper's field and
dense sampler).
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import List

from humanrf_torch.core.synthetic import SyntheticSceneConfig

NUM_FRAMES = 50

R4_SCENE = SyntheticSceneConfig(
    num_cameras=12,
    width=748,
    height=748,
    num_frames=NUM_FRAMES,
    sphere_radius=0.3,
    center_start=(0.0, 0.0, -0.08),
    center_end=(0.0, 0.0, 0.08),
    grid_resolution=128,
    texture_frequency=30.0,
    num_rods=12,
    rod_radius=0.015,
    rod_length=0.25,
)


# The r4 model and sampler: what a command that loads an r4 checkpoint must
# give to build the same model.
R4_MODEL_FLAGS = [
    "--model.log2_hashmap_size", "13",
    "--model.n_levels", "8",
    "--model.n_features_per_level", "4",
    "--model.finest_resolution", "2048",
    "--model.temporal_partitioning", "adaptive",
    "--model.camera_embedding_dim", "2",
    "--tpu.field_backend", "fused",
    "--tpu.sampling", "proposal",
    "--tpu.proposal_samples_per_ray", "32",
    "--tpu.render_samples_per_ray", "16",
    "--tpu.candidate_rays_factor", "2",
]


def r4_flags(scene_root: Path, workspace: Path, steps: int, every: int, device: str = "cuda") -> List[str]:
    """The r4 command's flags, training `steps` steps with validation and
    rolling saves every `every` steps."""
    return [
        "--config", "example_synthetic",
        "--dataset.path", str(scene_root),
        "--workspace", str(workspace),
        "--device", device,
        *R4_MODEL_FLAGS,
        "--training.max_steps", str(steps),
        "--training.rays_initial_batch_size", "8192",
        "--training.save_checkpoint_every_n_steps", str(every),
        "--validation.every_n_steps", str(every),
        "--validation.rays_batch_size", "16384",
        "--validation.repeat_cameras", "1",
        "--dataset.frame_numbers", *[str(i) for i in range(NUM_FRAMES)],
        "--dataset.max_buffer_size", "48",
        "--dataset.max_num_frames_per_batch", "8",
    ]


# The paper's field and sampler (`configs/example_humanrf.py`), given after
# `r4_flags` to override its own: L16/F2 grids with log2 hashmap 19 (T = 2^17
# per 25-frame segment), coarsest 32, finest 2048, dense sampling with 1,024
# lattice points per ray and 640,000 samples per step, one candidate pixel
# per ray slot.
PAPER_DENSE_FLAGS = [
    "--model.log2_hashmap_size", "19",
    "--model.n_levels", "16",
    "--model.n_features_per_level", "2",
    "--model.coarsest_resolution", "32",
    "--model.finest_resolution", "2048",
    "--tpu.sampling", "dense",
    "--tpu.samples_per_ray", "1024",
    "--training.samples_max_batch_size", "640000",
    "--tpu.candidate_rays_factor", "1",
]


def write_scene(root: Path, device) -> float:
    """Write the r4 scene under `root`, rendering on `device` → seconds."""
    from humanrf_torch.core.synthetic import generate_synthetic_dataset

    t0 = time.perf_counter()
    generate_synthetic_dataset(root, R4_SCENE, device=device)
    return time.perf_counter() - t0


def main() -> None:
    from humanrf_torch.run import main as run_main, resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, required=True)
    ap.add_argument("--steps", type=int, default=2500)
    ap.add_argument("--every", type=int, default=2500)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("extra", nargs=argparse.REMAINDER, help="-- then flags for humanrf_torch.run")
    args = ap.parse_args()
    extra = args.extra[1:] if args.extra[:1] == ["--"] else args.extra
    scene = args.root / "scene"
    if not (scene / "SynthActor" / "Sequence1" / "scene.json").exists():
        print(f"[INFO] r4 scene written in {write_scene(scene, resolve_device(args.device)):.1f} s", flush=True)
    t0 = time.perf_counter()
    result = run_main(r4_flags(scene, args.root / "workspace", args.steps, args.every, args.device) + extra)
    print(f"[INFO] r4 run: {time.perf_counter() - t0:.1f} s wall; {result}", flush=True)


if __name__ == "__main__":
    main()
