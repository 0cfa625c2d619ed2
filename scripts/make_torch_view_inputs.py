#!/usr/bin/env python3
"""Write the view inputs of the r4 model's Cam012 frame-0 test render.

The PyTorch port (`humanrf_torch`) renders `runs_evidence/r4_full_schedule_748/
best.ckpt` on a GPU machine that has neither JAX nor the scene's dataset, so
this script bakes what the render needs into one `.npz` beside the
checkpoint, using the JAX package's own code:

- the model and pipeline settings of the run (`config.yaml`, segment sizes
  from `result.json`);
- the `PoolArrays` entry and the dilated occupancy grid exactly as the JAX
  `DataLoader` builds them in TEST mode. TEST mode reads no images, so the
  dataset folder written here holds only calibration, AABBs and the frame's
  occupancy grid, made from the scene config of
  `scripts/full_schedule_run.py::make_scene` with `make_cameras`, the
  generator's AABB formula and `_occupancy_grid`;
- the normalized scene AABB and the image size;
- the banked JAX render `eval_Cam012_rgb000000.png`;
- the view's ground-truth rgb and mask from the JAX scene renderer.

Usage: python scripts/make_torch_view_inputs.py [--out PATH]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

RUN_DIR = REPO / "runs_evidence" / "r4_full_schedule_748"
OUT_PATH = RUN_DIR / "torch_view_inputs.npz"
SIZE, NUM_FRAMES = 748, 50
CAMERA_NAME, FRAME = "Cam012", 0

MODEL_KEYS = (
    "log2_hashmap_size", "n_features_per_level", "n_levels", "coarsest_resolution",
    "finest_resolution", "geometry_feature_dim", "n_neurons", "n_hidden_layers_density",
    "n_hidden_layers_color", "sh_degree", "density_scale", "camera_embedding_dim",
)
TPU_KEYS = (
    "proposal_rank", "proposal_resolution", "proposal_samples_per_ray", "render_samples_per_ray",
    "proposal_mid_samples_per_ray", "proposal_uniform_bonus", "march_grid_factor",
)


def scene_config():
    """The `SyntheticSceneConfig` that `make_scene` generates, captured
    without rendering the dataset."""
    import full_schedule_run
    import humanrf_tpu.core.synthetic as synthetic

    captured = []
    real = synthetic.generate_synthetic_dataset
    synthetic.generate_synthetic_dataset = lambda root, cfg: captured.append(cfg)
    try:
        full_schedule_run.make_scene(Path("unused"), NUM_FRAMES, SIZE, SIZE)
    finally:
        synthetic.generate_synthetic_dataset = real
    (cfg,) = captured
    return cfg


def write_test_mode_dataset(root: Path, cfg) -> Path:
    """Calibration, AABBs and frame FRAME's occupancy grid, laid out and
    computed as `generate_synthetic_dataset` does (synthetic.py:418-490)."""
    from humanrf_tpu.core.aabb import AabbData, write_aabbs_csv
    from humanrf_tpu.core.camera import write_calibration_csv
    from humanrf_tpu.core.synthetic import _occupancy_grid, _sphere_center, make_cameras

    seq_dir = root / "SynthActor" / "Sequence1"
    data_dir = seq_dir / "1x"
    data_dir.mkdir(parents=True)
    (seq_dir / "occupancy_grids").mkdir()
    write_calibration_csv(make_cameras(cfg), data_dir / "calibration.csv")

    frame_numbers = list(range(cfg.first_frame, cfg.first_frame + cfg.num_frames))
    actor_extent = cfg.sphere_radius + (cfg.rod_length + cfg.rod_radius if cfg.num_rods else 0.0)
    r = actor_extent + cfg.aabb_margin
    aabbs = []
    for fi, fn in enumerate(frame_numbers):
        center = _sphere_center(cfg, fi)
        aabbs.append(AabbData(frame_number=fn, aabb=np.stack([center - r, center + r], axis=0)))
    write_aabbs_csv(aabbs, seq_dir / "aabbs.csv")

    all_aabbs = np.stack([a.aabb for a in aabbs], axis=0)
    union = np.stack((all_aabbs[:, 0].min(0), all_aabbs[:, 1].max(0)), axis=0)
    scene_offset = -union.mean(0)
    scene_scale = 1.0 / np.max(union[1] - union[0])
    fi = frame_numbers.index(FRAME)
    center_scaled = (_sphere_center(cfg, fi) + scene_offset) * scene_scale
    grid = _occupancy_grid(cfg, center_scaled, scene_scale)
    np.savez_compressed(str(seq_dir / "occupancy_grids" / f"occupancy_grid{FRAME:06d}.npz"), occupancy_grid=grid)
    return data_dir


def view_geometry(cfg) -> dict:
    """Pool entry, dilated grid, AABB and size of the first image of the JAX
    TEST-mode loader, set up as `run.py` sets up its evaluation loader."""
    import humanrf_tpu.evaluation.presets as presets
    from humanrf_tpu.core.dataset import VolumetricDataset
    from humanrf_tpu.data.loader import DataLoader
    from humanrf_tpu.run import derive_synthetic_presets

    with tempfile.TemporaryDirectory() as tmp:
        data_dir = write_test_mode_dataset(Path(tmp), cfg)
        dataset = VolumetricDataset(data_dir)
        camera_configs = derive_synthetic_presets(dataset)
        frame_numbers = tuple(range(NUM_FRAMES))
        sequence = presets.get_render_sequence(
            coverage="siggraph_test",
            camera_preset="siggraph_test",
            frame_numbers=list(frame_numbers),
            camera_configs_override=camera_configs,
        )
        # The run renders the view somewhere in the sequence; with a one-entry
        # pool and one grid slot its entry is the same wherever it comes, so
        # start the sequence there.
        camera_number = [c.name for c in dataset.cameras].index(CAMERA_NAME)
        start = sequence.index((camera_number, FRAME))
        sequence = sequence[start:] + sequence[:start]
        loader = DataLoader(
            dataset=dataset,
            mode=DataLoader.Mode.TEST,
            space_pruning_mode=DataLoader.SpacePruningMode.OCCUPANCY_GRID,
            batch_size=16384,
            camera_numbers=camera_configs["siggraph_test"],
            frame_numbers=frame_numbers,
            max_buffer_size=1,
            render_sequence=sequence,
        )
        try:
            batch, pool, grids, info = next(iter(loader))
        finally:
            loader.shutdown()
    grids = np.asarray(grids)
    return {
        "inverse_krs": np.asarray(pool.inverse_krs),
        "camera_origins": np.asarray(pool.camera_origins),
        "landscape": np.asarray(pool.landscape),
        "frame_numbers": np.asarray(pool.frame_numbers),
        "camera_numbers": np.asarray(pool.camera_numbers),
        "grid_slots": np.asarray(pool.grid_slots),
        "buffer_index": np.int32(np.asarray(batch.buffer_idx)[0]),
        "grids_packed": np.packbits(grids.reshape(-1)),
        "grids_shape": np.asarray(grids.shape, dtype=np.int64),
        "aabb": np.asarray(loader.aabb, dtype=np.float32),
        "width": np.int32(info.width),
        "height": np.int32(info.height),
    }


def ground_truth(cfg) -> dict:
    """The view's rgb (uint8) and mask from the JAX scene renderer."""
    from humanrf_tpu.core.synthetic import _render_batch_jax, _sphere_center, make_cameras

    cam = next(c for c in make_cameras(cfg) if c.name == CAMERA_NAME)
    render = _render_batch_jax(cfg, cam.height, cam.width)
    center = _sphere_center(cfg, FRAME - cfg.first_frame).astype(np.float32)
    rgb, mask = render(
        cam.inverse_kr()[None].astype(np.float32), cam.translation[None].astype(np.float32), center, 0.5 * FRAME
    )
    return {"gt_rgb": np.asarray(rgb)[0], "gt_mask": np.asarray(mask)[0]}


def run_config() -> dict:
    import yaml

    config = yaml.safe_load((RUN_DIR / "config.yaml").read_text())
    segment_sizes = json.loads((RUN_DIR / "result.json").read_text())["segment_sizes"]
    return {
        "model": {k: config["model"][k] for k in MODEL_KEYS},
        "tpu": {k: config["tpu"][k] for k in TPU_KEYS},
        "rays_batch_size": config["test"]["rays_batch_size"],
        "segment_sizes": segment_sizes,
        "sorted_frame_numbers": sorted(config["dataset"]["frame_numbers"]),
        "camera_name": CAMERA_NAME,
        "frame_number": FRAME,
    }


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import cv2

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=OUT_PATH)
    args = ap.parse_args()

    cfg = scene_config()
    banked = cv2.imread(str(RUN_DIR / f"eval_{CAMERA_NAME}_rgb{FRAME:06d}.png"), cv2.IMREAD_COLOR)
    arrays = {
        "config_json": np.array(json.dumps(run_config())),
        **view_geometry(cfg),
        **ground_truth(cfg),
        "jax_render": cv2.cvtColor(banked, cv2.COLOR_BGR2RGB),
    }
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out} ({args.out.stat().st_size / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
