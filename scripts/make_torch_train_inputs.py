#!/usr/bin/env python3
"""Write the training inputs of the r4 model's scene for the PyTorch port.

The port (`humanrf_torch`) trains the flagship step on a GPU machine that has
neither JAX nor the scene's dataset, so this script bakes a small training
pool into one `.npz` beside the r4 checkpoint, using the JAX package's own
code:

- the pool: the r4 run's `siggraph_train` cameras (`derive_synthetic_presets`
  on the 12-camera rig: 8 cameras) at frames 0 and 25, one frame in each of
  the run's two segments;
- their `PoolArrays` entries and dilated occupancy grids exactly as the JAX
  `DataLoader` builds them: a TEST-mode loader over that (camera, frame)
  sequence whose pool holds all of it. TEST mode reads no images, so the
  dataset folder written here holds only calibration, AABBs and the two
  frames' occupancy grids, laid out and computed as
  `generate_synthetic_dataset` does;
- per pool entry, the image as the loader pools it: (rgb·mask, mask) in
  uint8, the JAX loader's float round trip included, from the JAX scene
  renderer `_render_batch_jax` (the dataset's JPEG step is skipped: the
  renderer's uint8 image is used as it is);
- the normalized scene AABB and the image size; the grids bit-packed.

Usage: python scripts/make_torch_train_inputs.py [--out PATH]
"""
from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import make_torch_view_inputs as mtvi  # noqa: E402

OUT_PATH = mtvi.RUN_DIR / "torch_train_inputs.npz"
FRAMES = (0, 25)


def write_test_mode_dataset(root: Path, cfg) -> Path:
    """Calibration, AABBs and the occupancy grids of FRAMES, as
    `generate_synthetic_dataset` writes them (synthetic.py:418-490)."""
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
    aabbs = [
        AabbData(frame_number=fn, aabb=np.stack([_sphere_center(cfg, fi) - r, _sphere_center(cfg, fi) + r], axis=0))
        for fi, fn in enumerate(frame_numbers)
    ]
    write_aabbs_csv(aabbs, seq_dir / "aabbs.csv")

    all_aabbs = np.stack([a.aabb for a in aabbs], axis=0)
    union = np.stack((all_aabbs[:, 0].min(0), all_aabbs[:, 1].max(0)), axis=0)
    scene_offset = -union.mean(0)
    scene_scale = 1.0 / np.max(union[1] - union[0])
    for frame in FRAMES:
        fi = frame_numbers.index(frame)
        center_scaled = (_sphere_center(cfg, fi) + scene_offset) * scene_scale
        grid = _occupancy_grid(cfg, center_scaled, scene_scale)
        np.savez_compressed(str(seq_dir / "occupancy_grids" / f"occupancy_grid{frame:06d}.npz"), occupancy_grid=grid)
    return data_dir


def pool_geometry(cfg) -> dict:
    """Pool entries, dilated grids, AABB and size of a TEST-mode loader over
    the train cameras at FRAMES, its pool holding every (camera, frame)."""
    from humanrf_tpu.core.dataset import VolumetricDataset
    from humanrf_tpu.data.loader import DataLoader
    from humanrf_tpu.run import derive_synthetic_presets

    with tempfile.TemporaryDirectory() as tmp:
        dataset = VolumetricDataset(write_test_mode_dataset(Path(tmp), cfg))
        train_cameras = derive_synthetic_presets(dataset)["siggraph_train"]
        sequence = [(c, f) for f in FRAMES for c in train_cameras]
        loader = DataLoader(
            dataset=dataset,
            mode=DataLoader.Mode.TEST,
            space_pruning_mode=DataLoader.SpacePruningMode.OCCUPANCY_GRID,
            batch_size=16384,
            camera_numbers=train_cameras,
            frame_numbers=FRAMES,
            max_buffer_size=len(sequence),
            render_sequence=sequence,
        )
        try:
            _, pool, grids, info = next(iter(loader))
        finally:
            loader.shutdown()
        camera_names = [dataset.cameras[c].name for c, _ in sequence]
    grids = np.asarray(grids)
    return {
        "inverse_krs": np.asarray(pool.inverse_krs),
        "camera_origins": np.asarray(pool.camera_origins),
        "landscape": np.asarray(pool.landscape),
        "frame_numbers": np.asarray(pool.frame_numbers),
        "camera_numbers": np.asarray(pool.camera_numbers),
        "grid_slots": np.asarray(pool.grid_slots),
        "camera_names": np.asarray(camera_names),
        "grids_packed": np.packbits(grids.reshape(-1)),
        "grids_shape": np.asarray(grids.shape, dtype=np.int64),
        "aabb": np.asarray(loader.aabb, dtype=np.float32),
        "width": np.int32(info.width),
        "height": np.int32(info.height),
    }


def pool_images(cfg, camera_names, frame_numbers) -> np.ndarray:
    """(B, H·W, 4) uint8: each pool entry's image as the JAX loader pools it,
    `(concat(rgb·mask, mask) · 255).astype(uint8)` on the [0, 1] images it
    reads (data/loader.py:451-457), here rendered by `_render_batch_jax`."""
    from humanrf_tpu.core.synthetic import _render_batch_jax, _sphere_center, make_cameras

    cameras = {c.name: c for c in make_cameras(cfg)}
    renderers = {}
    images = []
    for name, frame in zip(camera_names, frame_numbers):
        cam = cameras[str(name)]
        fi = int(frame) - cfg.first_frame
        hw = (cam.height, cam.width)
        if hw not in renderers:
            renderers[hw] = _render_batch_jax(cfg, *hw)
        rgb_u8, mask_u8 = renderers[hw](
            cam.inverse_kr()[None].astype(np.float32),
            cam.translation[None].astype(np.float32),
            _sphere_center(cfg, fi).astype(np.float32),
            0.5 * fi,
        )
        rgb = np.asarray(rgb_u8)[0] / np.float32(255)
        mask = (np.asarray(mask_u8)[0, ..., None] * 255) / np.float32(255)
        rgba = (np.concatenate((rgb * mask, mask), axis=-1) * np.float32(255)).astype(np.uint8)
        images.append(rgba.reshape(-1, 4))
    return np.stack(images)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", type=Path, default=OUT_PATH)
    args = ap.parse_args()

    cfg = mtvi.scene_config()
    geometry = pool_geometry(cfg)
    arrays = {**geometry, "pixel_rgba": pool_images(cfg, geometry["camera_names"], geometry["frame_numbers"])}
    np.savez_compressed(args.out, **arrays)
    print(f"wrote {args.out} ({args.out.stat().st_size / 1e6:.2f} MB)")


if __name__ == "__main__":
    main()
