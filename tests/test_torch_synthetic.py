"""The port's synthetic scene generator (humanrf_torch/core/synthetic.py)
against the JAX package's: the analytic renderer, the occupancy carver and
the files the generator writes.

Both renderers trace the same float32 rays in another operation order
(XLA's fused dot products against torch's explicit sums), so a ray that
grazes a silhouette can hit on one side and miss on the other. The bound is
therefore: rgb within 1 level and masks equal everywhere except at most 0.1%
of the pixels, and every such pixel on a silhouette edge (a pixel whose
4-neighbourhood holds both hit and miss in the JAX mask)."""
import json

import numpy as np
import pytest
import torch
from scipy.ndimage import binary_dilation, binary_erosion

from humanrf_torch.core import synthetic as t_synthetic
from humanrf_tpu.core import synthetic as j_synthetic

torch.set_num_threads(2)

# A 64×48 rig with the r4 scene's detail: texture frequency 30 and 12 rods,
# one portrait camera, a drifting centre.
_CFG = dict(num_cameras=5, width=64, height=48, num_frames=3, sphere_radius=0.3, center_start=(0.0, 0.0, -0.08),
            center_end=(0.0, 0.0, 0.08), grid_resolution=48, texture_frequency=30.0, num_rods=12, rod_radius=0.015,
            rod_length=0.25, portrait_camera_indices=(3,))


def _edges(mask: np.ndarray) -> np.ndarray:
    """Pixels of a (C, H, W) mask whose 4-neighbourhood holds both values."""
    cross = np.zeros((1, 3, 3), bool)
    cross[0, 1, :] = cross[0, :, 1] = True
    m = mask.astype(bool)
    return binary_dilation(m, cross) & ~binary_erosion(m, cross, border_value=1)


@pytest.mark.parametrize("frame", [0, 2])
def test_renderer_matches_jax(frame):
    jcfg, tcfg = j_synthetic.SyntheticSceneConfig(**_CFG), t_synthetic.SyntheticSceneConfig(**_CFG)
    cams = [c for c in j_synthetic.make_cameras(jcfg) if c.width == 64]
    inv = np.stack([c.inverse_kr() for c in cams]).astype(np.float32)
    org = np.stack([c.translation for c in cams]).astype(np.float32)
    center = j_synthetic._sphere_center(jcfg, frame).astype(np.float32)
    j_rgb, j_mask = (np.asarray(a) for a in j_synthetic._render_batch_jax(jcfg, 48, 64)(inv, org, center, 0.5 * frame))
    t_rgb, t_mask = (a.numpy() for a in t_synthetic.render_cameras(
        tcfg, torch.tensor(inv), torch.tensor(org), torch.tensor(center), 0.5 * frame, 48, 64))
    assert t_rgb.dtype == np.uint8 and t_rgb.shape == j_rgb.shape and t_mask.shape == j_mask.shape
    assert 0.02 < j_mask.mean() < 0.5  # the actor is in view

    off = (np.abs(t_rgb.astype(int) - j_rgb).max(-1) > 1) | (t_mask != j_mask)
    assert off.mean() <= 1e-3, off.sum()
    assert not (off & ~_edges(j_mask)).any()


def test_occupancy_grid_equals_jax():
    cfg = j_synthetic.SyntheticSceneConfig(**_CFG)
    scale = 1.0 / 1.4
    for center in (np.array([0.0, 0.0, -0.05]), np.array([0.02, -0.01, 0.06])):
        j_grid = j_synthetic._occupancy_grid(cfg, center, scale)
        t_grid = t_synthetic.occupancy_grid(t_synthetic.SyntheticSceneConfig(**_CFG), center, scale, "cpu")
        assert t_grid.dtype == np.uint8 and set(np.unique(t_grid)) == {0, 255}
        np.testing.assert_array_equal(t_grid, j_grid)


def test_generator_writes_the_jax_files(tmp_path):
    """Text files equal to the byte; grids equal; masks within the edge bound
    above."""
    from humanrf_torch.core import image_io

    j_dir = j_synthetic.generate_synthetic_dataset(tmp_path / "jax", j_synthetic.SyntheticSceneConfig(**_CFG))
    t_dir = t_synthetic.generate_synthetic_dataset(tmp_path / "torch", t_synthetic.SyntheticSceneConfig(**_CFG))
    j_files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*") if p.is_file())
    t_files = sorted(p.relative_to(tmp_path / "torch") for p in (tmp_path / "torch").rglob("*") if p.is_file())
    assert j_files == t_files and len(j_files) == 2 + 2 * 5 * 3 + 2 + 3  # 1x csvs, images, sequence files, grids

    for rel in ("1x/calibration.csv", "1x/light_annotations.csv", "aabbs.csv", "scene.json"):
        assert (t_dir.parent / rel).read_text() == (j_dir.parent / rel).read_text(), rel
    assert json.loads((t_dir.parent / "scene.json").read_text())["num_frames"] == 3
    for fn in range(3):
        name = f"occupancy_grids/occupancy_grid{fn:06d}.npz"
        np.testing.assert_array_equal(np.load(t_dir.parent / name)["occupancy_grid"],
                                      np.load(j_dir.parent / name)["occupancy_grid"])
    masks = np.stack([image_io.imread(p)[..., 0] for p in sorted(t_dir.rglob("*_mask*.png"))
                      if image_io.imread(p).shape[:2] == (48, 64)])
    j_masks = np.stack([image_io.imread(p)[..., 0] for p in sorted(j_dir.rglob("*_mask*.png"))
                        if image_io.imread(p).shape[:2] == (48, 64)])
    off = masks != j_masks
    assert off.mean() <= 1e-3 and not (off & ~_edges(j_masks > 0)).any()
