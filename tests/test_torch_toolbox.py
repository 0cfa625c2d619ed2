"""The port's toolbox (humanrf_torch/toolbox/) against the JAX package's, on
the CPU, with the same inputs:

- `_carve` voxel for voxel equal to the JAX `_carve` (its projection rounds
  as XLA's CPU `einsum` does), at several resolutions, thresholds and chunk
  sizes, its voxel grid (built in torch) the JAX tool's numpy one bit for
  bit; the mask dilation bit-equal to `cv2.dilate`;
- `generate_occupancy_grid_from_masks` writes the JAX tool's grid files and
  covers the analytic sphere as `tests/test_exporters.py` requires;
- `write_polymesh_abc` and `objs_to_abc`: byte-identical archives;
- COLMAP and NGP exports: identical text and JSON files, and NGP images of
  identical pixels (OpenCV's rounding of a float image: halves to even);
- `import_dfa` on a small DFA-layout capture made from a synthetic scene:
  identical calibration, AABBs, occupancy grids, JPEGs and masks (the DFA
  rig's camera count, image size and grid resolution cut for the CPU).
"""
import filecmp
import json
import shutil

import cv2
import numpy as np
import pytest
import torch

import humanrf_torch.toolbox.import_dfa as t_dfa
import humanrf_tpu.toolbox.import_dfa as j_dfa
from humanrf_torch.core import image_io, morphology
from humanrf_torch.core.dataset import VolumetricDataset as TDataset
from humanrf_torch.toolbox import export_colmap as t_colmap
from humanrf_torch.toolbox import export_ngp as t_ngp
from humanrf_torch.toolbox import generate_occupancy_grids_from_masks as t_occ
from humanrf_torch.toolbox import write_alembic as t_abc
from humanrf_tpu.core.dataset import VolumetricDataset as JDataset
from humanrf_tpu.core.synthetic import SyntheticSceneConfig, generate_synthetic_dataset
from humanrf_tpu.toolbox import export_colmap as j_colmap
from humanrf_tpu.toolbox import export_ngp as j_ngp
from humanrf_tpu.toolbox import generate_occupancy_grids_from_masks as j_occ
from humanrf_tpu.toolbox import write_alembic as j_abc

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("toolbox")
    cfg = SyntheticSceneConfig(num_cameras=8, width=48, height=40, num_frames=2, grid_resolution=32,
                               center_start=(0.0, 0.0, -0.1), center_end=(0.0, 0.0, 0.1))
    return generate_synthetic_dataset(root, cfg), cfg


def _carve_inputs(data_dir, dilation):
    ds = JDataset(data_dir)
    offset, scale = ds.get_scene_normalization()
    cams = ds.get_scaled_cameras(offset, scale)
    side = max(max(c.width, c.height) for c in cams)
    masks = np.zeros((len(cams), side * side), np.uint8)
    for i in range(len(cams)):
        mask = cv2.dilate(ds.get_mask(i, 0, normalize=False).astype(np.uint8), np.ones((dilation, dilation), np.uint8))
        masks[i, : mask.size] = mask.reshape(-1)
    projections = np.stack([c.projection_matrix_world2pixel() for c in cams]).astype(np.float32)
    widths = np.asarray([c.width for c in cams], np.int32)
    heights = np.asarray([c.height for c in cams], np.int32)
    return masks, projections, widths, heights


@pytest.mark.parametrize("res, threshold, dilation, chunk", [(32, 8, 1, 262144), (64, 5, 3, 10_000), (96, 8, 2, 262144)])
def test_carve_is_voxel_equal_to_jax(scene, res, threshold, dilation, chunk):
    masks, projections, widths, heights = _carve_inputs(scene[0], dilation)
    j_grid = j_occ._carve(masks, projections, None, widths, heights, threshold, res)
    t_grid = t_occ._carve(masks, projections, widths, heights, threshold, res, device="cpu", chunk=chunk)
    assert t_grid.dtype == np.uint8 and t_grid.shape == (res**3,)
    assert 0 < (t_grid > 0).sum() < res**3
    np.testing.assert_array_equal(t_grid, j_grid)


@pytest.mark.parametrize("res", [2, 3, 100, 256])
def test_voxel_centers_are_the_jax_tools(res):
    """The JAX `_carve` builds them in numpy (fp64, then float32)."""
    coords = np.arange(res) / (res - 1) - 0.5
    gz, gy, gx = np.meshgrid(coords, coords, coords, indexing="ij")
    expected = np.stack([gx, gy, gz, np.ones_like(gx)], axis=-1).reshape(-1, 4).astype(np.float32)
    np.testing.assert_array_equal(t_occ.voxel_centers(res).numpy(), expected)


@pytest.mark.parametrize("k", [1, 2, 3, 5, 32])
def test_mask_dilation_is_bit_equal_to_cv2(scene, k):
    mask = JDataset(scene[0]).get_mask(3, 1, normalize=False).astype(np.uint8)
    expected = cv2.dilate(mask, np.ones((k, k), np.uint8))
    np.testing.assert_array_equal(morphology.dilate(TDataset(scene[0]).get_mask(3, 1, normalize=False), k), expected)


def _copy_scene(data_dir, dst):
    shutil.copytree(data_dir.parent, dst)
    return dst / data_dir.name


def test_occupancy_generation_writes_the_jax_grids_and_covers_the_sphere(scene, tmp_path):
    data_dir, cfg = scene
    j_dir, t_dir = _copy_scene(data_dir, tmp_path / "jax"), _copy_scene(data_dir, tmp_path / "torch")
    original = TDataset(data_dir).get_occupancy_grid(0)
    j_occ.generate_occupancy_grid_from_masks(j_dir, grid_resolution=cfg.grid_resolution,
                                             camera_coverage_threshold=cfg.num_cameras)
    t_occ.main(["--data_folder", str(t_dir), "--grid_resolution", str(cfg.grid_resolution),
                "--camera_coverage_threshold", str(cfg.num_cameras), "--device", "cpu"])
    for frame in range(cfg.num_frames):
        j_grid, t_grid = JDataset(j_dir).get_occupancy_grid(frame), TDataset(t_dir).get_occupancy_grid(frame)
        assert t_grid.shape == j_grid.shape == original.shape and t_grid.dtype == np.uint8
        np.testing.assert_array_equal(t_grid, j_grid)

    # tests/test_exporters.py::test_occupancy_generation_matches_synthetic.
    sphere, hull = original > 0, TDataset(t_dir).get_occupancy_grid(0) > 0
    core = sphere & np.roll(sphere, 2, 0) & np.roll(sphere, -2, 0) & np.roll(sphere, 2, 2) & np.roll(sphere, -2, 2)
    assert (hull & core).sum() / max(core.sum(), 1) > 0.95
    assert hull.mean() < 4 * sphere.mean() + 0.02


def _mesh_frames(seed):
    rng = np.random.default_rng(seed)
    frames = []
    for n in (4, 9, 6):
        counts = rng.integers(3, 5, size=n).astype(np.int32)
        frames.append((rng.standard_normal((12, 3)).astype(np.float32), counts,
                       rng.integers(0, 12, size=int(counts.sum())).astype(np.int32)))
    return frames


@pytest.mark.parametrize("seed", [0, 1])
def test_alembic_archives_are_byte_identical(tmp_path, seed):
    frames = _mesh_frames(seed)
    j = j_abc.write_polymesh_abc(tmp_path / "jax.abc", frames, mesh_name="person", frames_per_second=25.0)
    t = t_abc.write_polymesh_abc(tmp_path / "torch.abc", frames, mesh_name="person", frames_per_second=25.0)
    assert t.read_bytes() == j.read_bytes()

    objs = []
    for i, (verts, counts, idx) in enumerate(frames):
        faces, pos = [], 0
        for c in counts:
            faces.append("f " + " ".join(str(v + 1) for v in idx[pos : pos + c]))
            pos += c
        obj = tmp_path / f"frame{i}.obj"
        obj.write_text("\n".join([*(f"v {x} {y} {z}" for x, y, z in verts), *faces]) + "\n")
        objs.append(obj)
    assert (t_abc.objs_to_abc(objs, tmp_path / "t_objs.abc").read_bytes()
            == j_abc.objs_to_abc(objs, tmp_path / "j_objs.abc").read_bytes())


def test_colmap_export_is_identical(scene, tmp_path):
    csv = scene[0] / "calibration.csv"
    (tmp_path / "jax").mkdir()
    j_colmap.main(["--csv", str(csv), "--output_dir", str(tmp_path / "jax")])
    t_colmap.main(["--csv", str(csv), "--output_dir", str(tmp_path / "torch")])
    names = ["cameras.txt", "images.txt", "points3D.txt"]
    assert sorted(p.name for p in (tmp_path / "torch").iterdir()) == names
    assert filecmp.cmpfiles(tmp_path / "jax", tmp_path / "torch", names, shallow=False)[0] == names


def test_ngp_export_is_identical(scene, tmp_path):
    data_dir, cfg = scene
    for module, name in ((j_ngp, "jax"), (t_ngp, "torch")):
        module.main(["--data_folder", str(data_dir), "--frame_number", "1", "--output_dir", str(tmp_path / name)])
    transforms = sorted(p.name for p in (tmp_path / "torch").glob("transforms*.json"))
    assert len(transforms) == cfg.num_cameras
    for name in transforms:
        j_doc = json.loads((tmp_path / "jax" / name).read_text())
        t_doc = json.loads((tmp_path / "torch" / name).read_text())
        assert t_doc == j_doc
    images = sorted(p.name for p in (tmp_path / "jax" / "images").iterdir())
    assert sorted(p.name for p in (tmp_path / "torch" / "images").iterdir()) == images
    for name in images:
        j_img = cv2.imread(str(tmp_path / "jax" / "images" / name), cv2.IMREAD_UNCHANGED)
        t_img = image_io.decode_png((tmp_path / "torch" / "images" / name).read_bytes())
        assert t_img.shape == (cfg.height, cfg.width, 4)
        np.testing.assert_array_equal(t_img[..., [2, 1, 0, 3]], j_img)


def test_ngp_rounding_is_opencvs():
    values = np.array([[[-3.0, 0.5, 1.5, 2.5], [254.5, 255.49, 300.0, 127.5]]], np.float32)
    np.testing.assert_array_equal(t_ngp.to_u8(values), [[[0, 0, 2, 2], [254, 255, 255, 128]]])


# ------------------------------------------------------------------ import_dfa

DFA_CUT = {"NUM_DFA_CAMERAS": 6, "DFA_WIDTH": 64, "DFA_HEIGHT": 48, "GRID_RESOLUTION": 32}


def _dfa_capture(root, scene_dir):
    """A DFA-layout capture of a synthetic scene: img/<motion>/<frame>/
    img_%04d.png with their _alpha mattes, Intrinsic.inf and CamPose.inf."""
    ds = JDataset(scene_dir)
    motion = root / "img" / "dance"
    intrinsics, poses = [], []
    for cam_idx, cam in enumerate(ds.cameras):
        for frame in (0, 1):
            frame_dir = motion / f"{frame:03d}"
            frame_dir.mkdir(parents=True, exist_ok=True)
            cv2.imwrite(str(frame_dir / f"img_{cam_idx:04d}.png"), ds.get_rgb(cam_idx, frame, normalize=False))
            cv2.imwrite(str(frame_dir / f"img_{cam_idx:04d}_alpha.png"), ds.get_mask(cam_idx, frame, normalize=False))
        intrinsics += [str(cam_idx), f"{cam.fx_pixel} 0 {cam.cx_pixel}", f"0 {cam.fy_pixel} {cam.cy_pixel}", "0 0 1", ""]
        r = cam.rotation_matrix_cam2world()
        poses.append(" ".join(str(v) for v in [*r[:, 2], *r[:, 0], *r[:, 1], *cam.translation]))
    (root / "Intrinsic.inf").write_text("\n".join(intrinsics) + "\n")
    (root / "CamPose.inf").write_text("\n".join(poses) + "\n")


def test_import_dfa_writes_the_jax_dataset(tmp_path, monkeypatch):
    scene_dir = generate_synthetic_dataset(tmp_path / "scene", SyntheticSceneConfig(
        num_cameras=6, width=64, height=48, num_frames=2, grid_resolution=16))
    _dfa_capture(tmp_path / "dfa", scene_dir)
    for module in (j_dfa, t_dfa):
        for name, value in DFA_CUT.items():
            monkeypatch.setattr(module, name, value)
    j_dfa.main(["--dfa_dataset_folder", str(tmp_path / "dfa"), "--motion_type", "dance",
                "--output_folder", str(tmp_path / "jax" / "A" / "S" / "1x")])
    t_dfa.main(["--dfa_dataset_folder", str(tmp_path / "dfa"), "--motion_type", "dance",
                "--output_folder", str(tmp_path / "torch" / "A" / "S" / "1x"), "--device", "cpu"])
    j_files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*") if p.is_file())
    t_files = sorted(p.relative_to(tmp_path / "torch") for p in (tmp_path / "torch").rglob("*") if p.is_file())
    assert t_files == j_files and len(j_files) == 1 + 1 + 2 + 2 * 2 * 6  # calibration, aabbs, grids, views
    for rel in j_files:
        if rel.suffix == ".npz":
            j_grid = np.load(tmp_path / "jax" / rel)["occupancy_grid"]
            np.testing.assert_array_equal(np.load(tmp_path / "torch" / rel)["occupancy_grid"], j_grid)
            assert 0 < (j_grid > 0).mean() < 1
        else:
            assert (tmp_path / "torch" / rel).read_bytes() == (tmp_path / "jax" / rel).read_bytes(), rel
