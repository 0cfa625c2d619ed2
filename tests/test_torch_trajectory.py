"""The port's trajectory loaders (humanrf_torch/data/trajectory.py) and the
CLI's trajectory phases against the JAX package's, on a scene of its own
(`get_trajectory_dataloader_from_calibration` re-creates `<sequence>/test`
beside the data).

- `generate_camera_trajectory`: every camera within 1e-6 of the JAX one;
- `_ping_pong_sequence`: equal;
- the keycam and calibration loaders: the same (camera, frame) sequence,
  batches and pool as the JAX loaders', the same valid rays, and their
  origins, directions and [tmin, tmax] within 1e-6 relative (the two
  frameworks round the AABB and occupancy march's fp32 sums in their own
  order: a few ulps at distances ~4);
- the CLI writes `results/test_keycams` and `results/test_calibration_file`
  as %06d.png frames and, without ffmpeg, warns once per phase.
"""
import shutil

import numpy as np
import pytest
import torch

import humanrf_torch.train.pipeline as t_pipeline
import humanrf_tpu.train.pipeline as j_pipeline
from humanrf_torch.core.camera import read_calibration_csv as t_read_calibration
from humanrf_torch.data import trajectory as t_traj
from humanrf_torch.data.loader import DataLoader as TLoader
from humanrf_torch.run import main as t_main
from humanrf_tpu.core.camera import read_calibration_csv as j_read_calibration
from humanrf_tpu.core.synthetic import SyntheticSceneConfig, generate_synthetic_dataset
from humanrf_tpu.data import trajectory as j_traj
from humanrf_tpu.data.loader import DataLoader as JLoader

torch.set_num_threads(2)

FRAMES = (0, 1)
RAY_RTOL = 1e-6


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("trajectory")
    cfg = SyntheticSceneConfig(num_cameras=6, width=40, height=40, num_frames=2, grid_resolution=32)
    return root, generate_synthetic_dataset(root, cfg)


def _camera_arrays(cam):
    return [cam.rotation_axisangle, cam.translation, cam.focal_length, cam.principal_point]


@pytest.mark.parametrize("keys, num_frames", [((0, 2, 4), 20), ((1, 3), 7), ((5, 0, 2, 3), 120)])
def test_generate_camera_trajectory_matches_jax(scene, keys, num_frames):
    _, data_dir = scene
    j_cams, t_cams = j_read_calibration(data_dir / "calibration.csv"), t_read_calibration(data_dir / "calibration.csv")
    j_out = j_traj.generate_camera_trajectory([j_cams[i] for i in keys], j_cams[keys[1]], num_frames)
    t_out = t_traj.generate_camera_trajectory([t_cams[i] for i in keys], t_cams[keys[1]], num_frames)
    assert len(t_out) == len(j_out) == num_frames
    for j, t in zip(j_out, t_out):
        assert (t.name, t.width, t.height) == (j.name, j.width, j.height)
        for a, b in zip(_camera_arrays(t), _camera_arrays(j)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("num_cameras, frames", [(5, (10, 11, 12)), (3, (0, 1, 2, 3, 4)), (4, tuple(range(50))),
                                                 (1, (7,)), (6, (3, 9))])
def test_ping_pong_sequence_matches_jax(num_cameras, frames):
    assert t_traj._ping_pong_sequence(num_cameras, frames) == j_traj._ping_pong_sequence(num_cameras, frames)


def _drain(loader):
    batches = list(loader)
    loader.shutdown()
    return batches


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same_views(j_loader, j_batches, t_loader, t_batches):
    assert t_loader.render_sequence == j_loader.render_sequence
    assert len(t_batches) == len(j_batches) > 0
    j_cfg, t_cfg = j_pipeline.PipelineConfig(), t_pipeline.PipelineConfig()
    width, height = t_loader.resolution
    assert (width, height) == j_loader.resolution
    for (jb, jp, jg, ji), (tb, tp, tg, ti) in zip(j_batches, t_batches):
        assert (ti.camera_number, ti.frame_number, ti.num_real) == (ji.camera_number, ji.frame_number, ji.num_real)
        for name in jb._fields:
            np.testing.assert_array_equal(_np(getattr(tb, name)), _np(getattr(jb, name)), err_msg=name)
        for name in jp._fields:
            np.testing.assert_array_equal(_np(getattr(tp, name)), _np(getattr(jp, name)), err_msg=name)
        np.testing.assert_array_equal(_np(tg), _np(jg))
        j_rays = j_pipeline.build_rays(j_cfg, jb, jp, jg, np.asarray(j_loader.aabb), width, height)
        t_rays = t_pipeline.build_rays(t_cfg, tb, tp, tg, t_loader.device_aabb, width, height)
        valid = _np(j_rays.valid)
        np.testing.assert_array_equal(_np(t_rays.valid), valid)
        for name in ("origins", "directions", "tmin", "tmax"):
            t_val, j_val = _np(getattr(t_rays, name)), _np(getattr(j_rays, name))
            np.testing.assert_allclose(t_val[valid], j_val[valid], rtol=RAY_RTOL, atol=1e-6, err_msg=name)


def test_keycam_loader_matches_jax(scene):
    _, data_dir = scene
    common = dict(trajectory=(0, 2, 4), base_data_folder=data_dir, batch_size=512, frame_numbers=FRAMES,
                  trajectory_num_cameras=6)
    j_loader = j_traj.get_trajectory_dataloader_from_keycams(
        dataloader_output_mode=JLoader.OutputMode.RAYS_AND_SAMPLES,
        space_pruning_mode=JLoader.SpacePruningMode.OCCUPANCY_GRID, **common)
    j_batches = _drain(j_loader)
    t_loader = t_traj.get_trajectory_dataloader_from_keycams(
        space_pruning_mode=TLoader.SpacePruningMode.OCCUPANCY_GRID, **common)
    assert t_loader.mode == TLoader.Mode.TEST and t_loader.num_camera_frame_pairs == 6
    _assert_same_views(j_loader, j_batches, t_loader, _drain(t_loader))


def test_single_keycam_loader_renders_that_camera_at_every_frame(scene):
    _, data_dir = scene
    common = dict(trajectory=(3,), base_data_folder=data_dir, batch_size=800, frame_numbers=FRAMES,
                  trajectory_num_cameras=6)
    j_loader = j_traj.get_trajectory_dataloader_from_keycams(
        dataloader_output_mode=JLoader.OutputMode.RAYS_AND_SAMPLES,
        space_pruning_mode=JLoader.SpacePruningMode.OCCUPANCY_GRID, **common)
    j_batches = _drain(j_loader)
    t_loader = t_traj.get_trajectory_dataloader_from_keycams(
        space_pruning_mode=TLoader.SpacePruningMode.OCCUPANCY_GRID, **common)
    assert t_loader.render_sequence == [(3, 0), (3, 1)]
    _assert_same_views(j_loader, j_batches, t_loader, _drain(t_loader))


def test_calibration_loader_matches_jax_and_recreates_the_test_folder(scene, tmp_path):
    root, data_dir = scene
    calibration = tmp_path / "four.csv"
    lines = (data_dir / "calibration.csv").read_text().splitlines()
    calibration.write_text("\n".join([lines[0], lines[2], lines[5], lines[1], lines[4]]) + "\n")
    common = dict(calibration_path=calibration, base_data_folder=data_dir, batch_size=700, frame_numbers=FRAMES)
    j_loader = j_traj.get_trajectory_dataloader_from_calibration(
        dataloader_output_mode=JLoader.OutputMode.RAYS_AND_SAMPLES,
        space_pruning_mode=JLoader.SpacePruningMode.OCCUPANCY_GRID, **common)
    j_batches = _drain(j_loader)

    test_folder = data_dir.parent / "test"
    (test_folder / "stale.txt").write_text("left by an earlier run")
    t_loader = t_traj.get_trajectory_dataloader_from_calibration(
        space_pruning_mode=TLoader.SpacePruningMode.OCCUPANCY_GRID, **common)
    assert sorted(p.name for p in test_folder.iterdir()) == ["calibration.csv"]
    assert (test_folder / "calibration.csv").read_bytes() == calibration.read_bytes()
    assert t_loader.render_sequence == [(0, 0), (1, 1), (2, 1), (3, 0)]
    _assert_same_views(j_loader, j_batches, t_loader, _drain(t_loader))
    assert (data_dir / "calibration.csv").exists()  # the data folder itself is untouched


def test_cli_writes_both_trajectory_phases(scene, tmp_path, capsys):
    root, data_dir = scene
    calibration = tmp_path / "three.csv"
    calibration.write_text("\n".join((data_dir / "calibration.csv").read_text().splitlines()[:4]) + "\n")
    ws = tmp_path / "ws"
    t_main([
        "--config", "example_synthetic", "--dataset.path", str(root), "--workspace", str(ws), "--device", "cpu",
        "--train", "false", "--evaluate", "false", "--test.rays_batch_size", "800",
        "--tpu.sampling", "proposal", "--tpu.proposal_rank", "8", "--tpu.proposal_resolution", "64",
        "--tpu.proposal_samples_per_ray", "16", "--tpu.render_samples_per_ray", "8",
        "--model.log2_hashmap_size", "12", "--model.n_levels", "4", "--model.finest_resolution", "128",
        "--test.trajectory_via_keycams", "0", "2", "4", "--test.trajectory_num_cameras", "5",
        "--test.trajectory_via_calibration_file", str(calibration),
    ])
    results = ws / "results"
    keycams = sorted(p.name for p in (results / "test_keycams").iterdir())
    calib = sorted(p.name for p in (results / "test_calibration_file").iterdir())
    assert keycams == [f"{i:06d}.png" for i in range(5)]
    assert calib == [f"{i:06d}.png" for i in range(3)]  # max(3 cameras, 2 frames)
    from humanrf_torch.core import image_io

    frame = image_io.imread(results / "test_keycams" / "000000.png")
    assert frame.shape == (40, 40, 3)
    if shutil.which("ffmpeg") is None:
        assert capsys.readouterr().out.count("[WARNING] ffmpeg not found") == 2
    else:
        assert (results / "video_test_keycams.mp4").exists() and (results / "video_test_calibration_file.mp4").exists()
