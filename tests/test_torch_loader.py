"""The port's DataLoader (humanrf_torch/data/loader.py) against the JAX
package's on one dataset written by the JAX generator.

- TRAINING, deterministic, with a pool smaller than the (camera, frame)
  pairs so that entries are replaced: 30 batches whose pixel draws, pool
  metadata, dilated grids and rgba are bit-equal (the same seeded numpy
  draws, the same float32 arithmetic, the codec bit-equal to cv2).
- VALIDATION and TEST with a pool of one image, so that the replacer thread
  and the empty/available semaphores hand every image over: every batch of
  the render sequence equal, and `shutdown` returns at once.
"""
import time

import numpy as np
import pytest
import torch

from humanrf_torch.core.dataset import VolumetricDataset as TDataset
from humanrf_torch.data.loader import DataLoader as TLoader
from humanrf_tpu.core.dataset import VolumetricDataset as JDataset
from humanrf_tpu.data.loader import DataLoader as JLoader

torch.set_num_threads(2)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_batches_equal(jb, tb):
    (jbatch, jpool, jgrids, jinfo), (tbatch, tpool, tgrids, tinfo) = jb, tb
    for name in jbatch._fields:
        np.testing.assert_array_equal(_np(getattr(tbatch, name)), _np(getattr(jbatch, name)), err_msg=name)
    for name in jpool._fields:
        np.testing.assert_array_equal(_np(getattr(tpool, name)), _np(getattr(jpool, name)), err_msg=name)
    np.testing.assert_array_equal(_np(tgrids), _np(jgrids))
    assert (tinfo.num_real, tinfo.width, tinfo.height, tinfo.camera_number, tinfo.frame_number) == (
        jinfo.num_real, jinfo.width, jinfo.height, jinfo.camera_number, jinfo.frame_number)


def _both(data_dir, mode, **kwargs):
    loaders = []
    for loader_cls, dataset_cls, pruning in ((JLoader, JDataset, JLoader.SpacePruningMode),
                                             (TLoader, TDataset, TLoader.SpacePruningMode)):
        loaders.append(loader_cls(dataset=dataset_cls(data_dir), mode=getattr(loader_cls.Mode, mode),
                                  space_pruning_mode=pruning.OCCUPANCY_GRID, seed=5, **kwargs))
    return loaders


def test_training_batches_are_bit_equal(synthetic_dataset):
    data_dir, _ = synthetic_dataset
    jl, tl = _both(data_dir, "TRAINING", batch_size=256, camera_numbers=(0, 1, 2, 3, 4, 5), frame_numbers=(0, 1, 2),
                   max_buffer_size=5, max_num_frames_per_batch=2, use_mask=True, filter_light_bloom=False,
                   deterministic=True)
    try:
        assert jl.buffer_size == tl.buffer_size == 5 and tl.run_replacer_thread and tl.deterministic
        np.testing.assert_array_equal(tl.aabb, jl.aabb)
        np.testing.assert_array_equal(tl.pixel_rgba, jl.pixel_rgba)
        ji, ti = iter(jl), iter(tl)
        seen_frames = set()
        for _ in range(30):
            jb, tb = next(ji), next(ti)
            _assert_batches_equal(jb, tb)
            seen_frames |= set(_np(tb[1].frame_numbers).tolist())
        assert tl.pair_load_index == 5 + 30 and seen_frames == {0, 1, 2}
    finally:
        jl.shutdown()
        tl.shutdown()


@pytest.mark.parametrize("mode", ["VALIDATION", "TEST"])
def test_render_sequence_batches_are_equal(synthetic_dataset, mode):
    data_dir, _ = synthetic_dataset
    sequence = [(6, 0), (7, 2), (6, 1)]
    extra = {"use_mask": True, "filter_light_bloom": False} if mode == "VALIDATION" else {}
    jl, tl = _both(data_dir, mode, batch_size=1000, camera_numbers=(6, 7), frame_numbers=(0, 1, 2), max_buffer_size=1,
                   render_sequence=sequence, **extra)
    try:
        assert tl.run_replacer_thread and tl._replacer_thread.is_alive()
        jbatches, tbatches = list(jl), list(tl)
        assert len(tbatches) == len(jbatches) == 3 * tl.num_batches_per_full_image == 9
        for jb, tb in zip(jbatches, tbatches):
            _assert_batches_equal(jb, tb)
        assert [(b[3].camera_number, b[3].frame_number) for b in tbatches[::3]] == sequence
        if mode == "VALIDATION":
            assert max(float(b[0].rgba[:, 3].max()) for b in tbatches) == 1.0
    finally:
        jl.shutdown()
        t0 = time.perf_counter()
        tl.shutdown()
        assert time.perf_counter() - t0 < 2.0 and tl._replacer_thread is None


def test_dataset_reader_and_partitioning_match_jax(tmp_path):
    """`VolumetricDataset` with the centre-square crop on a rig with a
    portrait camera: cameras, AABB, images (bit-equal through the codec),
    masks, grids and light annotations; and the adaptive partitioning."""
    from humanrf_torch.train.partitioning import compute_adaptive_segment_sizes as t_partition
    from humanrf_tpu.core.synthetic import SyntheticSceneConfig, generate_synthetic_dataset
    from humanrf_tpu.train.partitioning import compute_adaptive_segment_sizes as j_partition

    data_dir = generate_synthetic_dataset(tmp_path, SyntheticSceneConfig(
        num_cameras=4, width=40, height=30, num_frames=14, grid_resolution=32, portrait_camera_indices=(1,),
        center_start=(0.0, 0.0, -0.2), center_end=(0.0, 0.0, 0.2)))
    (data_dir / "light_annotations.csv").write_text("camera,x,y,r\nCam001,20.4,10.6,3.2\nCam002,5,30.5,2\n")
    for crop in (False, True):
        jd, td = JDataset(data_dir, crop_center_square=crop), TDataset(data_dir, crop_center_square=crop)
        assert td.crop_offsets == jd.crop_offsets
        for jc, tc in zip(jd.cameras, td.cameras):
            assert (tc.name, tc.width, tc.height) == (jc.name, jc.width, jc.height)
            np.testing.assert_array_equal(tc.inverse_kr(), jc.inverse_kr())
            np.testing.assert_array_equal(tc.translation, jc.translation)
        np.testing.assert_array_equal(td.get_aabb(), jd.get_aabb())
        assert dict(td.get_light_annotations()) == dict(jd.get_light_annotations())
        for cam in range(4):
            for frame in (0, 5):
                for get in ("get_rgb", "get_mask"):
                    t_img, j_img = getattr(td, get)(cam, frame), getattr(jd, get)(cam, frame)
                    assert t_img.dtype == j_img.dtype == np.float32
                    np.testing.assert_array_equal(t_img, j_img)
        np.testing.assert_array_equal(td.get_occupancy_grid(3), jd.get_occupancy_grid(3))
    sizes = t_partition(TDataset(data_dir), list(range(14)), expansion_factor_threshold=1.05)
    assert sizes == j_partition(JDataset(data_dir), list(range(14)), expansion_factor_threshold=1.05)
    assert len(sizes) > 1


def test_free_running_replacer_keeps_every_snapshot_consistent(synthetic_dataset):
    """The replacer thread racing the consumer, with a short switch interval:
    every batch's pool snapshot points each entry at the dilated grid of its
    own frame (a torn commit or a grid slot recycled under a live entry
    would break this)."""
    import sys

    from humanrf_torch.ops.occupancy import dilate_grid

    data_dir, _ = synthetic_dataset
    dataset = TDataset(data_dir)
    dilated = {f: dilate_grid(torch.as_tensor(dataset.get_occupancy_grid(f))) for f in (0, 1, 2)}
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    loader = TLoader(dataset=dataset, mode=TLoader.Mode.TRAINING, space_pruning_mode=TLoader.SpacePruningMode.OCCUPANCY_GRID,
                     batch_size=64, camera_numbers=(0, 1, 2, 3, 4, 5), frame_numbers=(0, 1, 2), max_buffer_size=5,
                     max_num_frames_per_batch=2, use_mask=True, filter_light_bloom=False, seed=1)
    try:
        assert loader._replacer_thread.is_alive()
        it = iter(loader)
        t0 = time.perf_counter()
        for _ in range(300):
            batch, pool, grids, _ = next(it)
            slots, frames = pool.grid_slots.tolist(), pool.frame_numbers.tolist()
            assert min(slots) >= 0
            for slot, frame in zip(slots, frames):
                assert torch.equal(grids[slot], dilated[frame])
        assert time.perf_counter() - t0 < 60 and loader.pair_load_index > 5
    finally:
        sys.setswitchinterval(interval)
        loader.shutdown()
    assert loader._replacer_thread is None
