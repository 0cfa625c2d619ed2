"""`--dataset.filter_light_bloom` in the port (humanrf_torch/data/loader.py,
humanrf_torch/core/morphology.py) against the JAX package and OpenCV.

- `erode`, `dilate` and `fill_circle` bit-equal to `cv2.erode`,
  `cv2.dilate` and `cv2.circle(..., -1)` across kernel sizes (odd, even,
  0 for OpenCV's default) and across radii and centres, off the image too;
  cv2 is only the oracle here, the port never imports it;
- the per-entry `light_ok` and the batches' `ray_light_ok` bit-equal to the
  JAX loader's, TRAINING and VALIDATION, with and without the centre-square
  crop (whose annotations are shifted by the crop offsets);
- a batch whose `ray_light_ok` is all False supervises no ray: loss 0 and
  finite parameters after the update.
"""
import csv

import cv2
import numpy as np
import pytest
import torch

from humanrf_torch.core import morphology
from humanrf_torch.core.dataset import VolumetricDataset as TDataset
from humanrf_torch.data.loader import DataLoader as TLoader
from humanrf_torch.models.humanrf import HumanRFConfig, HumanRFModel
from humanrf_torch.train.pipeline import PipelineConfig, make_train_step
from humanrf_torch.train.trainer import make_optimizer
from humanrf_torch.utils.rngs import make_key
from humanrf_tpu.core.dataset import VolumetricDataset as JDataset
from humanrf_tpu.core.synthetic import SyntheticSceneConfig, generate_synthetic_dataset
from humanrf_tpu.data.loader import DataLoader as JLoader

torch.set_num_threads(2)

KERNEL_SIZES = (0, 1, 2, 3, 4, 5, 8, 15, 16, 80)
# (camera, x, y, r): discs on the subject's border, one reaching past the
# image, one centred off it, and one camera without any.
DISCS = [("Cam001", 64, 48, 200), ("Cam002", 40, 30, 12), ("Cam002", 100, 70, 25), ("Cam002", -10, 50, 30),
         ("Cam003", 140.4, -6.6, 40.5)]


@pytest.mark.parametrize("k", KERNEL_SIZES)
@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
def test_erode_and_dilate_are_bit_equal_to_cv2(k, dtype):
    rng = np.random.default_rng(k)
    img = rng.random((37, 53, 1))
    img = (img * 255).astype(np.uint8) if dtype == np.uint8 else img.astype(np.float32)
    img[5:30, 10:40] = img.max()  # a blob, so the border of a mask exists too
    kernel = np.ones((k, k), np.uint8)
    np.testing.assert_array_equal(morphology.erode(img, k), cv2.erode(img, kernel))
    np.testing.assert_array_equal(morphology.dilate(img, k), cv2.dilate(img, kernel))


@pytest.mark.parametrize("seed", range(4))
def test_fill_circle_is_bit_equal_to_cv2(seed):
    rng = np.random.default_rng(seed)
    for _ in range(400):
        height, width = (int(v) for v in rng.integers(1, 70, 2))
        center = tuple(int(v) for v in rng.integers(-60, 130, 2))
        radius = int(rng.integers(0, 90))
        ours = morphology.fill_circle(np.zeros((height, width), np.uint8), center, radius, 255)
        theirs = cv2.circle(np.zeros((height, width, 1), np.uint8), center, radius, (255,), -1)[..., 0]
        np.testing.assert_array_equal(ours, theirs, err_msg=f"{(height, width)} {center} {radius}")


@pytest.fixture(scope="module")
def bloom_scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("bloom")
    cfg = SyntheticSceneConfig(num_cameras=3, width=128, height=96, num_frames=2, grid_resolution=32)
    data_dir = generate_synthetic_dataset(root, cfg)
    with open(data_dir / "light_annotations.csv", "w", newline="") as f:
        writer = csv.writer(f)
        writer.writerow(["camera", "x", "y", "r"])
        writer.writerows(DISCS)
    return data_dir


def _loaders(data_dir, crop, mode, **kwargs):
    out = []
    j_extra = {"dataloader_output_mode": JLoader.OutputMode.RAYS_AND_SAMPLES}
    for loader_cls, dataset_cls, extra in ((JLoader, JDataset, j_extra), (TLoader, TDataset, {})):
        out.append(loader_cls(
            dataset=dataset_cls(data_dir, crop_center_square=crop), mode=getattr(loader_cls.Mode, mode),
            space_pruning_mode=loader_cls.SpacePruningMode.OCCUPANCY_GRID, camera_numbers=(0, 1, 2),
            frame_numbers=(0, 1), use_mask=True, filter_light_bloom=True, seed=3, **extra, **kwargs))
    return out


@pytest.mark.parametrize("crop", [False, True])
def test_light_ok_is_bit_equal_to_jax_in_training(bloom_scene, crop):
    j_loader, t_loader = _loaders(bloom_scene, crop, "TRAINING", batch_size=4096, max_buffer_size=4,
                                  max_num_frames_per_batch=2, deterministic=True)
    try:
        j_iter, t_iter = iter(j_loader), iter(t_loader)
        filtered = 0
        for _ in range(6):  # entries are replaced one per batch: new cameras come in
            jb, tb = next(j_iter)[0], next(t_iter)[0]
            np.testing.assert_array_equal(t_loader.entry_camera_numbers, j_loader.entry_camera_numbers)
            np.testing.assert_array_equal(t_loader.light_ok, j_loader.light_ok)
            np.testing.assert_array_equal(tb.ray_light_ok.numpy(), np.asarray(jb.ray_light_ok))
            filtered += int((~tb.ray_light_ok).sum())
        assert filtered > 0 and not t_loader.light_ok.all()
    finally:
        j_loader.shutdown()
        t_loader.shutdown()


def test_light_ok_is_bit_equal_to_jax_in_validation(bloom_scene):
    sequence = [(1, 0), (2, 1), (0, 1)]
    j_loader, t_loader = _loaders(bloom_scene, False, "VALIDATION", batch_size=5000, max_buffer_size=1,
                                  render_sequence=sequence)
    try:
        pairs = list(zip(j_loader, t_loader))
        assert len(pairs) == t_loader.num_batches_per_full_image * len(sequence) == 9
        for (jb, *_), (tb, *_) in pairs:
            np.testing.assert_array_equal(tb.ray_light_ok.numpy(), np.asarray(jb.ray_light_ok))
        assert not all(bool(tb.ray_light_ok.all()) for (tb, *_) in (p[1] for p in pairs))
    finally:
        j_loader.shutdown()
        t_loader.shutdown()


def test_a_batch_without_light_ok_rays_gives_zero_loss_and_finite_parameters(bloom_scene):
    t_loader = TLoader(
        dataset=TDataset(bloom_scene), mode=TLoader.Mode.TRAINING,
        space_pruning_mode=TLoader.SpacePruningMode.OCCUPANCY_GRID, batch_size=512, camera_numbers=(0, 1, 2),
        frame_numbers=(0, 1), max_buffer_size=6, max_num_frames_per_batch=2, use_mask=True,
        filter_light_bloom=True, seed=3, deterministic=True)
    try:
        batch, pool, grids, _ = next(iter(t_loader))
    finally:
        t_loader.shutdown()
    model = HumanRFModel(HumanRFConfig(sorted_frame_numbers=(0, 1), segment_sizes=(2,), log2_hashmap_size=12,
                                       n_levels=4, finest_resolution=128, proposal_rank=8, proposal_resolution=64))
    model.init_parameters(torch.Generator().manual_seed(0))
    optimizer = make_optimizer(model.named_parameters(), 1e-2, 0.5, 100, 0.03)
    cfg = PipelineConfig(sampling="proposal", num_rays=256, candidate_rays_factor=2, proposal_samples_per_ray=16,
                         render_samples_per_ray=8)
    width, height = t_loader.resolution
    step = make_train_step(cfg, model, optimizer, width, height)
    loss, aux = step(batch._replace(ray_light_ok=torch.zeros_like(batch.ray_light_ok)), pool, grids,
                     t_loader.device_aabb, make_key(0))
    assert float(loss) == 0.0 and int(aux["num_rays_supervised"]) == 0
    assert all(bool(torch.isfinite(p).all()) for p in model.parameters())
    assert int(optimizer.skipped) == 0
