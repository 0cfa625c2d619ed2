"""The frozen scene generator against the port's at a tiny size: the same
cameras, boxes, images and occupancy grids, written so that the port's
loader reads back the exact pixels (a test may read the port; the harness
may not)."""
import dataclasses

import numpy as np
import torch

from hrfbench.scene import generate as frozen
from humanrf_torch.core import synthetic as port
from humanrf_torch.core.dataset import VolumetricDataset

PARAMS = dict(num_cameras=6, width=40, height=32, num_frames=3, grid_resolution=32, num_rods=3, center_end=(0, 0, 0.1))


def test_the_frozen_scene_is_the_ports(tmp_path):
    cfg_f = frozen.SyntheticSceneConfig(**PARAMS)
    cfg_p = port.SyntheticSceneConfig(**PARAMS)
    frozen.generate(tmp_path / "f", cfg_f)
    port.generate_synthetic_dataset(tmp_path / "p", cfg_p)
    seq_f, data_f = frozen.scene_paths(tmp_path / "f")
    seq_p = tmp_path / "p" / "SynthActor" / "Sequence1"
    assert (data_f / "calibration.csv").read_text() == (seq_p / "1x" / "calibration.csv").read_text()
    assert (seq_f / "aabbs.csv").read_text() == (seq_p / "aabbs.csv").read_text()
    ds_f, ds_p = VolumetricDataset(data_f), VolumetricDataset(seq_p / "1x")
    cams = frozen.make_cameras(cfg_f)
    for fi in range(cfg_f.num_frames):
        assert np.array_equal(ds_f.get_occupancy_grid(fi), ds_p.get_occupancy_grid(fi))
        center = torch.tensor(port._sphere_center(cfg_p, fi).astype(np.float32))
        inv = torch.tensor(np.stack([c.inverse_kr() for c in cams]).astype(np.float32))
        org = torch.tensor(np.stack([c.translation for c in cams]).astype(np.float32))
        rgb, mask = port.render_cameras(cfg_p, inv, org, center, 0.5 * fi, cfg_p.height, cfg_p.width)
        for ci in range(len(cams)):
            # the port's reader, on the frozen scene's lossless files: the rendered pixels exactly
            assert np.array_equal(ds_f.get_rgb(ci, fi), rgb[ci].numpy()[..., ::-1] / np.float32(255))
            assert np.array_equal(ds_f.get_mask(ci, fi), mask[ci].numpy()[..., None].astype(np.float32))


def test_png_round_trip():
    rng = np.random.default_rng(0)
    for shape in ((5, 7), (4, 3, 3)):
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        assert np.array_equal(frozen.decode_png(frozen.encode_png(img)), img)


def test_scene_config_from_a_configuration_file():
    cfg = frozen.scene_config({"num_cameras": 3, "center_start": [0.0, 0.0, -0.1], "camera_angles": None})
    assert cfg.center_start == (0.0, 0.0, -0.1) and dataclasses.replace(cfg).num_cameras == 3
