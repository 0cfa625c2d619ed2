"""The committed training inputs of the port's flagship step
(runs_evidence/r4_full_schedule_748/torch_train_inputs.npz) are what
scripts/make_torch_train_inputs.py makes from the JAX package today: the pool
entries, dilated grids, AABB and size are rebuilt here through the JAX
loader (the images, which take the scene renderer, are checked for shape and
content only)."""
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import make_torch_train_inputs as mtti  # noqa: E402


def test_committed_pool_matches_a_fresh_build():
    committed = np.load(mtti.OUT_PATH)
    fresh = mtti.pool_geometry(mtti.mtvi.scene_config())
    for key, value in fresh.items():
        np.testing.assert_array_equal(committed[key], value, err_msg=key)
        assert committed[key].dtype == np.asarray(value).dtype, key
    assert set(committed.files) == {*fresh, "pixel_rgba"}


def test_pool_holds_the_train_cameras_at_one_frame_of_each_segment():
    committed = np.load(mtti.OUT_PATH)
    train_cameras = [0, 1, 2, 4, 5, 7, 9, 10]  # 12-camera rig: 3 validation cameras (3, 6, 8), test camera 11
    assert committed["camera_numbers"].tolist() == train_cameras * 2
    assert committed["frame_numbers"].tolist() == [0] * 8 + [25] * 8
    assert committed["grid_slots"].tolist() == [0] * 8 + [1] * 8
    rgba = committed["pixel_rgba"]
    assert rgba.shape == (16, 748 * 748, 4) and rgba.dtype == np.uint8
    alpha = rgba[..., 3]
    assert set(np.unique(alpha).tolist()) == {0, 255}
    assert 0.02 < (alpha > 0).mean() < 0.2  # the actor covers a few percent of each image
    assert not rgba[..., :3][alpha == 0].any()  # rgb·mask: black outside the mask
    assert mtti.OUT_PATH.stat().st_size < 5e6
