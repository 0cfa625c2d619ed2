"""The committed view inputs of the port's full-width render
(runs_evidence/r4_full_schedule_748/torch_view_inputs.npz) are what
scripts/make_torch_view_inputs.py makes from the JAX package today, so the
fixture cannot drift from the loader, camera, grid and scene code."""
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import make_torch_view_inputs as mtvi  # noqa: E402


def test_committed_view_inputs_match_a_fresh_build():
    committed = np.load(mtvi.OUT_PATH)
    cfg = mtvi.scene_config()
    fresh = {**mtvi.view_geometry(cfg), **mtvi.ground_truth(cfg)}
    for key, value in fresh.items():
        np.testing.assert_array_equal(committed[key], value, err_msg=key)
        assert committed[key].dtype == np.asarray(value).dtype, key
    assert json.loads(str(committed["config_json"])) == mtvi.run_config()
    assert set(committed.files) == {*fresh, "config_json", "jax_render"}


def test_view_is_the_banked_test_render():
    committed = np.load(mtvi.OUT_PATH)
    config = json.loads(str(committed["config_json"]))
    assert (config["camera_name"], config["frame_number"]) == ("Cam012", 0)
    assert (mtvi.RUN_DIR / "eval_Cam012_rgb000000.png").exists()
    assert committed["jax_render"].shape == committed["gt_rgb"].shape == (748, 748, 3)
    assert committed["camera_numbers"].tolist() == [11] and committed["frame_numbers"].tolist() == [0]
