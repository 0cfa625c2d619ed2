"""The committed dense-render inputs of the port's chip check
(runs_evidence/r4_full_schedule_748/torch_dense_inputs.npz): the settings
and the patch are what scripts/make_torch_dense_inputs.py builds today, and
the baked JAX render is a render of that patch. Re-rendering it in JAX takes
the script ~90 s on the CPU, mostly XLA compiling the r4 model, so it is not
repeated here (tests/test_torch_dense.py holds the port's render to it)."""
import json
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "scripts"))

import make_torch_dense_inputs as mtdi  # noqa: E402


def test_committed_settings_and_patch_match_a_fresh_build():
    committed = np.load(mtdi.OUT_PATH)
    config = json.loads(str(committed["config_json"]))
    assert config == {**mtdi.dense_settings(), "patch": 128, "block": 32, "field_backend": "gather"}
    mask = np.load(mtdi.VIEW_PATH)["gt_mask"]
    np.testing.assert_array_equal(committed["pixel_idx"], mtdi.patch_blocks(mask))
    assert set(committed.files) == {"config_json", "pixel_idx", "jax_color", "jax_weights_sum"}

    # A 128×128 square inside the image, centred on the subject's bounding box.
    ids = committed["pixel_idx"].reshape(-1)
    ys, xs = ids // mask.shape[1], ids % mask.shape[1]
    assert len(np.unique(ids)) == 128 * 128 and np.ptp(ys) == np.ptp(xs) == 127
    my, mx = np.nonzero(mask)
    assert abs((ys.min() + ys.max()) / 2 - (my.min() + my.max()) / 2) <= 1
    assert abs((xs.min() + xs.max()) / 2 - (mx.min() + mx.max()) / 2) <= 1
    # The budgets hold every lattice point of a batch.
    assert config["candidate_budget"] == config["samples_per_ray"] * config["num_rays"] == 512 * 1024


def test_committed_jax_render_is_a_render_of_the_patch():
    """Finite colors of the baked shape whose accumulated alpha agrees with
    the view's mask on ≥ 95% of the patch (98.7% as baked) and whose colors
    are ≥ 17 dB from the masked ground truth (19.46 dB as baked)."""
    committed = np.load(mtdi.OUT_PATH)
    view = np.load(mtdi.VIEW_PATH)
    color, wsum = committed["jax_color"], committed["jax_weights_sum"]
    assert color.shape == (16, 1024, 3) and wsum.shape == (16, 1024)
    assert np.isfinite(color).all() and color.dtype == wsum.dtype == np.float32
    ids = committed["pixel_idx"].reshape(-1)
    mask = view["gt_mask"].reshape(-1)[ids] > 0
    gt = view["gt_rgb"].reshape(-1, 3)[ids] / 255.0 * mask[:, None]
    assert ((wsum.reshape(-1) > 0.5) == mask).mean() >= 0.95
    assert -10 * np.log10(np.square(color.reshape(-1, 3) - gt).mean()) >= 17.0
