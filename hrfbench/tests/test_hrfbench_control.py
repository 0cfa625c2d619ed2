"""The correctness control, kept at a size a test run holds: the reference
put in the port's place with its tables read in bfloat16 (the precision
below the configuration's float32) fails each cell's limits, while the port
passes them (`hrfbench/control.py` reads the same on the card, at the
cells' own sizes)."""
import pytest
import torch

from hrfbench import control, harness
from hrfbench.run import judge
from hrfbench.tests import hrfbench_tiny as tiny


@pytest.fixture(autouse=True)
def scene_cache(tmp_path_factory, monkeypatch):
    monkeypatch.setattr(harness, "CACHE_DIR", tmp_path_factory.getbasetemp() / "hrfbench-cache")


@pytest.mark.parametrize("cell,config", [("r4-proposal.train", "r4-proposal"), ("paper-dense.train", "paper-dense")])
def test_the_control_fails_a_training_cell(cell, config):
    torch.set_num_threads(4)
    out = control.readings_of(cell, tiny.train_conf(config), tiny.traffic("train_loop"), 2**31 + 5, 0.5,
                              torch.device("cpu"))
    limits = harness.load_json("limits", cell)
    assert judge(out["program"], limits)[0]
    for kind in ("control", "half_batch"):
        assert not judge(dict(out[kind], feed_mismatches=0), limits)[0], (kind, out[kind])


def test_the_control_fails_the_render_cell():
    torch.set_num_threads(4)
    out = control.readings_of("r4-proposal.render", tiny.render_conf(), tiny.traffic("render_trajectory"), 9, 3.0,
                              torch.device("cpu"))
    limits = harness.load_json("limits", "r4-proposal.render")
    assert judge(out["program"], limits)[0]
    assert not judge(out["control"], limits)[0], out["control"]
