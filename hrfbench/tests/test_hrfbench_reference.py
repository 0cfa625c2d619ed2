"""The reference against the port's eager step and render at a tiny size
on the CPU, driven as a benchmark run drives them (the port's plain CPU path
stands in for its kernels), judged by the cells' own limits."""
import pytest

from hrfbench import harness
from hrfbench.drivers import render_trajectory, train_loop
from hrfbench.run import judge
from hrfbench.tests import hrfbench_tiny as tiny


@pytest.fixture(autouse=True)
def scene_cache(tmp_path_factory, monkeypatch):
    monkeypatch.setattr(harness, "CACHE_DIR", tmp_path_factory.getbasetemp() / "hrfbench-cache")


@pytest.mark.parametrize("cell,config", [("r4-proposal.train", "r4-proposal"), ("paper-dense.train", "paper-dense")])
def test_the_reference_follows_the_ports_first_steps(cell, config):
    record = train_loop.run(tiny.context(tiny.train_conf(config), "train_loop", seed=2**31 + 77))
    numbers = record["numbers"]
    assert numbers["feed_mismatches"] == 0
    assert record["losses"]["program"][0] == record["losses"]["reference"][0]
    assert numbers["loss_gap"] < 1e-6 and numbers["grad_gap"] < 1e-5 and numbers["median_update_gap"] < 1e-4, numbers
    assert judge(numbers, harness.load_json("limits", cell))[0]
    assert record["attempted"] > 0 and record["failed"] == 0


def test_the_reference_renders_the_ports_views():
    record = render_trajectory.run(tiny.context(tiny.render_conf(), "render_trajectory", seed=5, seconds=3.0))
    assert record["numbers"] == {"view_max_gap": 0.0, "view_rms_gap": 0.0}
    assert judge(record["numbers"], harness.load_json("limits", "r4-proposal.render"))[0]
    assert len(record["compared_views"]) == 2 and record["views"] >= 2
