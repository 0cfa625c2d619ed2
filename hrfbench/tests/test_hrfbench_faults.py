"""A run whose timed path is broken underneath comes out not correct, by the
cells' own limits: the harness's look for a card is skipped, the port runs
its plain CPU path at a tiny size, and each fault that a cell can have is
planted in the port."""
import pytest
import torch

import humanrf_torch.train.pipeline as port_pipeline
from hrfbench import harness
from hrfbench.drivers import render_trajectory, train_loop
from hrfbench.run import judge
from hrfbench.tests import hrfbench_tiny as tiny
from humanrf_torch.train.trainer import AdamW


@pytest.fixture(autouse=True)
def scene_cache(tmp_path_factory, monkeypatch):
    monkeypatch.setattr(harness, "CACHE_DIR", tmp_path_factory.getbasetemp() / "hrfbench-cache")


def half_batch(masked_mean):
    def mean(values, mask, group=None):  # the mean over the first half of the rows the loss counts
        return masked_mean(values, mask & (torch.cumsum(mask.long(), 0) <= mask.sum() // 2), group)
    return mean


def altered_loss(training_loss):
    def loss(*args, **kwargs):  # the loss reported 0.1% off where it is produced, its gradient untouched
        total, aux = training_loss(*args, **kwargs)
        return total + 1e-3 * total.detach(), aux
    return loss


FAULTS = {
    "state unchanged": lambda mp: mp.setattr(AdamW, "step", lambda self: None),
    "half the batch": lambda mp: mp.setattr(port_pipeline, "masked_mean", half_batch(port_pipeline.masked_mean)),
    "loss altered": lambda mp: mp.setattr(port_pipeline, "training_loss", altered_loss(port_pipeline.training_loss)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell,config", [("r4-proposal.train", "r4-proposal"), ("paper-dense.train", "paper-dense")])
def test_a_broken_train_step_is_not_correct(monkeypatch, cell, config, fault):
    FAULTS[fault](monkeypatch)
    record = train_loop.run(tiny.context(tiny.train_conf(config), "train_loop", seed=2**31 + 91))
    correct, checks = judge(record["numbers"], harness.load_json("limits", cell))
    assert not correct, checks


def test_an_altered_view_is_not_correct(monkeypatch):
    composite = port_pipeline.composite_grid

    def altered(weights, radiance, background):  # every colour off by 1/255 where it is produced
        out = composite(weights, radiance, background)
        return out._replace(color=out.color + 1.0 / 255)

    monkeypatch.setattr(port_pipeline, "composite_grid", altered)
    record = render_trajectory.run(tiny.context(tiny.render_conf(), "render_trajectory", seed=6, seconds=3.0))
    correct, checks = judge(record["numbers"], harness.load_json("limits", "r4-proposal.render"))
    assert not correct, checks
