"""The routed reference (`hrfbench/reference/routed.py`) and the 1000-frame
cell, at a tiny size on the CPU:

- the routed field equals the masked one bit for bit, forward and gradient,
  and logs the same work, at 2 and 5 segments;
- the port's train step, driven by `train_loop_routed`, against the routed
  reference over 13 segments of 6 and 12 frames, of which a step's rays
  reach at most 2: the first loss bit for bit, the gaps within the dense
  cell's tiny-size tolerances, and the cell's limits;
- the bfloat16-table control, the half-batch fault and an optimizer that
  skips the leaves without gradient each fail the cell's limits
  (`control_routed`);
- the configuration's scene, its grids at half the resolution, partitions
  into the configuration's `segment_sizes`.
"""
import copy

import numpy as np
import pytest
import torch

from hrfbench import control_routed, harness
from hrfbench.drivers import train_loop_routed
from hrfbench.reference import routed
from hrfbench.reference.humanrf import HumanRFConfig, HumanRFModel
from hrfbench.run import judge
from hrfbench.tests import hrfbench_tiny as tiny

CELL = "paper-1000f.train"


@pytest.fixture(autouse=True)
def scene_cache(tmp_path_factory, monkeypatch):
    monkeypatch.setattr(harness, "CACHE_DIR", tmp_path_factory.getbasetemp() / "hrfbench-cache")


def _models(sizes, seed):
    """A masked and a routed model over `sizes`, with the same fresh weights
    (tables scaled up, so that features are far from zero)."""
    cfg = HumanRFConfig(sorted_frame_numbers=tuple(range(sum(sizes))), segment_sizes=tuple(sizes), n_levels=3,
                        log2_hashmap_size=12, coarsest_resolution=4, finest_resolution=64, camera_embedding_dim=2)
    masked, routed_model = HumanRFModel(cfg), routed.RoutedHumanRFModel(cfg)
    masked.init_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():
        for segment in masked.segments:
            for name in ("xyz", "xyt", "yzt", "xzt"):
                getattr(segment, name).mul_(3e3)
    routed_model.load_state_dict(masked.state_dict())
    return masked, routed_model


@pytest.mark.parametrize("sizes", [(6, 12), (6, 12, 6, 25, 6)])
def test_the_routed_field_equals_the_masked_one_bit_for_bit(sizes):
    masked, routed_model = _models(sizes, seed=len(sizes))
    frames_total = sum(sizes)
    for model in (masked, routed_model):
        model.frame_to_segment[frames_total - 1] = -1  # a frame of no segment
    rng = np.random.default_rng(len(sizes))
    n = 900
    positions = torch.tensor(rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32))
    frames = torch.tensor(rng.integers(0, frames_total, n))
    n_valid = torch.tensor([int(0.7 * n)], dtype=torch.int32)
    grad = torch.tensor(rng.normal(size=(n, 6)).astype(np.float32))
    outs, logs = [], []
    for model in (masked, routed_model):
        log = []
        model.set_work_log(log)
        out = model.features(positions, frames, n_valid=n_valid)
        model.set_work_log(None)
        out.backward(grad)
        outs.append(out)
        logs.append(log)
    assert torch.equal(outs[0], outs[1])
    live = (torch.arange(n) < n_valid) & (frames != frames_total - 1)
    assert outs[1][live].abs().min() > 0 and not outs[1][~live].any()
    assert logs[0] == logs[1] and len(logs[0]) == 2 * len(sizes)
    for (name, a), (_, b) in zip(masked.named_parameters(), routed_model.named_parameters()):
        if name.startswith("segments."):
            assert a.grad.abs().max() > 0 and torch.equal(a.grad, b.grad), name


# 13 segments, [6, 6, 12, 12, 12, 12, 12, 6, 6, 6, 6, 6, 6]: the actor drifts
# 0.005 a frame, listed every frame in the middle and every third frame at
# both ends.
FRAMES = [*range(0, 45, 3), *range(45, 105), *range(105, 200, 3)]
SEGMENTS = [6, 6, 12, 12, 12, 12, 12, 6, 6, 6, 6, 6, 6]


def _conf():
    conf = tiny.train_conf("paper-1000f")
    conf["scene"].update(num_frames=200, first_frame=0, center_start=[0.0, 0.0, -0.5], center_end=[0.0, 0.0, 0.5])
    f = conf["flags"]
    i = f.index("--dataset.frame_numbers") + 1
    f[i:i + 4] = [str(n) for n in FRAMES]
    conf["segment_sizes"] = SEGMENTS
    return conf


def test_the_routed_reference_follows_the_ports_first_steps_over_thirteen_segments():
    record = train_loop_routed.run(tiny.context(_conf(), "train_loop", seed=2**31 + 313))
    numbers = record["numbers"]
    assert numbers["feed_mismatches"] == 0
    assert record["losses"]["program"][0] == record["losses"]["reference"][0]
    assert numbers["loss_gap"] < 1e-6 and numbers["grad_gap"] < 1e-5 and numbers["median_update_gap"] < 1e-4, numbers
    assert numbers["stray_grad"] == 0 and numbers["unreached_update_gap"] < 1e-5, numbers
    assert record["worst_leaves"]["unreached_leaf"] is not None  # most segments take decay alone
    assert judge(numbers, harness.load_json("limits", CELL))[0]
    assert record["attempted"] > 0 and record["failed"] == 0


def test_the_control_and_the_fault_fail_the_cell():
    torch.set_num_threads(4)
    out = control_routed.readings_of(CELL, _conf(), tiny.traffic("train_loop"), 2**31 + 7, 0.5, torch.device("cpu"))
    limits = harness.load_json("limits", CELL)
    assert judge(out["program"], limits)[0]
    for kind in ("control", "half_batch", "skip_unreached"):
        assert not judge(dict(out[kind], feed_mismatches=0), limits)[0], (kind, out[kind])


def test_the_scene_partitions_into_the_configurations_segments():
    from humanrf_torch import run as cli
    from humanrf_torch.configs.args import parse_args

    conf = copy.deepcopy(harness.load_json("configs", "paper-1000f"))
    scene_params = dict(conf["scene"], num_cameras=2, width=8, height=8,
                        grid_resolution=conf["scene"]["grid_resolution"] // 2)
    scene, _ = harness.ensure_scene(scene_params, torch.device("cpu"))
    config = parse_args([*conf["flags"], "--dataset.path", str(scene), "--workspace", str(scene / "ws"),
                         "--device", "cpu"])
    data = scene / config.dataset.actor / config.dataset.sequence / f"{config.dataset.scale}x"
    sizes = cli.compute_segment_sizes(config, data, tuple(config.dataset.frame_numbers))
    assert sizes == conf["segment_sizes"] and len(sizes) >= 20 and max(sizes) <= 50
