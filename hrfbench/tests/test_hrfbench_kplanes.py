"""The K-Planes cell at a tiny size on the CPU: its driver runs the port's
loop and the reference agrees with it within the cell's limits; the
configuration states what the port builds; the bfloat16-planes control and
the half-batch fault read above the program; the counts and readers."""
import copy
import json

import pytest
import torch

from hrfbench import harness
from hrfbench.counts import kplanes_bwd, kplanes_fwd, kplanes_step
from hrfbench.drivers import train_loop_kplanes
from hrfbench.reference import kplanes as ref
from hrfbench.tests import hrfbench_tiny

CELL = "kplanes-hybrid.train"


def _set(flags, name, *values):
    i = flags.index(name) + 1
    j = i
    while j < len(flags) and not flags[j].startswith("--"):
        j += 1
    flags[i:j] = list(values)


def tiny_conf() -> dict:
    """The configuration at a tiny size: 4 frames, M 4 / 4, planes of 8·s and
    8 / 16 texels, time 5, 256 rays of 32 → 16 → 8 samples."""
    conf = copy.deepcopy(harness.load_json("configs", "kplanes-hybrid"))
    f = conf["flags"]
    for name, *values in [("--dataset.frame_numbers", "0", "1", "2", "3"),
                          ("--model.kplanes_feature_dim", "4"), ("--model.kplanes_resolution", "8"),
                          ("--model.kplanes_time_resolution", "5"), ("--model.kplanes_multiscales", "1", "2"),
                          ("--model.kplanes_proposal_feature_dim", "4"),
                          ("--model.kplanes_proposal_resolutions", "8", "16"),
                          ("--training.rays_initial_batch_size", "256"), ("--dataset.max_buffer_size", "8"),
                          ("--dataset.max_num_frames_per_batch", "2"), ("--tpu.proposal_samples_per_ray", "32"),
                          ("--tpu.proposal_mid_samples_per_ray", "16"), ("--tpu.render_samples_per_ray", "8")]:
        _set(f, name, *values)
    conf["scene"].update(hrfbench_tiny.SCENE)
    conf["segment_sizes"] = [4]
    return conf


def _context(conf, seed, keep_inputs=False):
    ctx = hrfbench_tiny.context(conf, "train_loop", seed, keep_inputs=keep_inputs)
    ctx.traffic = dict(harness.load_json("traffic", "train_loop_kplanes"), warmup_steps=1)
    return ctx


@pytest.fixture(scope="module")
def record():
    return train_loop_kplanes.run(_context(tiny_conf(), seed=3_000_000_021, keep_inputs=True))


def test_the_tiny_cell_is_correct_within_its_limits(record):
    limits = harness.load_json("limits", CELL)
    assert set(record["numbers"]) == set(limits)
    for name, value in record["numbers"].items():
        assert value <= limits[name], (name, value, limits[name])
    assert record["attempted"] >= 1 and record["failed"] == 0
    assert record["end_to_end"]["train_rays_per_s"] > 0


def test_the_control_and_the_fault_read_above_the_program(record):
    """The reference with bfloat16 planes and with half the batch's rays
    left out of the loss read far above the program's own gaps, and the
    cell's limits judge the control not correct, as a run would; the
    reference from planes moved one ulp (rounding alone) stays within them."""
    from hrfbench import control_kplanes
    from hrfbench.reference.check import train_numbers
    from hrfbench.run import judge

    inputs = record["inputs"]
    conf = tiny_conf()
    limits = harness.load_json("limits", CELL)

    def numbers(initial=None, **kw):
        run = ref.train_steps(conf, initial or inputs["initial"], inputs["steps"], inputs["width"], inputs["height"],
                              torch.device("cpu"), **kw)
        return train_numbers(run, inputs["reference"], inputs["initial"])[0]

    def correct(found):
        return judge(found, {k: limits[k] for k in found})[0]

    control = numbers(round_planes=True)
    assert control["grad_gap"] > 10 * record["numbers"]["grad_gap"]
    assert not correct(control), control
    with control_kplanes.half_batch():
        fault = numbers()
    assert all(fault[k] > limits[k] for k in ("loss_gap", "grad_gap", "median_update_gap"))
    assert correct(numbers(initial=control_kplanes.one_ulp_up(inputs["initial"])))


def test_the_configuration_states_what_the_port_builds():
    conf = harness.load_json("configs", "kplanes-hybrid")
    spec = {c["name"]: c for c in harness.load_spec()["configs"]}["kplanes-hybrid"]
    assert conf["reduced"] == spec["reduced"] and conf["source"] == spec["source"]
    m = ref.model_config(conf)
    planes = sum(3 * (64 * s) ** 2 * 32 + 3 * 64 * s * 25 * 32 for s in m.multiscales)
    proposals = sum(3 * r * r * 8 + 3 * r * 25 * 8 for r in m.proposal_resolutions)
    assert (planes, proposals) == (35_727_360, 2_196_480)
    from humanrf_torch.configs.args import parse_args
    from humanrf_torch.run import build_model, build_pipeline_config

    config = parse_args(conf["flags"])
    tiny = parse_args(tiny_conf()["flags"])
    train_loop_kplanes.check_config(build_model(tiny, [4], "cpu").config, build_pipeline_config(tiny), tiny_conf())
    bad = copy.deepcopy(tiny_conf())
    _set(bad["flags"], "--model.kplanes_time_resolution", "6")
    with pytest.raises(harness.CheckFailed):
        train_loop_kplanes.check_config(build_model(tiny, [4], "cpu").config, build_pipeline_config(tiny), bad)
    assert config.model.representation == "kplanes" and config.training.photometric == "mse"


def test_counts_and_readers():
    log = [{"kind": "planes", "n": 100, "S": 1, "M": 8, "texels": 50, "grad": True},
           {"kind": "proposal", "level": 0, "grad": True},
           {"kind": "planes", "n": 80, "S": 1, "M": 8, "texels": 40, "grad": True},
           {"kind": "proposal", "level": 1, "grad": True},
           {"kind": "planes", "n": 40, "S": 4, "M": 32, "texels": 300, "grad": True},
           {"kind": "sigma", "grad": True}, {"kind": "color", "grad": True},
           {"kind": "valid_samples", "n": 20}]
    ops, nbytes = kplanes_fwd.count(log)
    assert ops == 100 * 6 * 72 + 80 * 6 * 72 + 40 * 4 * 6 * 288
    assert nbytes == (16 * 220 + 4 * (100 * 8 + 80 * 8 + 40 * 128) + 4 * (50 * 8 + 40 * 8 + 300 * 32))
    assert kplanes_bwd.count(log) == (ops, nbytes)
    model = {"n_neurons": 64, "multiscales": (1, 2, 4, 8), "feature_dim": 32, "n_hidden_layers_density": 1,
             "geometry_feature_dim": 15, "sh_degree": 4, "n_hidden_layers_color": 2, "proposal_feature_dim": 8,
             "proposal_n_neurons": 64}
    mlp = kplanes_step.mlp_ops(log, model)
    row_p = 2 * (8 * 64 + 64)
    row_f = 2 * (128 * 64 + 64 * 16) + 2 * (31 * 64 + 64 * 64 + 64 * 3)
    assert mlp == int(3 * 0.5 * (100 * row_p + 80 * row_p + 40 * row_f))
    assert kplanes_step.count(log, model, 1000)["least_s"] > 0
    rec = {"check_profile": {"kernel_s": {"void kplanes_fwd_kernel<32, 4>(...)": 2e-3,
                                          "void kplanes_bwd_kernel<8, 1>(...)": 4e-3}},
           "kplanes_fwd_least": (1e-3, "bytes"), "kplanes_bwd_least": (1e-3, "bytes")}
    assert harness.load_module("metrics", "kplanes_fwd_roofline.train").read(rec) == pytest.approx(50.0)
    assert harness.load_module("metrics", "kplanes_bwd_roofline.train").read(rec) == pytest.approx(25.0)
    assert harness.load_module("metrics", "kplanes_fwd_roofline.train").read({}) is None


def test_the_cell_is_in_the_benchmark():
    spec = harness.load_spec()
    cell = {w["name"]: w for w in spec["workloads"]}[CELL]
    assert cell == {**cell, "config": "kplanes-hybrid", "traffic": "train_loop_kplanes", "chips": 1}
    per_layer = {m["name"]: m for m in spec["per_layer"]}
    for name in ("kplanes_fwd_roofline.train", "kplanes_bwd_roofline.train", "step_mfu.train", "slot_fill.train",
                 "optimizer_share.train", "adamw_roofline.train", "device_idle_share.train"):
        assert CELL in per_layer[name]["workloads"], name
    for name in ("field_interp_fwd_roofline.train", "field_interp_bwd_roofline.train", "ray_overflow_share.train"):
        assert CELL not in per_layer[name]["workloads"], name
    json.dumps(spec)
