"""Tiny versions of the benchmark's configurations for the CPU tests: the
cells' flags with small tables and budgets, over a small scene."""
from __future__ import annotations

import copy
import time

import torch

from hrfbench import harness
from hrfbench.run import Context

SCENE = dict(num_cameras=6, width=40, height=40, num_frames=4, grid_resolution=32)


def _set(flags, name, value):
    flags[flags.index(name) + 1] = value


def train_conf(name: str) -> dict:
    """`name`'s configuration at a tiny size: 4 frames (one segment of 6), L4 tables, 256 rays."""
    conf = copy.deepcopy(harness.load_json("configs", name))
    f = conf["flags"]
    i = f.index("--dataset.frame_numbers") + 1
    j = i
    while j < len(f) and not f[j].startswith("--"):
        j += 1
    f[i:j] = ["0", "1", "2", "3"]
    for k, v in [("--model.n_levels", "4"), ("--model.log2_hashmap_size", "12"), ("--model.finest_resolution", "128"),
                 ("--training.rays_initial_batch_size", "256"), ("--dataset.max_buffer_size", "8"),
                 ("--dataset.max_num_frames_per_batch", "2"), ("--tpu.proposal_resolution", "64"),
                 ("--tpu.proposal_rank", "8")]:
        _set(f, k, v)
    if "dense" in f:
        _set(f, "--training.samples_max_batch_size", "16384")
        _set(f, "--tpu.candidate_budget", "32768")
        _set(f, "--tpu.samples_per_ray", "512")
    conf["scene"].update(SCENE)
    conf["segment_sizes"] = [6]
    return conf


def render_conf() -> dict:
    """The render cell's configuration (the checkpoint's model) over a small scene of 50 frames."""
    conf = copy.deepcopy(harness.load_json("configs", "r4-proposal"))
    conf["scene"].update(SCENE, num_frames=50)
    return conf


def traffic(name: str) -> dict:
    t = harness.load_json("traffic", name)
    if name == "train_loop":
        t.update(warmup_steps=1)
    else:
        t.update(trajectory_num_cameras=10, batch_rays=512, warmup_views=1, compare_views=2)
    return t


def context(conf: dict, traffic_name: str, seed: int, seconds: float = 0.5, keep_inputs: bool = False) -> Context:
    torch.set_num_threads(4)
    device = torch.device("cpu")
    scene, _ = harness.ensure_scene(conf["scene"], device)
    return Context("tiny", conf, traffic(traffic_name), seed, seconds, False, device, scene, time.perf_counter(),
                   keep_inputs)
