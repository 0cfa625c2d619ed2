"""What every driver of the benchmark shares: the benchmark's files by name,
the scene cache, the weights made from the seed, the port's configuration
checked against the reference's, the profiler's reading, and the module check.
"""
from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import os
import shutil
import sys
from pathlib import Path
from typing import Dict, List

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
CACHE_DIR = BENCH_DIR / "cache"  # git-ignored; the scene and nothing else

# Top-level module names the port's process may not hold (whole names: the
# port's own name begins with the JAX package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "humanrf_tpu")

# Seconds between a profiler window's start and its work: the profiler keeps
# only the device activities it places inside its window.
PROFILE_LEAD_S = 0.1


class CheckFailed(RuntimeError):
    """The run cannot be measured as asked (wrong inputs, a trace that does not hold the steps)."""


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str) -> dict:
    """`hrfbench/<kind>/<name>.json`: a configuration or a traffic mix."""
    return json.loads((BENCH_DIR / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """`hrfbench/<kind>/<name>.py`, loaded by path (a metric's name may hold dots)."""
    path = BENCH_DIR / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"hrfbench.{kind}.{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(spec: dict, cell: str, section: str) -> List[dict]:
    """The metrics of `section` ("end_to_end" or "per_layer") that `cell` reports."""
    return [m for m in spec[section] if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)


# --------------------------------------------------------------- the scene


def ensure_scene(params: dict, device) -> tuple:
    """The scene of `params` (a configuration's `scene`) in the cache, written
    on the first run of a checkout → (root, seconds spent writing it, 0 on a hit).
    The directory's name is the hash of the parameters; a finished scene
    holds `done`."""
    from hrfbench.scene.generate import generate, scene_config

    key = hashlib.sha256(json.dumps(params, sort_keys=True).encode()).hexdigest()[:16]
    root = CACHE_DIR / f"scene-{key}"
    if (root / "done").exists():
        return root, 0.0
    import time

    t0 = time.perf_counter()
    partial = CACHE_DIR / f"scene-{key}.partial"
    shutil.rmtree(partial, ignore_errors=True)
    generate(partial, scene_config(params), device)
    (partial / "done").write_text(json.dumps(params, sort_keys=True))
    shutil.rmtree(root, ignore_errors=True)
    os.replace(partial, root)
    return root, time.perf_counter() - t0


# ------------------------------------------------------------- the weights


def _normal_scale(name: str, shape) -> float:
    """The std of a normal leaf, as the port's models draw them: He for the
    MLPs (√(2/din)), 0.1 for the vectors, 0.3 for the proposal factors, 1 for
    the camera embeddings."""
    if ".w" in name and ("sigma_net" in name or "color_net" in name):
        return (2.0 / shape[0]) ** 0.5
    if name.endswith(".vectors"):
        return 0.1
    if name.endswith(".factors"):
        return 0.3
    if name == "camera_embeddings":
        return 1.0
    raise ValueError(f"no distribution for parameter {name}")


def make_weights(named_shapes: Dict[str, tuple], seed: int, device) -> Dict[str, "torch.Tensor"]:
    """Fresh weights from `seed`, drawn on `device` in two calls: the hash
    tables U[-1e-4, 1e-4], every other leaf normal at its scale."""
    import math

    import torch

    tables = [n for n in named_shapes if n.split(".")[-1] in ("xyz", "xyt", "yzt", "xzt")]
    others = [n for n in named_shapes if n not in tables]
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    size = lambda names: sum(math.prod(named_shapes[n]) for n in names)  # noqa: E731
    u = torch.rand(size(tables), generator=gen, device=device) * 2e-4 - 1e-4
    z = torch.randn(size(others), generator=gen, device=device)
    out, pos = {}, {"u": 0, "z": 0}
    for names, buf, tag in ((tables, u, "u"), (others, z, "z")):
        for n in names:
            k = math.prod(named_shapes[n])
            leaf = buf[pos[tag]:pos[tag] + k].reshape(named_shapes[n])
            out[n] = leaf if tag == "u" else leaf * _normal_scale(n, named_shapes[n])
            pos[tag] += k
    return out


def check_config(program_model_cfg, program_pcfg, conf: dict) -> None:
    """Raise unless the port built the field and the sampler that the
    configuration file states, as the reference reads them."""
    from hrfbench.reference.check import model_config, pipeline_config

    pairs = ((dataclasses.asdict(program_model_cfg), dataclasses.asdict(model_config(conf))),
             (dataclasses.asdict(program_pcfg), dataclasses.asdict(pipeline_config(conf))))
    for program, reference in pairs:
        diff = {k: (program.get(k), v) for k, v in reference.items() if program.get(k) != v}
        if diff:
            raise CheckFailed(f"the port runs another configuration than the file states (port, file): {diff}")


# ------------------------------------------------------------ the profiler


def profile_summary(prof, wall_s: float) -> dict:
    """A torch.profiler window → {"busy_s": seconds in which an operation ran
    on the device (the union of its activities), "span_s": first start to
    last end, "window_s": `wall_s`, "kernel_s": {name: summed seconds},
    "device_ops": the 10 largest [name, seconds], "idle_gaps": the 10
    longest [what the host was doing, seconds]}."""
    import torch

    events = list(prof.events())
    # The harness's own spans (`hrfbench.*`) also appear on the device's
    # timeline, as annotations: they are no operation.
    device = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.name.startswith("hrfbench.")), key=lambda e: e.time_range.start)
    if not device:
        raise CheckFailed("torch.profiler saw no device activity in its window")
    kernel_us: Dict[str, float] = {}
    merged = []
    for e in device:
        kernel_us[e.name] = kernel_us.get(e.name, 0.0) + e.time_range.elapsed_us()
        start, end = e.time_range.start, e.time_range.end
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    spans = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU and e.name.startswith("hrfbench.")]
    gaps = []
    for (_, a), (b, _) in zip(merged, merged[1:]):
        mid = 0.5 * (a + b)
        host = [s.name for s in spans if s.time_range.start <= mid <= s.time_range.end]
        gaps.append([host[-1][len("hrfbench."):] if host else "other", (b - a) / 1e6])
    gaps.sort(key=lambda g: -g[1])
    ops = sorted(([k, v / 1e6] for k, v in kernel_us.items()), key=lambda o: -o[1])
    return {
        "busy_s": sum(b - a for a, b in merged) / 1e6,
        "span_s": (merged[-1][1] - merged[0][0]) / 1e6,
        "window_s": wall_s,
        "kernel_s": {k: v / 1e6 for k, v in kernel_us.items()},
        "device_ops": ops[:10],
        "idle_gaps": gaps[:10],
    }


def check_span(summary: dict, events_s: float) -> None:
    """Raise unless the profiled device activities span 0.7-1.3× the CUDA
    events' time of the same work: else the trace does not hold it whole."""
    if not 0.7 * events_s <= summary["span_s"] <= 1.3 * events_s:
        raise CheckFailed(f"the profiler's device activities span {summary['span_s']:.6f} s against "
                          f"{events_s:.6f} s by CUDA events: the trace does not hold the profiled work")


def kernel_seconds(summary: dict, pattern: str) -> float:
    """Summed seconds of the profiled kernels whose name holds `pattern`."""
    return sum(v for k, v in summary["kernel_s"].items() if pattern in k)


def open_profile():
    """Open a torch.profiler window (CPU and CUDA) → (profiler, its start),
    `PROFILE_LEAD_S` before the work that follows."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    time.sleep(PROFILE_LEAD_S)
    start = torch.cuda.Event(enable_timing=True)
    start.record()
    return prof, (start, time.perf_counter())


def close_profile(prof, opened, units: int) -> dict:
    """Close the window after `units` steps or views → `profile_summary`,
    checked by `check_span`, with "units"."""
    import time

    import torch

    start, t0 = opened
    end = torch.cuda.Event(enable_timing=True)
    end.record()
    torch.cuda.synchronize()  # the profiler traces the card only
    wall = time.perf_counter() - t0
    prof.__exit__(None, None, None)
    summary = profile_summary(prof, wall)
    check_span(summary, start.elapsed_time(end) / 1e3)
    summary["units"] = units
    return summary


def free_device() -> None:
    """Drop what the program left on the device (its state must be unreferenced)."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


def sync(device) -> None:
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def peak_bytes(device) -> int:
    """The device's peak allocated memory (0 off the card)."""
    import torch

    return torch.cuda.max_memory_allocated(device) if torch.device(device).type == "cuda" else 0
