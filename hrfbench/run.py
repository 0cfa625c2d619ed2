"""Run one cell of the benchmark of `humanrf_torch` once, on the card.

    python -m hrfbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of `workloads` in BENCHMARK.json) names a configuration
(`hrfbench/configs/<name>.json`) and a traffic mix (`hrfbench/traffic/
<name>.json`), whose `driver` (`hrfbench/drivers/<driver>.py`) builds the
port's program through its normal path, warms it up (set-up), measures it
for `--seconds`, and has the reference check what the measured path
produced. With `--trace 0` the result carries the cell's end-to-end metrics;
with `--trace 1` its per-layer metrics, each read from the run's record by
`hrfbench/metrics/<name>.py`. Each number compared with the reference is
held to its limit in `hrfbench/limits/<cell>.json`.

The last line of standard output is the result, one JSON object; the lines
before the last on standard error give each number compared beside its
limit. Without a CUDA card, or with fewer than the cell asks for, or when
the process holds JAX or the JAX package after the window, the run exits
with a code other than 0 and prints no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402

# Keep CUPTI set up between profiler windows of a process that replays CUDA
# graphs (PyTorch's own workaround); read when torch is imported.
os.environ.setdefault("TEARDOWN_CUPTI", "0")


@dataclass
class Context:
    """What a driver gets: the cell's files, the run's arguments and the scene."""

    cell: str
    conf: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: object  # torch.device
    scene: Path
    t_start: float
    keep_inputs: bool = False  # the driver keeps the reference's inputs in the record


def power_limit_w():
    """The card's power limit in watts as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def judge(numbers: dict, limits: dict) -> tuple:
    """The numbers compared against their limits → (correct, {name: {"value", "limit"}})."""
    from hrfbench import harness

    if set(numbers) != set(limits):
        raise harness.CheckFailed(f"the run compared {sorted(numbers)} but the limits are {sorted(limits)}")
    checks = {name: {"value": numbers[name], "limit": limits[name]} for name in sorted(numbers)}
    return all(c["value"] <= c["limit"] for c in checks.values()), checks


def measure(spec: dict, cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """Run `cell` once on `device` → the result object (without `checks`
    printed): correct, attempted, failed, metrics, device, breakdown, checks."""
    import torch

    from hrfbench import harness

    conf = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    limits = harness.load_json("limits", cell["name"])
    driver = importlib.import_module(f"hrfbench.drivers.{traffic['driver']}")
    scene, write_s = harness.ensure_scene(conf["scene"], device)
    if write_s:
        print(f"[hrfbench] scene written into the cache in {write_s:.3f} s (first run of this checkout)", flush=True)
    ctx = Context(cell["name"], conf, traffic, seed, seconds, trace, torch.device(device), scene, t_start)
    record = driver.run(ctx)

    correct, checks = judge(record["numbers"], limits)

    metrics = {}
    if trace:
        for m in harness.cell_metrics(spec, cell["name"], "per_layer"):
            value = harness.load_module("metrics", m["name"]).read(record)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in harness.cell_metrics(spec, cell["name"], "end_to_end"):
            metrics[m["name"]] = {"value": record["end_to_end"][m["name"]], "unit": m["unit"]}

    dev = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
           "kind": torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": record["memory_peak_bytes"]}
    if ctx.device.type == "cuda":
        dev["power_limit_w"] = power_limit_w()
    result = {"correct": correct, "attempted": record["attempted"], "failed": record["failed"], "metrics": metrics,
              "device": dev}
    if trace and "profile" in record:
        p = record["profile"]
        dev.update(busy_s=p["busy_s"], window_s=p["window_s"])
        result["breakdown"] = {"device_ops": p["device_ops"], "idle_gaps": p["idle_gaps"]}
    detail = {k: record[k] for k in ("window_s", "setup_s", "memory_peak_bytes", "losses", "compared_views",
                                     "worst_leaves", "steps", "views", "step_work", "view_work",
                                     "field_interp_fwd_least", "field_interp_bwd_least") if k in record}
    print("[hrfbench] " + json.dumps(detail), flush=True)
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from hrfbench import harness

    spec = harness.load_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"[hrfbench] no workload {args.workload!r} in BENCHMARK.json ({sorted(cells)})", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    try:
        import humanrf_torch  # noqa: F401
        import torch
    except ImportError as e:
        print(f"[hrfbench] the program is missing: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"[hrfbench] {args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 3
    result = measure(spec, cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"[hrfbench] the process holds JAX or the JAX package: {found}", file=sys.stderr)
        return 4
    for name, c in result["checks"].items():
        print(f"[hrfbench] check {name} = {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
