"""The readings that the limits of a K-Planes cell
(`hrfbench/limits/kplanes-hybrid.train.json`) are set from, on the card at
the cell's own size, several seeds in one process:

    python -m hrfbench.control_kplanes --workload kplanes-hybrid.train --seeds <n> <n> ... [--seconds 2]

For each seed the cell's driver (`drivers/train_loop_kplanes.py`) runs as a
benchmark run does and prints one JSON line of numbers, each compared with
the reference's (`reference/kplanes.py`):

- `program`: the port, as the run compares it;
- `control`: the reference with its planes read in bfloat16, the precision
  below the configuration's float32 planes;
- `half_batch`: the reference with half the rays that the loss counts left
  out of each mean, the mean taken over the rest;
- `ulp`: the reference from the same state with every plane entry moved
  one float32 ulp up: what rounding alone, a summation order's worth,
  gives once the bf16 MLPs have rounded it.

Each row also gives the worst leaf's update gap and, for every kind, the
verdict of the cell's limits (`hrfbench/limits/<cell>.json`, judged as a
benchmark run judges them) with the numbers above their limit; the last
line counts, per kind, the seeds it failed. A step that returns its state
unchanged reads about 1 by the update gap's measure and needs no run. The
benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time


@contextlib.contextmanager
def half_batch():
    """The reference's loss means over the first half of the rows they count."""
    import torch

    from hrfbench.reference import kplanes

    masked_mean = kplanes.masked_mean

    def first_half(values, mask, group=None):
        keep = torch.cumsum(mask.long(), 0) <= mask.sum() // 2
        return masked_mean(values, mask & keep, group)

    kplanes.masked_mean = first_half
    try:
        yield
    finally:
        kplanes.masked_mean = masked_mean


def readings(cell: str, seed: int, seconds: float) -> dict:
    """The readings of `cell` under `seed` on the card (see the module docstring)."""
    import torch

    from hrfbench import harness
    from hrfbench.drivers import train_loop_kplanes
    from hrfbench.reference import kplanes
    from hrfbench.reference.check import train_numbers
    from hrfbench.run import Context, judge

    w = {c["name"]: c for c in harness.load_spec()["workloads"]}[cell]
    conf, traffic = harness.load_json("configs", w["config"]), harness.load_json("traffic", w["traffic"])
    device = torch.device("cuda", 0)
    scene, _ = harness.ensure_scene(conf["scene"], device)
    ctx = Context(cell, conf, traffic, seed, seconds, False, device, scene, time.perf_counter(), keep_inputs=True)
    record = train_loop_kplanes.run(ctx)
    inputs = record["inputs"]
    out = {"seed": seed, "program": record["numbers"],
           "worst_update_gap": {"program": record["worst_leaves"]["worst_update_gap"]}}

    def numbers(kind, initial=None, **kw):
        run = kplanes.train_steps(conf, initial or inputs["initial"], inputs["steps"], inputs["width"],
                                  inputs["height"], device, **kw)
        found, worst = train_numbers(run, inputs["reference"], inputs["initial"])
        out["worst_update_gap"][kind] = worst["worst_update_gap"]
        return found

    out["control"] = numbers("control", round_planes=True)
    with half_batch():
        out["half_batch"] = numbers("half_batch")
    out["ulp"] = numbers("ulp", initial=one_ulp_up(inputs["initial"]))
    limits = harness.load_json("limits", cell)
    out["verdict"] = {}
    for kind in KINDS:
        correct, checks = judge(out[kind], {k: limits[k] for k in out[kind]})
        out["verdict"][kind] = {"correct": correct,
                                "failed": sorted(k for k, c in checks.items() if c["value"] > c["limit"])}
    harness.free_device()
    return out


KINDS = ("program", "control", "half_batch", "ulp")


def one_ulp_up(state: dict) -> dict:
    """`state` with every plane entry (the leaves under `scales`) moved to
    the next float32 above it."""
    import torch

    return {n: torch.nextafter(t, torch.full_like(t, float("inf"))) if ".scales." in f".{n}" else t
            for n, t in state.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    rows = []
    for seed in args.seeds:
        rows.append(readings(args.workload, seed, args.seconds))
        print("[control] " + json.dumps(rows[-1]), flush=True)
    summary, failed = {}, {}
    for kind in KINDS:
        pick = min if kind in ("control", "half_batch") else max
        summary[kind] = {k: pick(r[kind][k] for r in rows) for k in rows[0][kind]}
        failed[kind] = sum(not r["verdict"][kind]["correct"] for r in rows)
    print(json.dumps({"workload": args.workload, "seeds": args.seeds,
                      "largest program and ulp, least control and fault": summary, "seeds failed": failed}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
