"""The readings that the limits of `hrfbench/limits/<cell>.json` are set
from, on the card at the cell's own size, several seeds in one process:

    python -m hrfbench.control --workload <cell> --seeds <n> <n> ... [--seconds 2]

For each seed the cell's driver runs as a benchmark run does (set-up, the
check steps or a short window, the reference), and prints one JSON line of
numbers, each compared with the reference's:

- `program`: the port, as the run compares it (a sound run: the lower reading);
- `control`: the reference itself with its hash tables and 1-D vectors read
  in bfloat16, the precision below the configuration's float32 tables;
- `half_batch` (training): the reference with half the rays that the loss
  counts left out of it, the mean taken over the rest.

A step that returns its state unchanged reads about 1 by the update gap's
measure and needs no run. Training rows also give the worst leaf's update
gap of each, beside the median leaf's that the cell compares. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time


def readings(cell: str, seed: int, seconds: float) -> dict:
    """The readings of `cell` under `seed` on the card (see the module docstring)."""
    import torch

    from hrfbench import harness

    w = {c["name"]: c for c in harness.load_spec()["workloads"]}[cell]
    return readings_of(cell, harness.load_json("configs", w["config"]), harness.load_json("traffic", w["traffic"]),
                       seed, seconds, torch.device("cuda", 0))


def readings_of(cell: str, conf: dict, traffic: dict, seed: int, seconds: float, device) -> dict:
    """`readings` for a configuration and a traffic mix given as objects, on `device`."""
    import torch

    from hrfbench import harness
    from hrfbench.reference import check, pipeline
    from hrfbench.run import Context

    scene, _ = harness.ensure_scene(conf["scene"], device)
    ctx = Context(cell, conf, traffic, seed, seconds, False, device, scene, time.perf_counter(), keep_inputs=True)
    record = importlib.import_module(f"hrfbench.drivers.{traffic['driver']}").run(ctx)
    inputs = record["inputs"]
    out = {"seed": seed, "program": record["numbers"]}
    if traffic["driver"] == "train_loop":
        ref, initial = inputs["reference"], inputs["initial"]
        out["worst_update_gap"] = {"program": record["worst_leaves"]["worst_update_gap"]}

        def numbers(kind, **kw):
            run = check.train_steps(conf, initial, inputs["steps"], inputs["width"], inputs["height"], device, **kw)
            found, worst = check.train_numbers(run, ref, initial)
            out["worst_update_gap"][kind] = worst["worst_update_gap"]
            return found

        out["control"] = numbers("control", round_tables=True)
        masked_mean = pipeline.masked_mean

        def half_batch_mean(values, mask, group=None):  # the first half of the rows the loss counts
            keep = torch.cumsum(mask.long(), 0) <= mask.sum() // 2
            return masked_mean(values, mask & keep, group)

        pipeline.masked_mean = half_batch_mean
        try:
            out["half_batch"] = numbers("half_batch")
        finally:
            pipeline.masked_mean = masked_mean
    else:
        from hrfbench.drivers.render_trajectory import view_numbers

        state = check.load_checkpoint_state(harness.ROOT / conf["checkpoint"])
        model = check.build_model(conf, state, device, round_tables=True)
        low = [check.render_view(conf, model, inputs["scene"], cam, frame, inputs["batch_rays"], inputs["width"],
                                 inputs["height"], device, block_rays=inputs["batch_rays"])
               for cam, frame in inputs["views"]]
        out["control"] = view_numbers(low, inputs["reference"])
    harness.free_device()
    return out


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
    summary = {}
    for kind in ("program", "control", "half_batch"):
        if kind in rows[0]:
            pick = max if kind == "program" else min
            summary[kind] = {k: pick(r[kind][k] for r in rows) for k in rows[0][kind]}
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "largest program, least control/fault": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
