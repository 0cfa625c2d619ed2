"""`hrfbench/control.py`'s readings for a cell whose traffic runs
`train_loop_routed`, each against the reference with its field routed per
segment (`hrfbench/reference/routed.py`), on the card at the cell's own
size, several seeds in one process:

    python -m hrfbench.control_routed --workload <cell> --seeds <n> <n> ... [--seconds 2]

For each seed `train_loop` runs inside `routed.installed()`, as the routed
driver runs it, and one JSON line gives the numbers of `routed.train_numbers`
of:

- `program`: the port, as the run compares it (a sound run: the lower reading);
- `control`: the reference with its hash tables and 1-D vectors read in
  bfloat16, the precision below the configuration's float32 tables;
- `half_batch`: the reference with half the rays that the loss counts left
  out of it, the mean taken over the rest;
- `skip_unreached`: the reference with an AdamW that leaves the parameters
  whose gradient is all zero as they are (no decay, no moments), as an
  optimizer that updated only the segments a step reaches would.

Each row also gives the worst leaf's update gap of each, beside the median
leaf's that the cell compares. The benchmark's own runs never run this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

KINDS = ("program", "control", "half_batch", "skip_unreached")


def readings_of(cell: str, conf: dict, traffic: dict, seed: int, seconds: float, device) -> dict:
    """The readings of `cell` under `seed`, for a configuration and a
    training traffic mix given as objects, on `device`."""
    import torch

    from hrfbench import harness
    from hrfbench.drivers import train_loop
    from hrfbench.reference import check, pipeline, routed
    from hrfbench.reference.adamw import AdamW
    from hrfbench.run import Context

    class SkipUnreachedAdamW(AdamW):
        def step(self) -> None:
            idle = [i for i, p in enumerate(self.params) if p.grad is None or not p.grad.any()]
            kept = [(self.params[i].clone(), self.mu[i].clone(), self.nu[i].clone()) for i in idle]
            super().step()
            with torch.no_grad():
                for i, state in zip(idle, kept):
                    for t, old in zip((self.params[i], self.mu[i], self.nu[i]), state):
                        t.copy_(old)

    masked_mean = pipeline.masked_mean

    def half_batch_mean(values, mask, group=None):  # the first half of the rows the loss counts
        keep = torch.cumsum(mask.long(), 0) <= mask.sum() // 2
        return masked_mean(values, mask & keep, group)

    scene, _ = harness.ensure_scene(conf["scene"], device)
    ctx = Context(cell, conf, traffic, seed, seconds, False, device, scene, time.perf_counter(), keep_inputs=True)
    with routed.installed():
        record = train_loop.run(ctx)
        inputs = record["inputs"]
        ref, initial = inputs["reference"], inputs["initial"]
        out = {"seed": seed, "program": record["numbers"],
               "worst_update_gap": {"program": record["worst_leaves"]["worst_update_gap"]}}

        def numbers(kind, **kw):
            run = check.train_steps(conf, initial, inputs["steps"], inputs["width"], inputs["height"], device, **kw)
            found, worst = routed.train_numbers(run, ref, initial)
            out["worst_update_gap"][kind] = worst["worst_update_gap"]
            out[kind] = found

        numbers("control", round_tables=True)
        pipeline.masked_mean = half_batch_mean
        try:
            numbers("half_batch")
        finally:
            pipeline.masked_mean = masked_mean
        check.AdamW = SkipUnreachedAdamW
        try:
            numbers("skip_unreached")
        finally:
            check.AdamW = AdamW
    harness.free_device()
    return out


def readings(cell: str, seed: int, seconds: float) -> dict:
    """`readings_of` `cell`'s configuration and traffic on the card."""
    import torch

    from hrfbench import harness

    w = {c["name"]: c for c in harness.load_spec()["workloads"]}[cell]
    return readings_of(cell, harness.load_json("configs", w["config"]), harness.load_json("traffic", w["traffic"]),
                       seed, seconds, torch.device("cuda", 0))


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
    summary = {kind: {k: (max if kind == "program" else min)(r[kind][k] for r in rows) for k in rows[0][kind]}
               for kind in KINDS}
    print(json.dumps({"workload": args.workload, "seeds": args.seeds, "largest program, least control/fault": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
