"""Chained protocol runs (`scripts/protocol_chain.sh`), each under its deadline:

1. the 384² × 25-frame quality-at-capacity sweep: the fused flagship
   against the reference-capacity control, 5k steps, adaptive segments;
2. the 748² × 50-frame reference schedule (50k steps).

Both go through the supervisor: they wait for the card, restart wedged
children (checkpoint resume), and stop at their deadline with a partial but
resumable result. Scenes are cached by their (size, frames) stamps.

    python -m humanrf_torch.protocol.chain <sweep_deadline_epoch> <schedule_deadline_epoch> [--device cpu]
"""
from __future__ import annotations

import argparse
import time

from humanrf_torch.protocol import common, full_schedule, quality_at_capacity


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("sweep_deadline", type=float, help="epoch seconds")
    ap.add_argument("schedule_deadline", type=float, help="epoch seconds")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    print(f"# chain start {time.ctime()}", flush=True)
    root = common.RUNS / "quality_sweep_384"
    quality_at_capacity.main([
        "--size", "384", "--frames", "25", "--steps", "5000", "--chunk", "10",
        "--root", str(root), "--out", str(root / "results.json"),
        "--only", "fused-flagship", "gather-ref-capacity",
        "--deadline-epoch", str(args.sweep_deadline), "--device", args.device,
    ])
    print(f"# sweep done {time.ctime()}; launching the full-schedule run", flush=True)
    full_schedule.main(["--deadline-epoch", str(args.schedule_deadline), "--device", args.device])
    print(f"# chain done {time.ctime()}", flush=True)


if __name__ == "__main__":
    main()
