"""Finish the protocol's phases from a schedule run's workspace
(`scripts/finish_phases.py`).

The protocol is train → trajectory render → evaluate. When a wall-clock
budget stops training early (partial but resumable, `full_schedule`), this
completes the other phases from the workspace's best checkpoint without
training:

  1. evaluate: render the held-out test camera at siggraph_test coverage and
     write metrics.csv / averages.csv, first, so that a further cut still
     leaves the metrics;
  2. trajectory: the calibration file's ping-pong novel-view render.

    python -m humanrf_torch.protocol.finish_phases [--root protocol_runs/full_schedule]
        [--deadline-epoch E] [--skip-trajectory] [--device cpu]

reads <root>/scene and <root>/workspace/checkpoints/best.ckpt, writes into
<root>/workspace/results and the summary to <root>/phases_result.json.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from humanrf_torch.protocol import common
from humanrf_torch.protocol.supervisor import BUDGET_RC
from humanrf_torch.r4 import R4_MODEL_FLAGS
from humanrf_torch.run import resolve_device


def base_cmd(scene: Path, ws: Path, frames: int, device: str = "cuda") -> list:
    """The phases' command without a phase: the model and sampler flags must
    be the training run's (the checkpoint is that model's)."""
    return common.cli_command([
        "--config", "example_synthetic",
        "--dataset.path", str(scene),
        "--workspace", str(ws),
        "--device", device,
        *R4_MODEL_FLAGS,
        "--train", "false",
        "--test.checkpoint", "best",
        "--dataset.frame_numbers", *[str(i) for i in range(frames)],
    ])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=common.RUNS / "full_schedule")
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--deadline-epoch", type=float, default=None)
    ap.add_argument("--skip-trajectory", action="store_true")
    ap.add_argument("--stall-timeout", type=float, default=1200.0)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    scene = args.root / "scene"
    ws = args.root / "workspace"
    if not (ws / "checkpoints").exists():
        raise SystemExit(f"no checkpoints under {ws}")
    log = ws / "phases.log"
    base = base_cmd(scene, ws, args.frames, args.device)
    result = {}

    t0 = time.time()
    eval_cmd = base + ["--evaluate", "true"]
    print("# phase 1/2 (evaluate):", " ".join(eval_cmd), flush=True)
    rc, restarts = common.supervise_cli(eval_cmd, log, args.device, stall_timeout=args.stall_timeout,
                                        max_restarts=4, deadline=args.deadline_epoch)
    result["evaluate"] = {"rc": rc, "wall_s": round(time.time() - t0, 1), "restarts": restarts}
    averages = ws / "results" / "averages.csv"
    if averages.exists():
        result["averages_csv"] = averages.read_text().strip().splitlines()

    if not args.skip_trajectory and rc == 0:
        t1 = time.time()
        traj_cmd = base + [
            "--evaluate", "false",
            "--test.trajectory_via_calibration_file",
            str(scene / "SynthActor" / "Sequence1" / "1x" / "calibration.csv"),
        ]
        print("# phase 2/2 (trajectory):", " ".join(traj_cmd), flush=True)
        rc2, restarts2 = common.supervise_cli(traj_cmd, log, args.device, stall_timeout=args.stall_timeout,
                                              max_restarts=4, deadline=args.deadline_epoch)
        traj_dir = ws / "results" / "test_calibration_file"
        result["trajectory"] = {
            "rc": rc2, "wall_s": round(time.time() - t1, 1), "restarts": restarts2,
            "n_images": len(list(traj_dir.glob("*.png"))) if traj_dir.exists() else 0,
        }

    result["partial"] = any(v.get("rc") == BUDGET_RC for v in result.values() if isinstance(v, dict))
    (args.root / "phases_result.json").write_text(json.dumps(result, indent=2))
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
