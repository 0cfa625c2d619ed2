"""Training throughput at the 748² protocol shape (`scripts/throughput_probe.py`).

Resumes the banked step-50,000 checkpoint of the JAX package's r4 run on the
r4 scene and trains 2,000 more steps with validation and checkpoints pushed
out of the window, so the trainer's 500-step log lines measure the train
loop alone at the protocol shape (8,192-ray batches, [25, 25] segments,
frame-window batches).

    python -m humanrf_torch.protocol.throughput_probe [--steps 2000] [--root protocol_runs/tput_probe] [--device cpu]

reads the scene of `full_schedule` (<scene-root>/scene, written if absent),
runs under <root>/ws and writes the summary to <root>/results.json.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
from pathlib import Path

from humanrf_torch.protocol import common
from humanrf_torch.protocol.full_schedule import make_scene
from humanrf_torch.r4 import r4_flags
from humanrf_torch.run import resolve_device

CKPT = common.R4_RUN / "step_00050000.ckpt"
RESUME_STEP = 50_000


def command(scene: Path, ws: Path, steps: int, device: str = "cuda") -> list:
    big = 10_000_000  # validation and saves out of the window
    return common.cli_command(r4_flags(scene, ws, RESUME_STEP + steps, big, device) + [
        "--tpu.steps_per_dispatch", "10",
        "--training.checkpoint", "latest",
    ])


def read_log(text: str) -> dict:
    """The 500-step windows' nominal and supervised rays/s and fetch shares,
    and the run's ms per step (20-step windows, pauses excluded)."""
    rates, supervised, fetches = [], [], []
    for line in text.splitlines():
        m = re.search(r"step (\d+):.* rays/s=(\d+) supervised_rays/s=(\d+) \[fetch (\d+)%", line)
        if m and int(m.group(1)) > RESUME_STEP:
            rates.append(int(m.group(2)))
            supervised.append(int(m.group(3)))
            fetches.append(int(m.group(4)))
    timed = re.search(r"train: (\d+) steps timed.*?: ([\d.]+) ms per step, (\d+) rays/s", text)
    return {"rates": rates, "supervised_rates": supervised, "fetch_pct": fetches,
            "ms_per_step": float(timed.group(2)) if timed else None,
            "rays_per_s": int(timed.group(3)) if timed else None}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--root", type=Path, default=common.RUNS / "tput_probe")
    ap.add_argument("--scene-root", type=Path, default=common.RUNS / "full_schedule")
    ap.add_argument("--ckpt", type=Path, default=CKPT, help="the step-50,000 checkpoint to resume")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)

    scene = args.scene_root / "scene"
    common.ensure_scene(scene, {"size": 748, "frames": 50}, lambda root: make_scene(root, 50, 748, 748, args.device))
    ws = args.root / "ws"
    ckpts = ws / "checkpoints"
    ckpts.mkdir(parents=True, exist_ok=True)
    target = ckpts / args.ckpt.name
    if not target.exists():
        shutil.copyfile(args.ckpt, target)

    cmd = command(scene, ws, args.steps, args.device)
    log = ws / "driver.log"
    log.unlink(missing_ok=True)
    print("# launching:", " ".join(cmd), flush=True)
    rc, _ = common.supervise_cli(cmd, log, args.device, max_restarts=0)
    result = {"rc": rc, **read_log(log.read_text())}
    rates = result["rates"]
    print(f"rc={rc} windows={len(rates)} rates={rates} fetch%={result['fetch_pct']}")
    if rates:
        steady = rates[1:] or rates  # the first window holds the resume's start-up
        result["steady_rays_per_s"] = sum(steady) / len(steady)
        print(f"steady rays/s: mean={result['steady_rays_per_s']:.0f} max={max(steady)}")
    (args.root / "results.json").write_text(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
