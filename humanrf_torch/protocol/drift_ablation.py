"""The late-horizon validation drift, by ablation (`scripts/drift_ablation.py`).

The JAX package's 50k-step r4 run peaked at 25.81 dB (step 17,500) and shed
~2.8 dB by step 27,500 under `weight_decay 0.03` (a stability setting tuned
on 2k-step runs). Candidates: (a) weight decay eroding converged tables over
the long horizon, (b) proposal-PDF drift, (c) the lr floor.

Each arm resumes the banked step-17,500 best checkpoint
(`runs_evidence/r4_full_schedule_748/best.ckpt`, written by the JAX package;
the r4 scene is regenerated by the parameter-keyed cache) and trains on
with one knob changed. The original run is not the control: a resume
reshuffles the loader and noise streams, so arm `wd0.03` re-runs the
reference setting through the same resume path, and every other arm differs
from it by one flag (`wd0` resumes the same state under Adam's optimizer
chain, `seed_workspace`):

    wd0.03          — weight_decay 0.03 (the resume cohort's reference)
    wd0             — weight_decay 0    (candidate (a))
    frozen-proposal — proposal_loss_weight 0 (candidate (b))
    lrfloor         — lr_decay 0.1      (candidate (c))

Verdict: an arm whose block at 27,500 is within 0.5 dB of the 25.81 peak
names the driver; wd0.03 drifting like the original run (~−2.3 dB at
27,500) shows the effect is the setting's, not the resume's.

Every arm keeps `--training.max_steps 50000`, so the lr schedule
(0.5^(step / max_steps)) is the original run's; a per-arm wall-clock
deadline cuts each arm (the supervisor's partial-result path), and blocks
land every 2,500 steps wherever the cut falls.

    python -m humanrf_torch.protocol.drift_ablation --arms wd0.03 wd0 [--minutes 80] [--device cpu]

writes each arm under <root>/<arm> and the table to <out> (default
<root>/results.json).
"""
from __future__ import annotations

import argparse
import json
import shutil
import time
from pathlib import Path

from humanrf_torch.protocol import common
from humanrf_torch.protocol.full_schedule import make_scene
from humanrf_torch.protocol.supervisor import BUDGET_RC
from humanrf_torch.protocol.validation_report import block_means, parse_validation_blocks
from humanrf_torch.r4 import r4_flags
from humanrf_torch.run import resolve_device
from humanrf_torch.train.checkpoint import load_checkpoint, save_checkpoint

RESUME_STEP = 17_500
BEST_CKPT = common.R4_RUN / "best.ckpt"

ARMS = {
    # name: CLI flags after the r4 protocol command's
    "wd0.03": [],
    "wd0": ["--training.weight_decay", "0"],
    "frozen-proposal": ["--tpu.proposal_loss_weight", "0"],
    "lrfloor": ["--training.lr_decay", "0.1"],
}


def arm_cmd(name: str, scene: Path, ws: Path, max_steps: int, device: str = "cuda") -> list:
    """The r4 protocol command (full_schedule's, train only), resuming the
    seeded checkpoint, with the arm's flags."""
    return common.cli_command(r4_flags(scene, ws, max_steps, 2500, device) + [
        "--tpu.steps_per_dispatch", "10",
        "--training.checkpoint", "latest",
    ] + ARMS[name])


def turns_decay_off(flags: list) -> bool:
    return "--training.weight_decay" in flags and float(flags[flags.index("--training.weight_decay") + 1]) == 0


def seed_workspace(ws: Path, best: Path = BEST_CKPT, adam: bool = False) -> None:
    """Plant the banked step-17,500 best checkpoint as the resume point.

    The checkpoint is AdamW's (optax's chain: Adam, decayed weights, lr
    schedule), and neither package restores a chain of three states into
    the two of Adam (`--training.weight_decay 0`). With `adam`, the resume
    point drops the chain's middle state, which is empty: the moments and
    the step count carry over unchanged."""
    ckpts = ws / "checkpoints"
    ckpts.mkdir(parents=True, exist_ok=True)
    target = ckpts / f"step_{RESUME_STEP:08d}.ckpt"
    if target.exists():
        return
    if not adam:
        shutil.copyfile(best, target)
        return
    params, opt_state, step, val_step, stats = load_checkpoint(best)
    inner = opt_state["inner_state"]
    if sorted(inner) != ["0", "1", "2"] or inner["1"] != {}:
        raise ValueError(f"{best} does not hold AdamW's optimizer state (chained states {sorted(inner)})")
    save_checkpoint(target, params, {**opt_state, "inner_state": {"0": inner["0"], "1": inner["2"]}}, step,
                    val_step, stats)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arms", nargs="+", default=["wd0.03", "wd0"], choices=list(ARMS))
    ap.add_argument("--minutes", type=float, default=80.0,
                    help="wall-clock budget per arm (cuts the run); the lr horizon stays the full 50k schedule")
    ap.add_argument("--root", type=Path, default=common.RUNS / "drift_ablation")
    ap.add_argument("--scene-root", type=Path, default=common.RUNS / "full_schedule")
    ap.add_argument("--out", type=Path, default=None, help="default <root>/results.json")
    ap.add_argument("--best", type=Path, default=BEST_CKPT, help="the step-17,500 checkpoint to resume")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    out = args.out or args.root / "results.json"

    scene = args.scene_root / "scene"
    # full_schedule's cache key: reuse its 748² × 50-frame scene. The
    # workspace there is not a stale dir: it may hold a run of its own.
    if common.ensure_scene(scene, {"size": 748, "frames": 50},
                           lambda root: make_scene(root, 50, 748, 748, args.device)):
        print("# regenerated the 748² x 50-frame scene", flush=True)
    if not args.best.exists():
        raise SystemExit(f"missing resume checkpoint {args.best}")

    results = []
    for name in args.arms:
        ws = args.root / name
        seed_workspace(ws, args.best, adam=turns_decay_off(ARMS[name]))
        cmd = arm_cmd(name, scene, ws, 50_000, args.device)  # the full lr horizon; the deadline cuts
        deadline = time.time() + args.minutes * 60.0
        print(f"# arm {name}: resume {RESUME_STEP}, {args.minutes:.0f} min budget", flush=True)
        t0 = time.time()
        rc, restarts = common.supervise_cli(cmd, ws / "driver.log", args.device, stall_timeout=1500.0,
                                            max_restarts=4, deadline=deadline)
        r = {"name": name, "rc": rc, "restarts": restarts, "wall_s": round(time.time() - t0, 1),
             "partial": rc == BUDGET_RC, "validation_blocks": block_means(parse_validation_blocks(ws))}
        results.append(r)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=2))
        print(json.dumps(r), flush=True)

    print("\n| arm | blocks (step: mean PSNR) |")
    print("|---|---|")
    for r in results:
        print(f"| {r['name']} | " + " ".join(f"{b['step']}:{b['psnr']:.2f}" for b in r["validation_blocks"]) + " |")
    return results


if __name__ == "__main__":
    main()
