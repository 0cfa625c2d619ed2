"""The full reference schedule on the r4 scene (`scripts/full_schedule_run.py`).

Runs the reference protocol end to end through the port's CLI on the r4
scene (`humanrf_torch/r4.py`: 748², 12 cameras, 50 frames whose motion
gives adaptive segments [25, 25]): 50,000 steps with validation and
checkpoints every 2,500, best-checkpoint selection, the trajectory render
and the evaluate phase (metrics.csv, averages.csv). The model and sampler
are the r4 command's (L8/F4, T = 2048 per segment, proposal Kc = 32 →
Kf = 16 from 2× candidate rays); `--dense` appends `r4.PAPER_DENSE_FLAGS`,
the paper's field and sampler.

    python -m humanrf_torch.protocol.full_schedule [--steps 50000] [--root protocol_runs/full_schedule]
        [--dense] [--extra "<CLI flags>"] [--device cpu]

writes the scene under <root>/scene, the run under <root>/workspace and
the summary to <root>/result.json.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from humanrf_torch.core.dataset import VolumetricDataset
from humanrf_torch.protocol import common
from humanrf_torch.protocol.supervisor import BUDGET_RC
from humanrf_torch.protocol.validation_report import block_means, parse_validation_blocks
from humanrf_torch.r4 import PAPER_DENSE_FLAGS, r4_flags
from humanrf_torch.run import resolve_device
from humanrf_torch.train.partitioning import compute_adaptive_segment_sizes


def make_scene(root: Path, num_frames: int, width: int, height: int, device: str = "cuda") -> None:
    """The r4 scene at width × height over `num_frames` frames: the centre
    travels 0.16 in z, so at 50 frames adaptive partitioning emits [25, 25]."""
    common.write_scene(root, common.detail_scene(width, height, num_frames, 0.16), device)


def check_segments(scene: Path, num_frames: int) -> list:
    ds = VolumetricDataset(scene / "SynthActor" / "Sequence1" / "1x")
    return compute_adaptive_segment_sizes(ds, list(range(num_frames)))


def command(args, scene: Path, ws: Path) -> list:
    """The CLI command of the run: the r4 flags with the schedule's steps,
    validation and saves, resumable, then `--dense`'s and `--extra`'s."""
    flags = r4_flags(scene, ws, args.steps, args.validate_every, args.device) + [
        "--tpu.steps_per_dispatch", str(args.steps_per_dispatch),
        "--training.rays_initial_batch_size", str(args.rays),
        "--training.checkpoint", "latest",  # resumable
        "--dataset.frame_numbers", *[str(i) for i in range(args.frames)],
    ]
    if args.dense:
        flags += PAPER_DENSE_FLAGS
    if not args.smoke:
        # The trajectory render and the evaluation phase (best checkpoint).
        flags += [
            "--test.trajectory_via_calibration_file",
            str(scene / "SynthActor" / "Sequence1" / "1x" / "calibration.csv"),
            "--evaluate", "true",
        ]
    return common.cli_command(flags + args.extra.split())


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    # 50,000 = the reference's 50,001 rounded to a steps_per_dispatch multiple;
    # the protocol's last validation and checkpoint land at step 50,000.
    ap.add_argument("--steps", type=int, default=50_000)
    ap.add_argument("--root", type=Path, default=common.RUNS / "full_schedule")
    ap.add_argument("--frames", type=int, default=50)
    ap.add_argument("--size", type=int, default=748)
    ap.add_argument("--rays", type=int, default=8192)  # the reference default (args/run_args.py:27)
    ap.add_argument("--steps-per-dispatch", type=int, default=10)
    ap.add_argument("--validate-every", type=int, default=2500)
    ap.add_argument("--scene-only", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="train and validate only: skip the trajectory and evaluate phases")
    ap.add_argument("--dense", action="store_true", help="append r4.PAPER_DENSE_FLAGS (the paper's field and sampler)")
    ap.add_argument("--extra", type=str, default="",
                    help="more CLI flags, one whitespace-split string, after the protocol's")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--stall-timeout", type=float, default=1500.0,
                    help="seconds of zero log growth before the child is declared wedged")
    ap.add_argument("--max-restarts", type=int, default=12)
    ap.add_argument("--deadline-epoch", type=float, default=None,
                    help="absolute wall-clock budget (epoch seconds); on expiry the child is stopped, result.json "
                         "carries partial=true and the validation blocks so far, and the run stays resumable")
    return ap


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    resolve_device(args.device)
    scene = args.root / "scene"
    t0 = time.time()
    # Cached on the scene's parameters; a new scene also clears the
    # workspace, whose `--training.checkpoint latest` state belongs to the
    # old one.
    if common.ensure_scene(
        scene,
        {"size": args.size, "frames": args.frames},
        lambda root: make_scene(root, args.frames, args.size, args.size, args.device),
        stale_dirs=(args.root / "workspace",),
    ):
        print(f"# generated {args.size}^2 x {args.frames}-frame scene in {time.time() - t0:.0f}s", flush=True)

    sizes = check_segments(scene, args.frames)
    print(f"# adaptive segment sizes: {sizes}", flush=True)
    if len(sizes) < 2:
        raise SystemExit(f"scene motion too small for multi-segment partitioning: {sizes}")
    if args.scene_only:
        return {"segment_sizes": sizes}

    ws = args.root / "workspace"
    ws.mkdir(parents=True, exist_ok=True)
    cmd = command(args, scene, ws)
    print("# launching:", " ".join(cmd), flush=True)
    t0 = time.time()
    log = ws / "driver.log"
    rc, restarts = common.supervise_cli(cmd, log, args.device, stall_timeout=args.stall_timeout,
                                        max_restarts=args.max_restarts, deadline=args.deadline_epoch)
    result = {"rc": rc, "wall_s": round(time.time() - t0, 1), "segment_sizes": sizes, "restarts": restarts}
    if rc == 0:
        result["validation_blocks"] = block_means(parse_validation_blocks(ws))
    elif rc == BUDGET_RC:
        # The wall-clock budget expired: partial but resumable, with the
        # validation blocks reached so far.
        result["partial"] = True
        result["validation_blocks"] = block_means(parse_validation_blocks(ws))
    else:
        result["tail"] = log.read_text()[-2000:] if log.exists() else ""
    (args.root / "result.json").write_text(json.dumps(result, indent=2))
    print(json.dumps(result, indent=2))
    return result


if __name__ == "__main__":
    main()
