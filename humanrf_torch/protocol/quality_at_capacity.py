"""Quality-at-capacity sweep (`scripts/quality_at_capacity.py`): the flagship
field against the reference-capacity field on a scene with high-frequency
detail.

Runs the port's CLI per configuration on one shared scene (the r4 subject:
texture frequency 30 and 12 thin rods), then tabulates each run's best
validation block.

Capacity: a segment's tables hold round(log2(segment_size / 100 ·
2^log2_hashmap_size)) entries per level (`models/humanrf.py::
segment_grid_config`). On a 25-frame segment (`--size 384 --frames 25`):
    log2 13 → 2^11 = 2048  (fused-flagship: L8/F4)
    log2 24 → 2^22         (gather-ref-capacity: L16/F2, the reference's
                            example_humanrf capacity per frame)

The JAX package ran each configuration through the field backend it names
(one-hot, fused Pallas, or gather); the port has one field path, the
field query's kernels, at any table size. The command still passes
`--tpu.field_backend`, and the CLI prints that the port ignores it.

    python -m humanrf_torch.protocol.quality_at_capacity --size 384 --frames 25 --steps 5000 \\
        --only fused-flagship gather-ref-capacity [--root protocol_runs/quality_sweep] [--device cpu]

writes the scene under <root>/scene, each run under <root>/runs/<name> and
the table to <out> (default <root>/results.json).
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

from humanrf_torch.protocol import common
from humanrf_torch.protocol.supervisor import BUDGET_RC
from humanrf_torch.protocol.validation_report import best_block, parse_validation_blocks
from humanrf_torch.run import resolve_device

CONFIGS = {
    # name: (field_backend, log2_hashmap, n_levels, n_features, extra_flags)
    "onehot-2048-L8F4": ("onehot", 17, 8, 4, []),   # the JAX round-2 flagship
    "onehot-1024-L8F4": ("onehot", 16, 8, 4, []),
    "onehot-2048-L16F2": ("onehot", 17, 16, 2, []),
    # Two-level proposal cascade: half the fine samples (Kf = 8 from a
    # second cheap-proposal refinement of 16 mid samples).
    "onehot-2048-L8F4-Kf8-cascade": (
        "onehot", 17, 8, 4,
        ["--tpu.proposal_mid_samples_per_ray", "16", "--tpu.render_samples_per_ray", "8"],
    ),
    "gather-2^18-L16F2": ("gather", 24, 16, 2, []),
    # The pair at scale (--size 384 --frames 25 --steps 5000): the flagship
    # at per-frame flagship capacity (log2 13 → T = 2048 on 25-frame
    # segments) against the reference capacity (log2 24 → 2^22 on 25-frame
    # segments, the reference's example_humanrf capacity per frame).
    "fused-flagship": ("fused", 13, 8, 4, []),
    "gather-ref-capacity": ("gather", 24, 16, 2, []),
}


def make_scene(root: Path, width: int, height: int, num_frames: int, device: str = "cuda") -> None:
    # Motion scaled so that sequences of ≥ 25 frames cross the occupancy
    # union's expansion threshold as the 50-frame protocol scene does (0.16
    # over 50 frames → [25, 25]).
    travel = 0.06 if num_frames <= 2 else 0.16 * (num_frames / 50.0)
    common.write_scene(root, common.detail_scene(width, height, num_frames, travel), device)


def command(name: str, scene: Path, ws: Path, steps: int, extra: list, frames: int = 2, chunk: int = 1,
            device: str = "cuda") -> list:
    backend, log2, levels, feats, cfg_extra = CONFIGS[name]
    validate_every = max(steps // 4, 1)
    if chunk > 1:
        validate_every = max(validate_every - validate_every % chunk, chunk)
    flags = [
        "--config", "example_synthetic",
        "--dataset.path", str(scene),
        "--workspace", str(ws),
        "--device", device,
        "--model.log2_hashmap_size", str(log2),
        "--model.n_levels", str(levels),
        "--model.n_features_per_level", str(feats),
        "--model.finest_resolution", "2048",
        "--tpu.field_backend", backend,
        "--tpu.sampling", "proposal",
        "--tpu.proposal_samples_per_ray", "32",
        "--tpu.render_samples_per_ray", "16",
        "--tpu.candidate_rays_factor", "2",
        "--tpu.steps_per_dispatch", str(chunk),
        "--training.max_steps", str(steps),
        "--training.rays_initial_batch_size", "4096",
        "--training.checkpoint", "latest",  # resumable across watchdog restarts
        "--training.save_checkpoint_every_n_steps", str(validate_every),
        "--validation.every_n_steps", str(validate_every),
        "--validation.rays_batch_size", "16384",
        "--dataset.frame_numbers", *[str(i) for i in range(frames)],
    ] + cfg_extra + extra
    if frames > 2:
        flags += [
            "--model.temporal_partitioning", "adaptive",
            "--model.camera_embedding_dim", "2",
            "--dataset.max_buffer_size", "48",
            "--dataset.max_num_frames_per_batch", "8",
        ]
    return common.cli_command(flags)


def run_config(
    name: str, scene: Path, work: Path, steps: int, extra: list[str],
    frames: int = 2, chunk: int = 1, deadline: float | None = None,
    stall_timeout: float = 1500.0, device: str = "cuda",
) -> dict:
    ws = work / name
    cmd = command(name, scene, ws, steps, extra, frames, chunk, device)
    t0 = time.time()
    ws.mkdir(parents=True, exist_ok=True)
    log = ws / "driver.log"
    # The trainer logs a line per 500 steps, so stall_timeout must well
    # exceed 500 steps of the slowest configuration.
    rc, restarts = common.supervise_cli(cmd, log, device, stall_timeout=stall_timeout, max_restarts=4,
                                        deadline=deadline)
    result = {"name": name, "wall_s": round(time.time() - t0, 1), "rc": rc, "restarts": restarts}
    if rc == BUDGET_RC:
        # The budget expired: report the best block reached so far (the run
        # checkpoints at every validation, so it is resumable).
        result["partial"] = True
    elif rc != 0:
        result["tail"] = log.read_text()[-1500:] if log.exists() else ""
        return result
    if not (ws / "validation.txt").exists():
        return result
    # The best validation block: per block, the mean of the per-image
    # metrics; the best block is reported (the reference's best-checkpoint
    # rule).
    result.update(best_block(parse_validation_blocks(ws)))
    return result


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--root", type=Path, default=common.RUNS / "quality_sweep")
    ap.add_argument("--out", type=Path, default=None, help="default <root>/results.json")
    ap.add_argument("--only", nargs="*", default=None, help="subset of config names")
    ap.add_argument("--size", type=int, default=192, help="image width=height")
    ap.add_argument("--frames", type=int, default=2, help=">2 enables adaptive multi-segment")
    ap.add_argument("--chunk", type=int, default=1, help="--tpu.steps_per_dispatch")
    ap.add_argument("--extra", type=str, default="",
                    help="extra CLI flags passed through (single string, whitespace-split)")
    ap.add_argument("--deadline-epoch", type=float, default=None,
                    help="absolute wall-clock budget (epoch seconds) shared by the whole sweep; a config cut off "
                         "by it reports its best validation block so far with partial=true")
    ap.add_argument("--stall-timeout", type=float, default=1500.0,
                    help="seconds of zero log growth before the child is killed and relaunched")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    out = args.out or args.root / "results.json"

    scene = args.root / "scene"
    # Cached on the scene's parameters; a new scene also clears the runs.
    if common.ensure_scene(
        scene,
        {"size": args.size, "frames": args.frames},
        lambda root: make_scene(root, args.size, args.size, args.frames, args.device),
        stale_dirs=(args.root / "runs",),
    ):
        print(f"# generated {args.size}^2 x {args.frames}-frame scene", flush=True)

    results = []
    for name in args.only or CONFIGS:
        print(f"# running {name} ({args.steps} steps) ...", flush=True)
        r = run_config(name, scene, args.root / "runs", args.steps, args.extra.split(), frames=args.frames,
                       chunk=args.chunk, deadline=args.deadline_epoch, stall_timeout=args.stall_timeout,
                       device=args.device)
        print(json.dumps(r), flush=True)
        results.append(r)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(results, indent=2))

    print("\n| config | PSNR | SSIM | wall |")
    print("|---|---|---|---|")
    for r in results:
        print(f"| {r['name']} | {r.get('psnr', 'FAIL')} | {r.get('ssim', '-')} | {r['wall_s']}s |")
    return results


if __name__ == "__main__":
    main()
