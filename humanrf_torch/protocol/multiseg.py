"""The long-sequence run: four adaptive segments (`scripts/multiseg_fsdp_run.py`).

Every card cell of the r4 protocol trains [25, 25]; this run crosses into
more segments, the regime the reference reaches with its 250-frame
`siggraph_interval_2` preset. 100 frames at the 50-frame protocol's speed
(twice its travel) partition adaptively into [25, 25, 25, 25]. The JAX
driver ran it on an 8-device virtual CPU mesh with FSDP table sharding; the
port runs it on the card: one process on one card (`--tpu.num_devices 1`,
tables replicated), or, where two or more cards are visible, min(count, 4)
ranks with the tables sharded (`--tpu.param_sharding fsdp`).

The run exercises adaptive partitioning at n = 4, frame-window batches that
cross segment boundaries, the per-segment routing of every query
(`models/humanrf.py::_per_segment`) and a checkpoint of four segments.

    python -m humanrf_torch.protocol.multiseg [--steps 400] [--size 192] [--root protocol_runs/multiseg] [--device cpu]

writes the scene under <root>/scene, the run under <root>/ws, its log to
<root>/driver.log and the summary to <out> (default <root>/results.json).
"""
from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

import torch

from humanrf_torch.protocol import common
from humanrf_torch.protocol.validation_report import block_means, parse_validation_blocks
from humanrf_torch.run import resolve_device

# `--tpu.num_devices` and `--tpu.param_sharding` follow the cards visible here.
MOOT_FLAGS = common.MOOT_FLAGS + ("--tpu.num_devices", "--tpu.param_sharding")


def make_scene(root: Path, frames: int, size: int, device: str = "cuda") -> None:
    # 0.16 of travel over 50 frames gives [25, 25] (full_schedule); twice the
    # horizon at the same speed crosses the occupancy union's expansion
    # threshold four times: [25, 25, 25, 25].
    common.write_scene(root, common.detail_scene(size, size, frames, 0.16 * (frames / 50.0)), device)


def sharding_flags(device: str) -> list:
    """One process on one card (or the CPU); on two or more cards,
    min(count, 4) ranks with FSDP tables."""
    count = torch.cuda.device_count() if device != "cpu" else 1
    if count >= 2:
        return ["--tpu.num_devices", str(min(count, 4)), "--tpu.param_sharding", "fsdp"]
    return ["--tpu.num_devices", "1"]


def command(args, scene: Path, ws: Path) -> list:
    validate_every = args.validate_every or max(100, args.steps // 4 // 5 * 5)
    return common.cli_command([
        "--config", "example_synthetic",
        "--dataset.path", str(scene),
        "--workspace", str(ws),
        "--device", args.device,
        *sharding_flags(args.device),
        "--tpu.steps_per_dispatch", "5",
        "--tpu.field_backend", args.backend,
        "--tpu.sampling", "proposal",
        "--tpu.proposal_samples_per_ray", str(args.prop_samples),
        "--tpu.render_samples_per_ray", str(args.render_samples),
        "--tpu.candidate_rays_factor", "2",
        "--model.temporal_partitioning", "adaptive",
        "--model.log2_hashmap_size", "13",
        "--model.n_levels", "8",
        "--model.n_features_per_level", "4",
        "--model.finest_resolution", "1024",
        "--model.camera_embedding_dim", "2",
        "--training.max_steps", str(args.steps),
        "--training.rays_initial_batch_size", str(args.batch),
        "--training.save_checkpoint_every_n_steps", str(args.steps),
        "--validation.every_n_steps", str(validate_every),
        "--validation.rays_batch_size", str(2 * args.batch),
        "--validation.repeat_cameras", "1",
        "--dataset.frame_numbers", *[str(i) for i in range(args.frames)],
        "--dataset.max_buffer_size", "24",
        "--dataset.max_num_frames_per_batch", "8",
    ])


def read_log(text: str) -> dict:
    """The run's segment sizes, sharding lines, ms per step and field_interp
    launches per step from its log."""
    seg = re.search(r"segment sizes: \[([^\]]+)\]", text)
    timed = re.search(r"train: (\d+) steps timed.*?: ([\d.]+) ms per step", text)
    launches = re.search(r"field_interp launches fwd (\d+) bwd (\d+) over (\d+) steps", text)
    return {
        "segment_sizes": [int(s) for s in seg.group(1).split(",")] if seg else None,
        "fsdp_log_lines": [ln for ln in text.splitlines() if "fsdp" in ln.lower() or "per-device" in ln.lower()][:8],
        "ms_per_step": float(timed.group(2)) if timed else None,
        "launches_per_step": ({"fwd": int(launches.group(1)) / int(launches.group(3)),
                               "bwd": int(launches.group(2)) / int(launches.group(3))} if launches else None),
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--size", type=int, default=192)
    ap.add_argument("--frames", type=int, default=100)
    # Passed on as --tpu.field_backend; the port has one field path.
    ap.add_argument("--backend", default="gather")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--prop-samples", type=int, default=16)
    ap.add_argument("--render-samples", type=int, default=8)
    ap.add_argument("--validate-every", type=int, default=None,
                    help="default max(100, steps // 4), a multiple of 5")
    ap.add_argument("--root", type=Path, default=common.RUNS / "multiseg")
    ap.add_argument("--out", type=Path, default=None, help="default <root>/results.json")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    out = args.out or args.root / "results.json"

    scene = args.root / "scene"
    ws = args.root / "ws"
    if common.ensure_scene(
        scene,
        {"size": args.size, "frames": args.frames, "multiseg": True},
        lambda root: make_scene(root, args.frames, args.size, args.device),
        stale_dirs=(ws,),
    ):
        print("# generated scene", flush=True)

    cmd = command(args, scene, ws)
    log = args.root / "driver.log"
    log.unlink(missing_ok=True)
    print("# launching:", " ".join(cmd), flush=True)
    t0 = time.time()
    rc, _ = common.supervise_cli(cmd, log, args.device, max_restarts=0)
    result = {"rc": rc, "wall_s": round(time.time() - t0, 1), **read_log(log.read_text()),
              "validation_blocks": block_means(parse_validation_blocks(ws))}
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(result, indent=2))
    print(json.dumps(result, indent=2), flush=True)
    if rc != 0:
        sys.exit(rc)
    return result


if __name__ == "__main__":
    main()
