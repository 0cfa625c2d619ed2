#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper GPU.

Renders the trained r4 HumanRF model (`runs_evidence/r4_full_schedule_748/
best.ckpt`: 2 segments, L8/F4 grids with T=2048, rank-32 proposal) at full
width: the 748×748 Cam012 frame-0 test view, through the port's own entry
points (`load_checkpoint` → `convert_params` → `HumanRFModel` →
`render_image`), with every field lookup on the hand-written CUDA
`fused_interp` kernel. Phases, each of which raises on failure:

1. device: a CUDA Hopper card (capability 9.0) is required;
2. build: `humanrf_torch/csrc/fused_interp.cu` with nvcc for sm_90a;
3. kernel vs its plain PyTorch version at the render's shapes and at a
   reference-capacity table (T = 2^19), max|err| / max|ref| < 1e-5 (both
   fp32, same summation order), and their times;
4. the render: kernel launches counted over the main path (2 per batch and
   segment with samples), kernel render vs plain render (PSNR ≥ 50 dB), and
   ROI-PSNR against the ground truth within 0.5 dB of the JAX package's
   banked render of the same view.

The last three lines of output are the kernel table as JSON, the card's name
and power limit from nvidia-smi, and `{"ok": true, "device": {...}}`.
Usage: python3 chip_smoke.py
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from humanrf_torch.convert import convert_params
from humanrf_torch.models import fused_field
from humanrf_torch.models.humanrf import HumanRFModel
from humanrf_torch.ops import fused_interp as fi
from humanrf_torch.ops.cuda_build import load_library
from humanrf_torch.train.checkpoint import load_checkpoint
from humanrf_torch.train.trainer import render_image
from humanrf_torch.view_inputs import load_view_inputs

REPO = Path(__file__).resolve().parent
RUN_DIR = REPO / "runs_evidence" / "r4_full_schedule_748"

KERNEL_TOL = 1e-5          # scaled max error, kernel vs plain (both fp32)
RENDER_PSNR_MIN = 50.0     # dB, kernel render vs plain render
ROI_PSNR_SLACK = 0.5       # dB below the banked JAX render's ROI-PSNR

# (name, P, C, F, T, N): one field query of a 16,384-ray batch × 16 samples
# (4·L grid level-pairs, then the four 1-D vectors), and a table of the
# reference's capacity (2^19).
KERNEL_SHAPES = (
    ("grids", 32, 8, 4, 2048, 262_144),
    ("vectors", 4, 2, 32, 2048, 262_144),
    ("capacity", 64, 8, 2, 1 << 19, 65_536),
)


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of `fn` over `iters` launches, after a warm-up."""
    for _ in range(3):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_kernel(device) -> dict:
    per_shape, max_abs = [], 0.0
    for name, P, C, F, T, N in KERNEL_SHAPES:
        rng = np.random.default_rng(0)
        tables = torch.tensor(rng.normal(size=(P, F, T)).astype(np.float32), device=device)
        idx = torch.tensor(rng.integers(0, T, (P, C, N)).astype(np.int32), device=device)
        w = rng.uniform(0, 1, (P, C, N)).astype(np.float32)
        w = torch.tensor(w / w.sum(axis=1, keepdims=True), device=device)  # corner weights sum to 1
        out = fi.fused_interp(tables, idx, w)
        ref = fi.fused_interp_plain(tables, idx, w)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        scaled = err / float(ref.abs().max())
        if not scaled < KERNEL_TOL:
            raise AssertionError(f"fused_interp kernel disagrees at {name} {(P, C, F, T, N)}: scaled err {scaled:.3e}")
        plain_ms = time_ms(lambda: fi.fused_interp_plain(tables, idx, w))
        ms = time_ms(lambda: fi.fused_interp(tables, idx, w))
        log(f"kernel {name} P={P} C={C} F={F} T={T} N={N}: max|err| {err:.3e} (scaled {scaled:.3e}), "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        per_shape.append({"shape": name, "P": P, "C": C, "F": F, "T": T, "N": N,
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
        max_abs = max(max_abs, err)
    query = [s for s in per_shape if s["shape"] in ("grids", "vectors")]
    return {
        "max_abs_err": max_abs,
        # One field query = the grid call plus the vector call.
        "ms": sum(s["ms"] for s in query),
        "plain_ms": sum(s["plain_ms"] for s in query),
        "per_shape": per_shape,
    }


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    """PSNR of images in [0, 1]: per-pixel channel-mean MSE, then −10·log10
    (the JAX package's `evaluation.metrics.compute_psnr`)."""
    mse = np.square(a.astype(np.float64) - b.astype(np.float64)).mean(axis=-1).mean()
    return float("inf") if mse == 0 else float(-10.0 * np.log10(mse))


def roi_psnr(pred_u8: np.ndarray, gt_u8: np.ndarray, mask: np.ndarray) -> float:
    """PSNR inside the mask's bounding box, against rgb·mask (background 0),
    as `Trainer._evaluate_one_image` scores an image."""
    ys, xs = np.nonzero(mask > 0)
    y0, y1, x0, x1 = ys.min(), ys.max() + 1, xs.min(), xs.max() + 1
    gt = gt_u8.astype(np.float64) / 255.0 * (mask[..., None] > 0)
    return psnr(pred_u8[y0:y1, x0:x1] / 255.0, gt[y0:y1, x0:x1])


def to_u8(img: torch.Tensor) -> np.ndarray:
    """As `Trainer.test` writes a render: (clip(x, 0, 1) · 255).astype(uint8)."""
    return (np.clip(img.cpu().numpy(), 0, 1) * 255).astype(np.uint8)


def timed_render(model, view) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render_image(model, view.pipeline_config, view.inputs, view.rays_batch_size)
    torch.cuda.synchronize()
    return img, time.perf_counter() - t0


def main() -> int:
    # Phase 1: device.
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs only on a GPU")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        raise RuntimeError(f"need a Hopper card (capability 9.0), got {cap}")
    device = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} ({smi}); torch {torch.__version__}, CUDA {torch.version.cuda}")

    # Phase 2: build.
    built = load_library("fused_interp")
    log(f"build: {built.path.name} in {built.build_seconds:.2f} s")
    log(built.ptxas_log.strip())

    # Phase 3: the kernel against its plain version.
    kernel = check_kernel(device)

    # Phase 4: the render.
    view = load_view_inputs(RUN_DIR / "torch_view_inputs.npz", device)
    params, step, _, _ = load_checkpoint(RUN_DIR / "best.ckpt")
    model = HumanRFModel(view.model_config, device=device)
    model.load_state_dict(convert_params(params))
    model.eval()
    width, height = view.inputs.width, view.inputs.height
    num_pixels = width * height
    num_batches = -(-num_pixels // view.rays_batch_size)
    frame = view.frame_number
    segments_hit = {int(model.frame_to_segment[frame])}
    expected_launches = 2 * num_batches * len(segments_hit)
    log(f"model: best.ckpt step {step}, segments {view.model_config.segment_sizes}, "
        f"{sum(p.numel() for p in model.parameters())} parameters; view {view.camera_name} frame {frame}, "
        f"{width}x{height}, {num_batches} batches of {view.rays_batch_size} rays")

    fi.reset_launches()
    img, first_s = timed_render(model, view)
    launches = fi.launches
    log(f"render (kernel, first): {first_s:.3f} s, {num_pixels / first_s:.0f} rays/s, {launches} kernel launches")
    if launches != expected_launches:
        raise AssertionError(f"main path launched fused_interp {launches} times, expected {expected_launches}")

    # Warm renders in turns, plain, kernel, kernel, plain; the plain ones swap
    # the field's kernel call for its plain version.
    times = {"kernel": [], "plain": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        if which == "plain":
            with mock.patch.object(fused_field, "fused_interp", fi.fused_interp_plain):
                img_plain, seconds = timed_render(model, view)
        else:
            _, seconds = timed_render(model, view)
        times[which].append(seconds)
    for which, runs in times.items():
        mean = sum(runs) / len(runs)
        log(f"render ({which}): " + ", ".join(f"{t:.3f}" for t in runs)
            + f" s; mean {mean:.3f} s, {num_pixels / mean:.0f} rays/s")

    img_np = img.cpu().numpy()
    gt, mask = view.images["gt_rgb"], view.images["gt_mask"]
    if img_np.shape != gt.shape or not np.isfinite(img_np).all():
        raise AssertionError(f"render is not a finite image of the ground truth's shape {gt.shape}: {img_np.shape}")
    vs_plain = psnr(np.clip(img_np, 0, 1), np.clip(img_plain.cpu().numpy(), 0, 1))
    log(f"PSNR(kernel render, plain render) = {vs_plain:.2f} dB")
    if not vs_plain >= RENDER_PSNR_MIN:
        raise AssertionError(f"kernel render differs from the plain render: {vs_plain:.2f} dB < {RENDER_PSNR_MIN}")

    port_u8, jax_u8 = to_u8(img), view.images["jax_render"]
    port_roi, jax_roi = roi_psnr(port_u8, gt, mask), roi_psnr(jax_u8, gt, mask)
    vs_jax = psnr(port_u8 / 255.0, jax_u8 / 255.0)
    log(f"ROI-PSNR vs ground truth: port {port_roi:.3f} dB, banked JAX render {jax_roi:.3f} dB; "
        f"PSNR(port, JAX render) = {vs_jax:.2f} dB")
    if not port_roi >= jax_roi - ROI_PSNR_SLACK:
        raise AssertionError(f"port ROI-PSNR {port_roi:.3f} dB is more than {ROI_PSNR_SLACK} dB below JAX's {jax_roi:.3f}")

    record = {
        "name": "fused_interp_fwd",
        "route": "cuda",
        "source": "humanrf_torch/csrc/fused_interp.cu",
        "replaces": "humanrf_tpu/ops/fused_interp.py:87",
        "launches": launches,
        **kernel,
    }
    print(json.dumps({"kernels": [record]}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
