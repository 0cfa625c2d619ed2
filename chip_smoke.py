#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper GPU.

Drives the port's paths at the full width of the r4 HumanRF model (2
segments [25, 25], L8/F4 grids with T=2048 per segment, rank-32 proposal,
camera embedding 2) through its own entry points, with every field lookup on
the hand-written CUDA `fused_interp` kernels (forward and backward):

- the render of the trained model `runs_evidence/r4_full_schedule_748/
  best.ckpt` (`load_checkpoint` → `convert_params` → `HumanRFModel` →
  `render_image`), the 748×748 Cam012 frame-0 test view;
- the flagship training step (`make_train_step` with proposal sampling,
  16,384 rays from 2× candidates, Kc=32, Kf=16, AdamW) on a fresh model, fed
  from the baked pool of the scene's train cameras at frames 0 and 25;
- the CLI, `python -m humanrf_torch.run`, on the r4 scene written by the
  port: the loader's pool, training with validation and checkpoints, a
  resume, the test render and the evaluation.

Phases, each of which raises on failure:

1. device: a CUDA Hopper card (capability 9.0) is required;
2. build: `humanrf_torch/csrc/fused_interp.cu` with nvcc for sm_90a;
3. each kernel vs its plain PyTorch version at the field's shapes and at a
   reference-capacity table (T = 2^19), max|err| / max|ref| < 1e-5, and
   their times;
4. the render: kernel launches counted over it (2 forward per batch and
   segment with samples, no backward), kernel render vs plain render (PSNR
   ≥ 50 dB), and ROI-PSNR against the ground truth within 0.5 dB of the JAX
   package's banked render of the same view;
5. training: a step-0 A/B of loss and gradients through the kernels against
   both directions' plain versions; TRAIN_STEPS steps with launches counted
   (2 forward + 2 backward per segment per step), finite losses, no skipped
   update and falling mse; ms per step, supervised rays/s, peak memory and
   the device's busy share in one profiled step; the held-out Cam012 view's
   ROI-PSNR before and after training;
6. the CLI: the r4 scene written with the port's generator (its time; one
   JPEG decoded back against the renderer's image, PSNR ≥ JPEG_PSNR_MIN;
   adaptive partitioning gives [25, 25]), then `humanrf_torch.run.main` with
   the r4 command's flags: EARLY_STEPS steps validated and saved at the end,
   resumed from `latest` to CLI_STEPS with validation and saves every
   CLI_STEPS / 2, and frame 0 of the test camera rendered and evaluated.
   Checks: three validation blocks of 3 finite images, the later two above
   the early one in mean PSNR (the CLI's validation PSNR plateaus by step
   ~100 on this scene, so the rise shows against an early block), at most 2
   step checkpoints after the rolling prune and a best.ckpt, the test frame
   and the CSVs, no skipped update, launches of both kernel directions
   counted over these runs; then a resume from `latest` for RESUME_STEPS
   more steps. Prints ms per step, nominal and supervised rays/s, the host
   fetch share and the pool's replacement rate.

The last three lines of output are the kernel table as JSON (the forward and
the backward kernel; `launches` counted over phase 6, the CLI, with each
phase's counts beside them), the card's name and power limit from
nvidia-smi, and `{"ok": true, "device": {...}}`.
Usage: python3 chip_smoke.py
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

from humanrf_torch import run as cli
from humanrf_torch.convert import convert_params
from humanrf_torch.core import image_io
from humanrf_torch.core.dataset import VolumetricDataset
from humanrf_torch.core.synthetic import make_cameras, render_cameras
from humanrf_torch.models import fused_field
from humanrf_torch.models.humanrf import HumanRFModel
from humanrf_torch.ops import fused_interp as fi
from humanrf_torch.ops.cuda_build import load_library
from humanrf_torch.r4 import NUM_FRAMES, R4_SCENE, r4_flags, write_scene
from humanrf_torch.train.partitioning import compute_adaptive_segment_sizes
from humanrf_torch.train.checkpoint import load_checkpoint
from humanrf_torch.train.pipeline import make_train_step
from humanrf_torch.train.trainer import make_optimizer, render_image, sample_batch
from humanrf_torch.utils.rngs import fold_in, make_key
from humanrf_torch.view_inputs import load_train_inputs, load_view_inputs

REPO = Path(__file__).resolve().parent
RUN_DIR = REPO / "runs_evidence" / "r4_full_schedule_748"

KERNEL_TOL = 1e-5          # scaled max error, kernel vs plain (both fp32; see check_kernels)
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


# The flagship step (bench.py:121-136, 211; the r4 run's config.yaml): 16,384
# supervised slots from 2× candidate rays, Huber δ 0.01 + 1e-3·BCE +
# distillation. The sampling settings come from the view's config.
TRAIN_CONFIG = dict(num_rays=16_384, candidate_rays_factor=2, bce_loss_weight=1e-3, huber_delta=0.01,
                    proposal_loss_weight=1.0)
TRAIN_STEPS = 300          # steps of phase 5 (a fresh model), ~60 s
WARM_STEPS = 5             # not timed
STEP0_LOSS_REL = 1e-5      # step-0 loss, kernels vs plain
STEP0_GRAD_COSINE = 0.9999 # step-0 gradient per parameter, kernels vs plain
MSE_DROP = 0.5             # mean mse of the last 20 steps ≤ this × that of the first 5

EARLY_STEPS = 20           # phase 6: the first CLI run, validated and saved at its end
CLI_STEPS = 600            # phase 6: resumed to this step, validated and saved every CLI_STEPS / 2
RESUME_STEPS = 20          # phase 6: steps of the resumed run
# dB, a written q98 JPEG decoded back against the rendered image. JPEG's own
# loss on this texture is ~44 dB (Cam001 frame 0: 44.14 dB on the CPU, the
# bytes cv2 writes); a wrong colour conversion or upsampling falls far below.
JPEG_PSNR_MIN = 40.0


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


def check_kernels(device) -> dict:
    """Each kernel against its plain version at KERNEL_SHAPES, random inputs
    with per-sample-normalised corner weights, and both times.

    The forward and its plain version sum the same fp32 products in the same
    order (the kernel with fma). The backward's atomics add in a
    run-dependent order, and so does the plain scatter_add on the card: an
    entry of dtab sums ~N·C/T terms (≤ 1,024 here), and reordering an fp32
    sum of n terms moves it by about eps·√n of its terms' size (~2e-6), so
    1e-5 of the output's scale bounds both directions.
    """
    directions = {
        "fwd": (lambda t, i, w, g: fi._launch_fwd(t, i, w), lambda t, i, w, g: fi.fused_interp_plain(t, i, w)),
        "bwd": (lambda t, i, w, g: fi._launch_bwd(g, i, w, t.shape[2]),
                lambda t, i, w, g: fi.fused_interp_bwd_plain(g, i, w, t.shape[2])),
    }
    results = {}
    for direction, (kernel, plain) in directions.items():
        per_shape, max_abs = [], 0.0
        for name, P, C, F, T, N in KERNEL_SHAPES:
            rng = np.random.default_rng(0)
            tables = torch.tensor(rng.normal(size=(P, F, T)).astype(np.float32), device=device)
            idx = torch.tensor(rng.integers(0, T, (P, C, N)).astype(np.int32), device=device)
            w = rng.uniform(0, 1, (P, C, N)).astype(np.float32)
            w = torch.tensor(w / w.sum(axis=1, keepdims=True), device=device)  # corner weights sum to 1
            g = torch.tensor(rng.normal(size=(P, F, N)).astype(np.float32), device=device)
            out = kernel(tables, idx, w, g)
            ref = plain(tables, idx, w, g)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            scaled = err / float(ref.abs().max())
            if not scaled < KERNEL_TOL:
                raise AssertionError(f"fused_interp_{direction} kernel disagrees at {name} {(P, C, F, T, N)}: "
                                     f"scaled err {scaled:.3e}")
            plain_ms = time_ms(lambda: plain(tables, idx, w, g))
            ms = time_ms(lambda: kernel(tables, idx, w, g))
            log(f"kernel {direction} {name} P={P} C={C} F={F} T={T} N={N}: max|err| {err:.3e} "
                f"(scaled {scaled:.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
            per_shape.append({"shape": name, "P": P, "C": C, "F": F, "T": T, "N": N,
                              "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
            max_abs = max(max_abs, err)
        query = [s for s in per_shape if s["shape"] in ("grids", "vectors")]
        results[direction] = {
            "max_abs_err": max_abs,
            # One field query = the grid call plus the vector call.
            "ms": sum(s["ms"] for s in query),
            "plain_ms": sum(s["plain_ms"] for s in query),
            "per_shape": per_shape,
        }
    return results


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


class _GradientsOnly:
    """An optimizer that leaves the parameters as they are, so a train step
    computes its loss and gradients only."""

    def __init__(self, model):
        self.model = model

    def zero_grad(self):
        self.model.zero_grad(set_to_none=True)

    def step(self):
        pass


def cosine(a: torch.Tensor, b: torch.Tensor) -> float:
    a, b = a.double().flatten(), b.double().flatten()
    return float(a @ b / (a.norm() * b.norm()))


def held_out_roi_psnr(model, view) -> float:
    img = render_image(model, view.pipeline_config, view.inputs, view.rays_batch_size)
    return roi_psnr(to_u8(img), view.images["gt_rgb"], view.images["gt_mask"])


def train(device, view) -> dict:
    """Phase 5 (see the module docstring). → the main path's launches."""
    model = HumanRFModel(view.model_config)
    model.init_parameters(torch.Generator().manual_seed(0))  # on the CPU: the same start on any machine
    model.to(device)
    pool = load_train_inputs(RUN_DIR / "torch_train_inputs.npz", device)
    cfg = dataclasses.replace(view.pipeline_config, **TRAIN_CONFIG)
    log(f"train: fresh model, {sum(p.numel() for p in model.parameters())} parameters; {cfg}; "
        f"pool of {len(pool.camera_names)} images at frames {sorted(set(pool.pool.frame_numbers.tolist()))}")
    generator = torch.Generator(device).manual_seed(1)
    key = make_key(0, device)
    width, height = pool.width, pool.height

    # Step-0 A/B: one batch, one key, loss and gradients through the kernels
    # and through both directions' plain versions.
    batch = sample_batch(cfg, pool.pixel_rgba, generator)
    grads_step = make_train_step(cfg, model, _GradientsOnly(model), width, height)
    runs = {}
    for which in ("kernel", "plain"):
        if which == "plain":
            with mock.patch.object(fused_field, "fused_interp", fi.PlainFusedInterp.apply):
                loss, _ = grads_step(batch, pool.pool, pool.grids, pool.aabb, key)
        else:
            loss, _ = grads_step(batch, pool.pool, pool.grids, pool.aabb, key)
        runs[which] = (float(loss), {n: p.grad.clone() for n, p in model.named_parameters()})
    (loss_k, grads_k), (loss_p, grads_p) = runs["kernel"], runs["plain"]
    rel = abs(loss_k - loss_p) / abs(loss_p)
    # The gradients are held by cosine, not by max error: a sum that differs
    # by an ulp can flip a near-tie bf16 rounding in the MLP, which moves a
    # few gradient entries by far more than the kernels' own rounding.
    cosines = {n: cosine(grads_k[n], grads_p[n]) for n in grads_k}
    worst = min(cosines, key=cosines.get)
    log(f"step-0 A/B: loss kernel {loss_k:.7f}, plain {loss_p:.7f} (rel {rel:.2e}); "
        f"gradient cosine min {cosines[worst]:.7f} ({worst})")
    if not rel <= STEP0_LOSS_REL:
        raise AssertionError(f"step-0 loss through the kernels differs from the plain run by {rel:.2e} relative")
    if not cosines[worst] >= STEP0_GRAD_COSINE:
        raise AssertionError(f"step-0 gradient of {worst} has cosine {cosines[worst]:.7f} to the plain run's")
    model.zero_grad(set_to_none=True)

    roi_before = held_out_roi_psnr(model, view)
    log(f"held-out {view.camera_name} frame {view.frame_number} before training: ROI-PSNR {roi_before:.3f} dB")

    optimizer = make_optimizer(model.named_parameters(), lr=1e-2, lr_decay=0.5, max_steps=50_001, weight_decay=0.03)
    step = make_train_step(cfg, model, optimizer, width, height)
    losses, mses, supervised, per_step_launches = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    fi.reset_launches()
    start = None
    for i in range(TRAIN_STEPS):
        if i == WARM_STEPS:
            torch.cuda.synchronize()
            start = time.perf_counter()
        before = dict(fi.launches)
        b = sample_batch(cfg, pool.pixel_rgba, generator)
        loss, aux = step(b, pool.pool, pool.grids, pool.aabb, fold_in(key, torch.tensor(i, device=device)))
        per_step_launches.append({d: fi.launches[d] - before[d] for d in before})
        losses.append(loss)
        mses.append(aux["mse"])
        supervised.append(aux["num_rays_supervised"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = dict(fi.launches)
    peak = torch.cuda.max_memory_allocated(device)

    losses, mses = torch.stack(losses).cpu(), torch.stack(mses).cpu()
    supervised = torch.stack(supervised).cpu()
    warm = TRAIN_STEPS - WARM_STEPS
    ms_per_step = 1e3 * seconds / warm
    log(f"train: {TRAIN_STEPS} steps, loss {float(losses[0]):.5f} → {float(losses[-1]):.5f}, "
        f"mse {float(mses[:5].mean()):.5f} (first 5) → {float(mses[-20:].mean()):.5f} (last 20); "
        f"skipped updates {int(optimizer.skipped)}; kernel launches {launches}")
    log(f"train: {ms_per_step:.2f} ms per warm step (mean of {warm}, batch draw included), "
        f"{float(supervised[WARM_STEPS:].sum()) / seconds:.0f} supervised rays/s "
        f"({float(supervised.float().mean()):.0f} supervised rays per step), "
        f"peak memory {peak / 2**30:.2f} GiB")
    # Both segments are hit on every step: the pool holds frames 0 and 25.
    expected = {"fwd": 2 * 2, "bwd": 2 * 2}
    bad = [i for i, n in enumerate(per_step_launches) if n != expected]
    if bad or launches != {d: n * TRAIN_STEPS for d, n in expected.items()}:
        raise AssertionError(f"training launched fused_interp {launches}; steps {bad[:5]} differ from {expected} per step")
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss at steps {torch.nonzero(~torch.isfinite(losses)).flatten().tolist()}")
    if int(optimizer.skipped) != 0:
        raise AssertionError(f"{int(optimizer.skipped)} updates skipped as non-finite")
    if not float(mses[-20:].mean()) <= MSE_DROP * float(mses[:5].mean()):
        raise AssertionError("training mse did not fall to half its start")

    prof = profile_step(step, sample_batch(cfg, pool.pixel_rgba, generator), pool, key, device)
    log(f"train: one profiled warm step: {prof['kernels']} kernels, {prof['device_ms']:.2f} ms of device time "
        f"in {prof['wall_ms']:.1f} ms profiled wall; device busy {100 * prof['device_ms'] / ms_per_step:.1f}% "
        f"of a {ms_per_step:.2f} ms warm step; top: {prof['top']}")

    roi_after = held_out_roi_psnr(model, view)
    log(f"held-out {view.camera_name} frame {view.frame_number} after {TRAIN_STEPS + 1} steps (one profiled): "
        f"ROI-PSNR {roi_after:.3f} dB (before {roi_before:.3f} dB)")
    if not roi_after > roi_before:
        raise AssertionError("training did not raise the held-out view's ROI-PSNR")
    return launches


def profile_step(step, batch, pool, key, device) -> dict:
    """One warm step under torch.profiler: its CUDA kernels' count and summed
    time, and the five largest by self device time. The device's busy share
    is that sum over an unprofiled warm step's wall time (the profiler slows
    the host)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, pool.pool, pool.grids, pool.aabb, fold_in(key, torch.tensor(TRAIN_STEPS, device=device)))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("torch.profiler saw no CUDA kernel in a training step")
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:5]
    return {
        "device_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
        "wall_ms": 1e3 * wall,
        "kernels": len(kernels),
        "top": ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms" for e in top),
    }


def validation_blocks(ws: Path) -> dict:
    """validation.txt → {step: [psnr of each image]}."""
    blocks, step = {}, None
    for line in (ws / "validation.txt").read_text().splitlines():
        if line.startswith("Step: "):
            step = int(line.split()[1])
            blocks[step] = []
        else:
            blocks[step] += [float(p.split("=")[1]) for p in line.split() if p.startswith("psnr=")]
    return blocks


def cli_phase(device) -> dict:
    """Phase 6 (see the module docstring). → the CLI run's launches."""
    with tempfile.TemporaryDirectory(prefix="humanrf_r4_") as tmp:
        scene, ws = Path(tmp) / "scene", Path(tmp) / "workspace"
        seconds = write_scene(scene, device)
        data_dir = scene / "SynthActor" / "Sequence1" / "1x"
        cam = make_cameras(R4_SCENE)[0]
        rendered, _ = render_cameras(
            R4_SCENE, torch.tensor(cam.inverse_kr()[None].astype(np.float32), device=device),
            torch.tensor(cam.translation[None].astype(np.float32), device=device),
            torch.tensor(np.asarray(R4_SCENE.center_start, dtype=np.float32), device=device), 0.0, cam.height, cam.width)
        decoded = image_io.imread(data_dir / "rgbs" / cam.name / f"{cam.name}_rgb000000.jpg")[..., ::-1]
        jpeg_psnr = psnr(decoded / 255.0, rendered[0].cpu().numpy() / 255.0)
        sizes = compute_adaptive_segment_sizes(VolumetricDataset(data_dir), list(range(NUM_FRAMES)))
        log(f"cli: r4 scene ({R4_SCENE.num_cameras} cameras × {NUM_FRAMES} frames, {cam.width}x{cam.height}) "
            f"written in {seconds:.1f} s; {cam.name} frame 0 JPEG vs render {jpeg_psnr:.2f} dB; segments {sizes}")
        if not jpeg_psnr >= JPEG_PSNR_MIN:
            raise AssertionError(f"a written JPEG decodes {jpeg_psnr:.2f} dB from its render (< {JPEG_PSNR_MIN})")
        if sizes != [25, 25]:
            raise AssertionError(f"adaptive partitioning of the r4 scene gave {sizes}, not [25, 25]")

        half = CLI_STEPS // 2
        early = r4_flags(scene, ws, EARLY_STEPS, EARLY_STEPS)
        flags = r4_flags(scene, ws, CLI_STEPS, half) + [
            "--training.checkpoint", "latest", "--evaluate", "true", "--evaluation.frame_numbers", "0"]
        torch.cuda.synchronize()
        fi.reset_launches()
        t0 = time.perf_counter()
        cli.main(early)
        result = cli.main(flags)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(fi.launches)
        stats = result["train"]
        blocks = validation_blocks(ws)
        means = {step: float(np.mean(v)) for step, v in blocks.items()}
        log(f"cli: {EARLY_STEPS} steps, then resumed to {CLI_STEPS} + 3 validations + test render + evaluation "
            f"in {wall:.1f} s wall; kernel launches {launches}; validation PSNR per block {blocks}; "
            f"evaluation {result['averages']}")
        log(f"cli: trainer scale ({stats['steps']} steps timed): {stats['ms_per_step']:.2f} ms per step, "
            f"{stats['rays_per_s']:.0f} rays/s nominal, {stats['supervised_rays_per_s']:.0f} supervised rays/s, "
            f"host fetch {100 * stats['fetch_share']:.1f}% of the train time, "
            f"{stats['images_replaced_per_step']:.2f} pool images replaced per step")
        if sorted(blocks) != [EARLY_STEPS, half, CLI_STEPS] or any(
                len(v) != 3 or not np.isfinite(v).all() for v in blocks.values()):
            raise AssertionError(f"expected three validation blocks of 3 finite images, got {blocks}")
        if not min(means[half], means[CLI_STEPS]) > means[EARLY_STEPS]:
            raise AssertionError(f"validation PSNR did not rise: {means}")
        if stats["start_step"] != EARLY_STEPS:
            raise AssertionError(f"the second run did not resume from step {EARLY_STEPS}: {stats}")
        ckpts = sorted(p.name for p in (ws / "checkpoints").glob("*.ckpt"))
        if "best.ckpt" not in ckpts or len([c for c in ckpts if c.startswith("step_")]) > 2:
            raise AssertionError(f"checkpoints: {ckpts}")
        results = ws / "results"
        if not (list((results / "test_frames").glob("*.png")) and (results / "metrics.csv").exists()
                and (results / "averages.csv").exists()):
            raise AssertionError("the evaluate phase wrote no test frame or CSV")
        if stats["skipped_nonfinite"] != 0:
            raise AssertionError(f"{stats['skipped_nonfinite']} updates skipped as non-finite")
        if not (launches["fwd"] > 0 and launches["bwd"] > 0):
            raise AssertionError(f"the CLI run launched fused_interp {launches}")

        resumed = cli.main(r4_flags(scene, ws, CLI_STEPS + RESUME_STEPS, CLI_STEPS // 2)
                           + ["--training.checkpoint", "latest"])["train"]
        log(f"cli: resumed from step {resumed['start_step']} to {resumed['end_step']}")
        if (resumed["start_step"], resumed["end_step"]) != (CLI_STEPS, CLI_STEPS + RESUME_STEPS + 1):
            raise AssertionError(f"the resume ran steps {resumed['start_step']}..{resumed['end_step']}")
    return launches


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

    # Phase 3: the kernels against their plain versions.
    kernels = check_kernels(device)

    # Phase 4: the render.
    view = load_view_inputs(RUN_DIR / "torch_view_inputs.npz", device)
    params, _, step, _, _ = load_checkpoint(RUN_DIR / "best.ckpt")
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
    launches = dict(fi.launches)
    log(f"render (kernel, first): {first_s:.3f} s, {num_pixels / first_s:.0f} rays/s, kernel launches {launches}")
    if launches != {"fwd": expected_launches, "bwd": 0}:
        raise AssertionError(f"the render launched fused_interp {launches}, expected {expected_launches} forward, 0 backward")

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

    # Phase 5: training.
    train_launches = train(device, view)

    # Phase 6: the CLI.
    cli_launches = cli_phase(device)

    records = [
        {
            "name": f"fused_interp_{direction}",
            "route": "cuda",
            "source": "humanrf_torch/csrc/fused_interp.cu",
            "replaces": f"humanrf_tpu/ops/fused_interp.py:{line}",
            "launches": cli_launches[direction],
            "launches_by_phase": {"render": launches[direction], "train_step": train_launches[direction],
                                  "cli": cli_launches[direction]},
            **kernels[direction],
        }
        for direction, line in (("fwd", 87), ("bwd", 97))
    ]
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
