#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper GPU.

Drives the port's paths at the full width of the r4 HumanRF model (2
segments [25, 25], L8/F4 grids with T=2048 per segment, rank-32 proposal,
camera embedding 2) through its own entry points, with every field lookup on
the hand-written CUDA `field_interp` kernels (forward and backward), which
compute the field's corners from the sample coordinates themselves:

- the render of the trained model `runs_evidence/r4_full_schedule_748/
  best.ckpt` (`load_checkpoint` → `convert_params` → `HumanRFModel` →
  `render_image`), the 748×748 Cam012 frame-0 test view;
- the flagship training step (`make_train_step` with proposal sampling,
  16,384 rays from 2× candidates, Kc=32, Kf=16, AdamW) on a fresh model, fed
  from the baked pool of the scene's train cameras at frames 0 and 25;
- the CLI, `python -m humanrf_torch.run`, on the r4 scene written by the
  port: the loader's pool, training with validation and checkpoints, a
  resume, the test render and the evaluation;
- dense sampling (the reference's sampler, the CLI's default): best.ckpt's
  view rendered through it, the dense step at the paper's field width
  (`configs/example_humanrf.py`: L16/F2, T = 2^17 per segment) and the CLI
  with the paper's field and sampler on the r4 scene.

The earlier design, the (idx, w) `fused_interp` kernels fed by eager corner
math ("the old path"), is off the main path; phases 3-5 time it beside the
new kernels in the same call.

Phases, each of which raises on failure:

1. device: a CUDA Hopper card (capability 9.0) is required;
2. build: `humanrf_torch/csrc/field_interp.cu` and `fused_interp.cu` with
   nvcc for sm_90a, side by side (registers, shared memory and spills from
   `-Xptxas -v`);
3. kernels: each (idx, w) kernel against its plain version at KERNEL_SHAPES,
   with its time, bound and the time of `F.embedding_bag`, the one PyTorch
   call that computes the same function; each `field_interp` kernel against
   its plain version at the r4 grid, the r4 vectors and a reference-capacity
   grid (T = 2^19, dense and hashed levels), at uniform random positions and
   at real ones (the step-0 field query of phase 5's first batch), with its
   time beside its plain version's, the old path's (eager corner math plus
   the (idx, w) kernel, timed in turns) and its bound. Bars: max|err| /
   max|ref| < 1e-5 (the forward is also reported bit for bit);
4. the render: kernel launches counted over it (2 `field_interp` forward per
   batch and segment with samples, no backward, no `fused_interp`), kernel
   render vs plain render (PSNR ≥ 50 dB), ROI-PSNR against the ground truth
   within 0.5 dB of the JAX package's banked render of the same view, and
   warm renders of the plain, the old and the new path in turns;
5. training: a step-0 A/B of loss and gradients through the kernels against
   both directions' plain versions; TRAIN_STEPS steps with launches counted
   (2 forward + 2 backward per segment per step, no `fused_interp`), finite
   losses, no skipped update and falling mse; ms per step, supervised rays/s,
   peak memory and the device's busy share in one profiled step; then
   windows of the old and the new path in turns (ms per step, peak memory,
   kernels and busy share of a profiled step each); the held-out Cam012
   view's ROI-PSNR before and after training;
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
   and the CSVs, no skipped update, launches of both `field_interp`
   directions and none of `fused_interp` counted over these runs; then a
   resume from `latest` for RESUME_STEPS more steps. Prints ms per step,
   nominal and supervised rays/s, the host fetch share and the pool's
   replacement rate;
7. dense sampling:
   (a) best.ckpt's 748² view through the dense sampler at the r4 run's
   settings (R4_DENSE, scaled to the 16,384-ray batches): launches counted
   (forward only, no `fused_interp`), a finite image, kernel render vs
   plain render ≥ 50 dB, and the baked 128² patch (`torch_dense_inputs.npz`,
   16 batches of 1,024 rays at the baked settings) ≥ DENSE_PATCH_PSNR_MIN
   from the JAX package's dense render of it; prints s per view, ms per
   batch, the sampler's counts per view and the ROI-PSNR beside phase 4's;
   (b) the dense step (DENSE_STEP_CONFIG) on a fresh model with the paper's
   field, fed from phase 5's pool: each field_interp kernel against its
   plain version at step 0's render-pass and prune-pass queries (bars as
   phase 3's; time, bound and share of it), a step-0 kernel-vs-plain A/B
   (loss within 1e-5, gradient cosine ≥ 0.9999), DENSE_STEPS timed steps
   (ms per step, rays/s, supervised rays/s, launches, peak memory, one
   profiled step's busy share; no skipped update; mse falling to ≤ ½), and
   the sampler's counts over DENSE_STATS_STEPS more batches;
   (c) phase 6's CLI check on the same scene with PAPER_DENSE_FLAGS after
   the r4 flags, resumed to DENSE_CLI_STEPS.

The last three lines of output are the kernel table as JSON (the four
kernels: `field_interp` forward and backward, with `launches` counted over
phase 7(c), the dense CLI, each phase's counts beside them, their phase-3
times at the r4 shapes and their phase-7(b) times at the dense ones under
"dense"; the earlier `fused_interp` design, launched by phase 3 only), the
card's name and power limit from nvidia-smi, and `{"ok": true, "device":
{...}}`.
Usage: python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch
import torch.nn.functional as F

from humanrf_torch import run as cli
from humanrf_torch.convert import convert_params
from humanrf_torch.core import image_io
from humanrf_torch.core.dataset import VolumetricDataset
from humanrf_torch.core.synthetic import make_cameras, render_cameras
from humanrf_torch.models import decomposition4d, fused_field
from humanrf_torch.models.hash_encoding import HashGridConfig
from humanrf_torch.models.humanrf import HumanRFConfig, HumanRFModel, segment_grid_config
from humanrf_torch.ops import field_interp as fli
from humanrf_torch.ops import fused_interp as fi
from humanrf_torch.ops.cuda_build import load_library
from humanrf_torch.r4 import NUM_FRAMES, PAPER_DENSE_FLAGS, R4_SCENE, r4_flags, write_scene
from humanrf_torch.train.partitioning import compute_adaptive_segment_sizes
from humanrf_torch.train.checkpoint import load_checkpoint
from humanrf_torch.train import pipeline
from humanrf_torch.train.pipeline import make_train_step
from humanrf_torch.train.trainer import make_optimizer, render_image, render_pipeline_config, sample_batch
from humanrf_torch.utils.rngs import fold_in, make_key
from humanrf_torch.view_inputs import load_dense_inputs, load_train_inputs, load_view_inputs

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
# Sample counts of the random positions for the field_interp checks: one
# field query of a 16,384-ray batch × 16 samples, and fewer at T = 2^19.
FIELD_RANDOM_N = {"grids": 262_144, "vectors": 262_144, "capacity": 65_536}

# The least time of a call (H100 SXM peak rates): each input
# read once and each output written once over the HBM rate, or its fp32 and
# integer operations over the fp32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# Operations per sample and pair of the corner math: grid 15 for the three
# axes' scale, floor and fractions, then 9 per corner (3 adds of the corner
# bits, 2 multiplies and 2 xors of the hash, its mask, 2 weight multiplies);
# vector 8.
CORNER_OPS = {8: 15 + 8 * 9, 2: 8}


def bound(nbytes: float, ops: float) -> tuple:
    """→ (bound_ms, "bytes" or "operations")."""
    by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * ops / FP32_OPS_PER_S
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


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
AB_WARM_STEPS = 2          # phase 5's old/new windows: steps before each timed window
AB_STEPS = 10              # phase 5's old/new windows: timed steps each

EARLY_STEPS = 20           # phases 6 and 7(c): the first CLI run, validated and saved at its end
CLI_STEPS = 600            # phase 6: resumed to this step, validated and saved every CLI_STEPS / 2
RESUME_STEPS = 20          # phases 6 and 7(c): steps of the resumed run

# Phase 7(a): the r4 run's dense settings (runs_evidence/r4_full_schedule_748/
# config.yaml: 512 lattice points per ray, samples_max_batch_size 65,536 and
# candidate_budget 0, i.e. 2 × 65,536, per rays_initial_batch_size 1,024),
# scaled to each render batch as the trainer scales them.
R4_DENSE = dict(num_rays=1024, samples_per_ray=512, candidate_budget=131_072, sample_budget=65_536)
DENSE_PATCH_PSNR_MIN = 40.0  # dB, the port's dense render of the baked patch vs the JAX package's
# Phase 7(b): the paper's dense step (configs/example_humanrf.py with the
# CLI's defaults): 8,192 rays, 1,024 lattice points per ray, 640,000 samples
# and 2 × 640,000 candidates per step, the visibility prune on.
DENSE_STEP_CONFIG = dict(sampling="dense", num_rays=8192, candidate_rays_factor=1, samples_per_ray=1024,
                         candidate_budget=1_280_000, sample_budget=640_000, bce_loss_weight=1e-3, huber_delta=0.01)
DENSE_STEPS = 120          # phase 7(b): timed steps (after WARM_STEPS) of a fresh paper-width model
DENSE_STATS_STEPS = 10     # phase 7(b): batches through the trained model's sampler for the counts
DENSE_CLI_STEPS = 300      # phase 7(c): resumed to this step, validated and saved every DENSE_CLI_STEPS / 2
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


def embedding_bag_inputs(tables, idx, w):
    """The (idx, w) lookup as `F.embedding_bag` bags: input (idx + p·T) as
    (P·N, C) bags, weight the tables as (P·T, F), per-sample weights w in the
    bags' layout. Its output is (P·N, F), the kernel's (P, F, N) transposed."""
    P, F_, T = tables.shape
    _, C, N = idx.shape
    bags = (idx.long() + torch.arange(P, device=idx.device)[:, None, None] * T).permute(0, 2, 1).reshape(P * N, C)
    weight = tables.permute(0, 2, 1).reshape(P * T, F_).contiguous()
    return bags.contiguous(), weight, w.permute(0, 2, 1).reshape(P * N, C).contiguous()


def library_times(tables, idx, w, g) -> dict:
    """`F.embedding_bag` (mode "sum", per-sample weights) on the same inputs,
    prepared outside the timed window: the forward's time, and the backward
    into the weight timed as (forward + backward) − forward."""
    P, F_, _ = tables.shape
    bags, weight, psw = embedding_bag_inputs(tables, idx, w)
    weight = weight.requires_grad_()
    g_bags = g.permute(0, 2, 1).reshape(-1, F_).contiguous()
    out = F.embedding_bag(bags, weight, mode="sum", per_sample_weights=psw)
    ref = fi.fused_interp_plain(tables, idx, w).permute(0, 2, 1).reshape(-1, F_)
    err = float((out.detach() - ref).abs().max() / ref.abs().max())
    fwd = time_ms(lambda: F.embedding_bag(bags, weight, mode="sum", per_sample_weights=psw))
    both = time_ms(lambda: torch.autograd.grad(
        F.embedding_bag(bags, weight, mode="sum", per_sample_weights=psw), weight, g_bags))
    return {"fwd": fwd, "bwd": both - fwd, "scaled_err": err}


def check_kernels(device) -> dict:
    """Each (idx, w) kernel against its plain version at KERNEL_SHAPES, random
    inputs with per-sample-normalised corner weights; its time, its plain
    version's, its bound and the time of `F.embedding_bag` on the same inputs.

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
    per_shape = {"fwd": [], "bwd": []}
    for name, P, C, F_, T, N in KERNEL_SHAPES:
        rng = np.random.default_rng(0)
        tables = torch.tensor(rng.normal(size=(P, F_, T)).astype(np.float32), device=device)
        idx = torch.tensor(rng.integers(0, T, (P, C, N)).astype(np.int32), device=device)
        w = rng.uniform(0, 1, (P, C, N)).astype(np.float32)
        w = torch.tensor(w / w.sum(axis=1, keepdims=True), device=device)  # corner weights sum to 1
        g = torch.tensor(rng.normal(size=(P, F_, N)).astype(np.float32), device=device)
        library = library_times(tables, idx, w, g)
        # idx and w, 8 B per corner and sample, then tables or g in, out or dtab out.
        nbytes = 8 * P * C * N + 4 * P * F_ * T + 4 * P * F_ * N
        for direction, (kernel, plain) in directions.items():
            out = kernel(tables, idx, w, g)
            ref = plain(tables, idx, w, g)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            scaled = err / float(ref.abs().max())
            if not scaled < KERNEL_TOL:
                raise AssertionError(f"fused_interp_{direction} kernel disagrees at {name} {(P, C, F_, T, N)}: "
                                     f"scaled err {scaled:.3e}")
            plain_ms = time_ms(lambda: plain(tables, idx, w, g))
            ms = time_ms(lambda: kernel(tables, idx, w, g))
            bound_ms, bound_by = bound(nbytes, 2 * P * C * F_ * N)
            log(f"kernel fused_interp_{direction} {name} P={P} C={C} F={F_} T={T} N={N}: max|err| {err:.3e} "
                f"(scaled {scaled:.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                f"embedding_bag {library[direction]:.4f} ms ({'forward' if direction == 'fwd' else '(forward + backward) − forward'}; "
                f"its scaled err {library['scaled_err']:.1e}), bound {bound_ms:.4f} ms ({bound_by}), "
                f"{100 * bound_ms / ms:.1f}% of it")
            per_shape[direction].append({"shape": name, "P": P, "C": C, "F": F_, "T": T, "N": N,
                                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                                         "library_ms": library[direction], "bound_ms": bound_ms,
                                         "bound_by": bound_by})
    return {direction: summarize(rows) for direction, rows in per_shape.items()}


def summarize(rows) -> dict:
    """A kernel's record: one field query is the grid call plus the vector
    call, so its times and bound are those two shapes' sums."""
    query = [r for r in rows if r["shape"] in ("grids", "vectors")]
    record = {"max_abs_err": max(r["max_abs_err"] for r in rows)}
    for key in ("ms", "plain_ms", "library_ms", "old_path_ms", "bound_ms"):
        if key in query[0]:
            record[key] = sum(r[key] for r in query)
    record["bound_by"] = "bytes" if all(r["bound_by"] == "bytes" for r in query) else "operations"
    record["per_shape"] = rows
    return record


def field_shapes(view) -> list:
    """(name, spec, P, F, T) of the field_interp checks: the r4 segment's
    grids and vectors (segment 0 of the model), and a reference-capacity
    grid (L16/F2, T = 2^19, base 32, finest 2048; levels 0-3 dense)."""
    seg = segment_grid_config(view.model_config, view.model_config.segment_sizes[0])
    grid, capacity = seg.grid, HashGridConfig()
    return [
        ("grids", fli.grid_spec(grid), 4 * grid.n_levels, grid.n_features_per_level, grid.table_size),
        ("vectors", fli.VECTOR_SPEC, 4, grid.feature_dim, seg.vectors_finest_resolution),
        ("capacity", fli.grid_spec(capacity), 4 * capacity.n_levels, capacity.n_features_per_level,
         capacity.table_size),
    ]


def fresh_model(device, view):
    """Phase 5's fresh model: initialised on the CPU from seed 0, the same
    start on any machine."""
    model = HumanRFModel(view.model_config)
    model.init_parameters(torch.Generator().manual_seed(0))
    return model.to(device)


def train_config(view):
    return dataclasses.replace(view.pipeline_config, **TRAIN_CONFIG)


def capture_queries(step, batch, pool, key) -> dict:
    """The (N, 4) sample coordinates of the largest field query of each pass
    of one training step: "render" (with autograd) and, under dense
    sampling, "prune" (without)."""
    captured = {"prune": [], "render": []}
    field = decomposition4d.apply_decomposition4d_fused

    def capture(params, xyz, times, field_cfg):
        captured["render" if torch.is_grad_enabled() else "prune"].append(torch.cat([xyz, times], dim=-1).detach().clone())
        return field(params, xyz, times, field_cfg)

    with mock.patch.object(decomposition4d, "apply_decomposition4d_fused", capture):
        step(batch, pool.pool, pool.grids, pool.aabb, key)
    return {k: max(v, key=len).contiguous() for k, v in captured.items() if v}


def capture_real_xyzt(device, view, pool) -> torch.Tensor:
    """The largest field query of phase 5's step 0 (its fresh model, its
    first batch and key), through the kernels."""
    model, cfg = fresh_model(device, view), train_config(view)
    batch = sample_batch(cfg, pool.pixel_rgba, torch.Generator(device).manual_seed(1))
    step = make_train_step(cfg, model, _GradientsOnly(model), pool.width, pool.height)
    return capture_queries(step, batch, pool, make_key(0, device))["render"]


def old_path(tables, xyzt, spec):
    """The path the field_interp kernels replace: the eager corner math, then
    the (idx, w) `fused_interp` kernels (differentiable in the tables)."""
    return fi.fused_interp(tables, *fli.corner_idx_w(xyzt, spec, tables.shape[2]))


def field_check(direction: str, dims: dict, kernel, plain, reference, old=None) -> dict:
    """One field_interp kernel call against `reference` (its plain version,
    the backward's summed in fp64) at `dims` (shape, positions, P, C, F, T,
    N); raises past KERNEL_TOL. Its time beside its plain version's, the old
    path's when given (in turns: old, new, new, old) and its bound → the row."""
    out, ref = kernel(), reference()
    torch.cuda.synchronize()
    err = float((out.double() - ref).abs().max())
    scaled = err / float(ref.abs().max())
    exact = bool(torch.equal(out, ref)) if direction == "fwd" else False
    P, C, F_, T, N = (dims[k] for k in ("P", "C", "F", "T", "N"))
    where = f"{dims['shape']} ({dims['positions']} positions) P={P} F={F_} T={T} N={N}"
    if not scaled < KERNEL_TOL:
        raise AssertionError(f"field_interp_{direction} kernel disagrees at {where}: scaled err {scaled:.3e}")
    plain_ms = time_ms(plain, iters=5)
    turns = {"old": [], "new": []}
    for which in ("old", "new", "new", "old") if old is not None else ("new",):
        turns[which].append(time_ms(kernel if which == "new" else old, iters=10))
    ms = float(np.mean(turns["new"]))
    # xyzt 16 B per sample, tables or g in, out or dtab out.
    bound_ms, bound_by = bound(16 * N + 4 * P * F_ * T + 4 * P * F_ * N, P * N * (CORNER_OPS[C] + 2 * C * F_))
    log(f"kernel field_interp_{direction} {where}: max|err| {err:.3e} (scaled {scaled:.3e}"
        f"{f', bit-exact {exact}' if direction == 'fwd' else ' against the fp64 sum'}), kernel "
        f"{', '.join(f'{t:.4f}' for t in turns['new'])} ms"
        + (f", old path {', '.join(f'{t:.4f}' for t in turns['old'])} ms" if old is not None else "")
        + f", plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of it")
    row = {**dims, "max_abs_err": err, "bit_exact": exact, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    if old is not None:
        row["old_path_ms"] = float(np.mean(turns["old"]))
    return row


def check_field_kernels(device, view, real_xyzt) -> dict:
    """Each field_interp kernel against its plain version at field_shapes,
    at uniform random and at real positions; its time beside its plain
    version's, the old path's (taken in turns: old, new, new, old) and its
    bound. The forward sums as its plain version does, without fma, and its
    bit-equality is reported. The backward is held to its plain version
    summed in fp64 (the same fp32 corner weights and cotangents): at real
    positions an entry sums up to ~10^5 terms (a segment's samples share one
    time, so the time vector's two taps take every sample), and an fp32 sum
    of n terms in sequence, as the plain scatter_add on the card makes it,
    moves by ~eps·√n ≈ 2e-5 of its size, more than the bar; the kernel's
    sums are hierarchical (runs, blocks, then the table) and stay within it."""
    rng = np.random.default_rng(0)
    positions = {
        "random": {name: torch.tensor(rng.uniform(0, 1, (n, 4)).astype(np.float32), device=device)
                   for name, n in FIELD_RANDOM_N.items()},
        "real": real_xyzt.contiguous(),
    }
    per_shape = {"fwd": [], "bwd": []}
    for name, spec, P, F_, T in field_shapes(view):
        C = 8 if spec.mode == fli.MODE_GRID else 2
        tables = torch.tensor(rng.normal(size=(P, F_, T)).astype(np.float32), device=device)
        for where in ("random", "real"):
            xyzt = positions[where][name] if where == "random" else positions[where]
            N = xyzt.shape[0]
            g = torch.tensor(rng.normal(size=(P, F_, N)).astype(np.float32), device=device)
            dims = {"shape": name, "positions": where, "P": P, "C": C, "F": F_, "T": T, "N": N}
            per_shape["fwd"].append(field_check(
                "fwd", dims, lambda: fli._launch_fwd(tables, xyzt, spec), lambda: fli.field_interp_plain(tables, xyzt, spec),
                lambda: fli.field_interp_plain(tables, xyzt, spec),
                old=lambda: fi._launch_fwd(tables, *fli.corner_idx_w(xyzt, spec, T))))
            per_shape["bwd"].append(field_check(
                "bwd", dims, lambda: fli._launch_bwd(g, xyzt, spec, T), lambda: fli.field_interp_bwd_plain(g, xyzt, spec, T),
                lambda: fli.field_interp_bwd_plain(g.double(), xyzt, spec, T),
                old=lambda: fi._launch_bwd(g, *fli.corner_idx_w(xyzt, spec, T), T)))
    records = {}
    for direction, rows in per_shape.items():
        # The record's times are at real positions, the main path's data.
        record = summarize([r for r in rows if r["positions"] == "real"])
        record["max_abs_err"] = max(r["max_abs_err"] for r in rows)
        record["per_shape"] = rows
        records[direction] = record
    return records


def ptxas_summary(log_text: str) -> list:
    """`-Xptxas -v` output → one entry per kernel: its name and template
    arguments (corners, feature chunk, staged), registers, spilled bytes."""
    rows, name, spill = [], None, "0"
    for line in log_text.splitlines():
        entry = re.search(r"Compiling entry function '(\w+)'", line)
        if entry:
            mangled = entry.group(1)
            name = re.search(r"([a-z_]+_kernel)", mangled).group(1)
            args = re.search(r"_kernelI((?:L[ib]\d+E)+)E", mangled)
            if args:
                name += "<" + ",".join(re.findall(r"L[ib](\d+)E", args.group(1))) + ">"
            spill = "0"
        elif name and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line).group(1)
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            rows.append(f"{name} {regs} regs, {spill} B spilled")
            name = None
    return rows


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


def train(device, view, pool) -> dict:
    """Phase 5 (see the module docstring). → the main path's launches."""
    model = fresh_model(device, view)
    cfg = train_config(view)
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
            with mock.patch.object(fused_field, "field_interp", fli.PlainFieldInterp.apply):
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
    fli.reset_launches()
    fi.reset_launches()
    start = None
    for i in range(TRAIN_STEPS):
        if i == WARM_STEPS:
            torch.cuda.synchronize()
            start = time.perf_counter()
        before = dict(fli.launches)
        b = sample_batch(cfg, pool.pixel_rgba, generator)
        loss, aux = step(b, pool.pool, pool.grids, pool.aabb, fold_in(key, torch.tensor(i, device=device)))
        per_step_launches.append({d: fli.launches[d] - before[d] for d in before})
        losses.append(loss)
        mses.append(aux["mse"])
        supervised.append(aux["num_rays_supervised"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches, old_launches = dict(fli.launches), dict(fi.launches)
    peak = torch.cuda.max_memory_allocated(device)

    losses, mses = torch.stack(losses).cpu(), torch.stack(mses).cpu()
    supervised = torch.stack(supervised).cpu()
    warm = TRAIN_STEPS - WARM_STEPS
    ms_per_step = 1e3 * seconds / warm
    log(f"train: {TRAIN_STEPS} steps, loss {float(losses[0]):.5f} → {float(losses[-1]):.5f}, "
        f"mse {float(mses[:5].mean()):.5f} (first 5) → {float(mses[-20:].mean()):.5f} (last 20); "
        f"skipped updates {int(optimizer.skipped)}; field_interp launches {launches}, fused_interp {old_launches}")
    log(f"train: {ms_per_step:.2f} ms per warm step (mean of {warm}, batch draw included), "
        f"{float(supervised[WARM_STEPS:].sum()) / seconds:.0f} supervised rays/s "
        f"({float(supervised.float().mean()):.0f} supervised rays per step), "
        f"peak memory {peak / 2**30:.2f} GiB")
    # Both segments are hit on every step: the pool holds frames 0 and 25.
    expected = {"fwd": 2 * 2, "bwd": 2 * 2}
    bad = [i for i, n in enumerate(per_step_launches) if n != expected]
    if bad or launches != {d: n * TRAIN_STEPS for d, n in expected.items()}:
        raise AssertionError(f"training launched field_interp {launches}; steps {bad[:5]} differ from {expected} per step")
    if old_launches != {"fwd": 0, "bwd": 0}:
        raise AssertionError(f"training launched the old fused_interp kernels {old_launches}")
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
    old_vs_new_windows(step, cfg, pool, generator, key, device)

    roi_after = held_out_roi_psnr(model, view)
    steps_run = TRAIN_STEPS + 1 + 4 * (AB_WARM_STEPS + AB_STEPS + 1)
    log(f"held-out {view.camera_name} frame {view.frame_number} after {steps_run} steps: "
        f"ROI-PSNR {roi_after:.3f} dB (before {roi_before:.3f} dB)")
    if not roi_after > roi_before:
        raise AssertionError("training did not raise the held-out view's ROI-PSNR")
    return launches


def old_vs_new_windows(step, cfg, pool, generator, key, device) -> None:
    """Training windows of the old path (eager corner math plus the (idx, w)
    kernels) and the new one in turns, old, new, new, old: ms per step, peak
    memory, and one profiled step's kernel count and busy share each."""
    results = {"old": [], "new": []}
    for turn, which in enumerate(("old", "new", "new", "old")):
        patch = mock.patch.object(fused_field, "field_interp", old_path) if which == "old" else contextlib.nullcontext()
        with patch:
            for i in range(AB_WARM_STEPS):
                step(sample_batch(cfg, pool.pixel_rgba, generator), pool.pool, pool.grids, pool.aabb,
                     fold_in(key, torch.tensor(10_000 + 100 * turn + i, device=device)))
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(device)
            t0 = time.perf_counter()
            for i in range(AB_STEPS):
                step(sample_batch(cfg, pool.pixel_rgba, generator), pool.pool, pool.grids, pool.aabb,
                     fold_in(key, torch.tensor(10_050 + 100 * turn + i, device=device)))
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0) / AB_STEPS
            peak = torch.cuda.max_memory_allocated(device)
            prof = profile_step(step, sample_batch(cfg, pool.pixel_rgba, generator), pool, key, device)
        results[which].append((ms, peak, prof))
        log(f"train A/B ({which} path): {ms:.2f} ms per step over {AB_STEPS}, peak memory {peak / 2**30:.3f} GiB; "
            f"profiled step: {prof['kernels']} kernels, {prof['device_ms']:.2f} ms device, busy "
            f"{100 * prof['device_ms'] / ms:.1f}%; top: {prof['top']}")
    for which, rows in results.items():
        log(f"train A/B ({which} path) mean: {np.mean([r[0] for r in rows]):.2f} ms per step, "
            f"peak {max(r[1] for r in rows) / 2**30:.3f} GiB, {np.mean([r[2]['kernels'] for r in rows]):.0f} kernels "
            f"per profiled step")


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


def write_r4_scene(device, root: Path) -> Path:
    """The r4 scene written by the port under `root` (its time; one JPEG
    decoded back against its render; adaptive partitioning) → the scene root."""
    scene = root / "scene"
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
    return scene


def cli_phase(name: str, scene: Path, ws: Path, flags, total_steps: int) -> dict:
    """Phases 6 and 7(c) (see the module docstring): `flags(steps, every)`
    is the run's command line. EARLY_STEPS steps validated and saved, then
    resumed to `total_steps` with validation and saves every half, the test
    frame rendered and evaluated, then RESUME_STEPS more. → the launches of
    the first two runs."""
    half = total_steps // 2
    evaluate = ["--training.checkpoint", "latest", "--evaluate", "true", "--evaluation.frame_numbers", "0"]
    torch.cuda.synchronize()
    fli.reset_launches()
    fi.reset_launches()
    t0 = time.perf_counter()
    cli.main(flags(EARLY_STEPS, EARLY_STEPS))
    result = cli.main(flags(total_steps, half) + evaluate)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, old_launches = dict(fli.launches), dict(fi.launches)
    stats = result["train"]
    blocks = validation_blocks(ws)
    means = {step: float(np.mean(v)) for step, v in blocks.items()}
    log(f"{name}: {EARLY_STEPS} steps, then resumed to {total_steps} + 3 validations + test render + evaluation "
        f"in {wall:.1f} s wall; field_interp launches {launches}, fused_interp {old_launches}; validation PSNR per "
        f"block {blocks}; evaluation {result['averages']}")
    log(f"{name}: trainer scale ({stats['steps']} steps timed): {stats['ms_per_step']:.2f} ms per step, "
        f"{stats['rays_per_s']:.0f} rays/s nominal, {stats['supervised_rays_per_s']:.0f} supervised rays/s, "
        f"host fetch {100 * stats['fetch_share']:.1f}% of the train time, "
        f"{stats['images_replaced_per_step']:.2f} pool images replaced per step")
    if sorted(blocks) != [EARLY_STEPS, half, total_steps] or any(
            len(v) != 3 or not np.isfinite(v).all() for v in blocks.values()):
        raise AssertionError(f"expected three validation blocks of 3 finite images, got {blocks}")
    if not min(means[half], means[total_steps]) > means[EARLY_STEPS]:
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
        raise AssertionError(f"the CLI run launched field_interp {launches}")
    if old_launches != {"fwd": 0, "bwd": 0}:
        raise AssertionError(f"the CLI run launched the old fused_interp kernels {old_launches}")

    resumed = cli.main(flags(total_steps + RESUME_STEPS, half) + ["--training.checkpoint", "latest"])["train"]
    log(f"{name}: resumed from step {resumed['start_step']} to {resumed['end_step']}")
    if (resumed["start_step"], resumed["end_step"]) != (total_steps, total_steps + RESUME_STEPS + 1):
        raise AssertionError(f"the resume ran steps {resumed['start_step']}..{resumed['end_step']}")
    return launches


# ------------------------------------------------------------------ phase 7


def sampler_counts(rays, candidates, pruned) -> dict:
    """One batch's dense-sampler counts: valid rays, candidates after the
    occupancy filter and samples after the prune (in all and the most on
    one ray), and the valid rays whose samples fit the candidate budget and
    both budgets."""
    counts = {"valid": int(rays.valid.sum()),
              "fit_candidates": int((rays.valid & candidates.ray_included).sum()),
              "fit": int((rays.valid & pruned.ray_included).sum())}
    for key, st in (("candidates", candidates), ("pruned", pruned)):
        n = int(st.num_valid)
        counts[key] = n
        counts[f"max_{key}"] = int(torch.bincount(st.ray[:n].long()).max()) if n else 0
    return counts


def add_counts(total: dict, counts: dict) -> dict:
    return {k: (max if k.startswith("max_") else sum)((total.get(k, 0), v)) for k, v in counts.items()}


def describe_counts(c: dict) -> str:
    valid = max(c["valid"], 1)
    return (f"{c['valid']} valid rays; per valid ray {c['candidates'] / valid:.1f} candidates after the occupancy "
            f"filter (max {c['max_candidates']}), {c['pruned'] / valid:.1f} samples after the prune (max "
            f"{c['max_pruned']}); {100 * c['fit_candidates'] / valid:.2f}% of valid rays fit the candidate budget, "
            f"{100 * c['fit'] / valid:.2f}% both budgets")


def dense_view_counts(model, pcfg, view) -> dict:
    """`sampler_counts` summed over the batches of a 748² view."""
    inputs = view.inputs
    width, height = inputs.width, inputs.height
    cfg = render_pipeline_config(pcfg, view.rays_batch_size)
    device = inputs.aabb.device
    n = view.rays_batch_size
    total = {}
    with torch.no_grad():
        for start in range(0, width * height, n):
            pixel_idx = torch.arange(start, start + n, device=device).clamp(max=width * height - 1).int()
            batch = pipeline.HostBatch(torch.full((n,), inputs.buffer_index, dtype=torch.int32, device=device),
                                       pixel_idx, torch.zeros((n, 4), device=device),
                                       torch.ones(n, dtype=torch.bool, device=device))
            rays = pipeline.build_rays(cfg, batch, inputs.pool, inputs.grids, inputs.aabb, width, height)
            candidates = pipeline.build_samples(cfg, rays, inputs.pool, inputs.grids, batch.buffer_idx)
            _, pruned = pipeline.prune_and_render(cfg, model, rays, candidates, 0.0)
            total = add_counts(total, sampler_counts(rays, candidates, pruned))
    return total


def dense_render(device, view, model, proposal_roi: float) -> dict:
    """Phase 7(a): best.ckpt's test view through the dense sampler at the r4
    run's settings, against its plain render and the JAX package's baked
    dense render of a patch. → the render's launches."""
    pcfg = dataclasses.replace(view.pipeline_config, sampling="dense", **R4_DENSE)
    width, height = view.inputs.width, view.inputs.height
    num_batches = -(-width * height // view.rays_batch_size)
    fli.reset_launches()
    fi.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render_image(model, pcfg, view.inputs, view.rays_batch_size)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, old_launches = dict(fli.launches), dict(fi.launches)
    times = {"plain": [], "kernel": []}
    for which in ("plain", "kernel", "kernel", "plain"):
        patch = (mock.patch.object(fused_field, "field_interp", fli.field_interp_plain) if which == "plain"
                 else contextlib.nullcontext())
        with patch:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = render_image(model, pcfg, view.inputs, view.rays_batch_size)
            torch.cuda.synchronize()
        times[which].append(time.perf_counter() - t0)
        if which == "plain":
            img_plain = out
    counts = dense_view_counts(model, pcfg, view)
    img_np = img.cpu().numpy()
    vs_plain = psnr(np.clip(img_np, 0, 1), np.clip(img_plain.cpu().numpy(), 0, 1))
    roi = roi_psnr(to_u8(img), view.images["gt_rgb"], view.images["gt_mask"])
    kernel_s = float(np.mean(times["kernel"]))
    log(f"dense render ({pcfg.samples_per_ray} lattice points per ray, budgets {R4_DENSE['candidate_budget']} / "
        f"{R4_DENSE['sample_budget']} per {R4_DENSE['num_rays']} rays, scaled to {view.rays_batch_size}-ray batches): "
        f"first {first_s:.3f} s; kernel {', '.join(f'{t:.3f}' for t in times['kernel'])} s "
        f"({1e3 * kernel_s / num_batches:.1f} ms per batch), plain {', '.join(f'{t:.3f}' for t in times['plain'])} s; "
        f"field_interp launches {launches}, fused_interp {old_launches}")
    log(f"dense render: per view {describe_counts(counts)}; PSNR(kernel, plain) = {vs_plain:.2f} dB; "
        f"ROI-PSNR vs ground truth {roi:.3f} dB (phase 4's proposal render {proposal_roi:.3f} dB)")
    if img_np.shape != view.images["gt_rgb"].shape or not np.isfinite(img_np).all():
        raise AssertionError(f"the dense render is not a finite image of the view's shape: {img_np.shape}")
    if not vs_plain >= RENDER_PSNR_MIN:
        raise AssertionError(f"dense kernel render differs from the plain render: {vs_plain:.2f} dB < {RENDER_PSNR_MIN}")
    if launches["fwd"] == 0 or launches["bwd"] != 0 or old_launches != {"fwd": 0, "bwd": 0}:
        raise AssertionError(f"the dense render launched field_interp {launches} and fused_interp {old_launches}")

    # The baked patch, batch by batch at the baked settings.
    dense = load_dense_inputs(RUN_DIR / "torch_dense_inputs.npz", device)
    render_fn = pipeline.make_render_fn(dense.pipeline_config, model, width, height)
    colors = []
    for pixel_idx in dense.pixel_idx:
        n = pixel_idx.shape[0]
        batch = pipeline.HostBatch(torch.full((n,), view.inputs.buffer_index, dtype=torch.int32, device=device),
                                   pixel_idx, torch.zeros((n, 4), device=device),
                                   torch.ones(n, dtype=torch.bool, device=device))
        out, _ = render_fn(batch, view.inputs.pool, view.inputs.grids, view.inputs.aabb, 0.0)
        colors.append(out.color.cpu().numpy())
    vs_jax = psnr(np.stack(colors), dense.jax_color)
    log(f"dense render of the baked {len(colors)}×{dense.pixel_idx.shape[1]}-ray patch: PSNR(port, JAX) = {vs_jax:.2f} dB")
    if not vs_jax >= DENSE_PATCH_PSNR_MIN:
        raise AssertionError(f"the dense patch is {vs_jax:.2f} dB from the JAX render (< {DENSE_PATCH_PSNR_MIN})")
    return launches


def paper_model(device):
    """Phase 7(b)'s fresh model: example_humanrf's field (L16/F2, log2
    hashmap 19, so T = 2^17 per 25-frame segment, coarsest 32, finest 2048,
    camera embedding 2), no proposal, initialised on the CPU from seed 0."""
    model = HumanRFModel(HumanRFConfig(sorted_frame_numbers=tuple(range(NUM_FRAMES)), segment_sizes=(25, 25),
                                       camera_embedding_dim=2))
    model.init_parameters(torch.Generator().manual_seed(0))
    return model.to(device)


def check_dense_kernels(device, model, queries) -> dict:
    """Each field_interp kernel against its plain version at the dense step's
    shapes and real positions: the grids (P = 64, F = 2, T = 2^17) and the
    vectors (P = 4, F = 32, R = 2048) at the render pass's query (forward and
    backward) and the prune pass's (forward; it has no backward). Bars and
    references as phase 3's."""
    seg = model.segment_grid_configs[0]
    shapes = [("grids", fli.grid_spec(seg.grid), 4 * seg.grid.n_levels, seg.grid.n_features_per_level,
               seg.grid.table_size),
              ("vectors", fli.VECTOR_SPEC, 4, seg.feature_dim, seg.vectors_finest_resolution)]
    rng = np.random.default_rng(1)
    rows = {"fwd": [], "bwd": []}
    for name, spec, P, F_, T in shapes:
        tables = torch.tensor(rng.normal(size=(P, F_, T)).astype(np.float32), device=device)
        for where, xyzt in queries.items():
            N = xyzt.shape[0]
            dims = {"shape": name, "positions": where, "P": P, "C": 8 if spec.mode == fli.MODE_GRID else 2,
                    "F": F_, "T": T, "N": N}
            rows["fwd"].append(field_check(
                "fwd", dims, lambda: fli._launch_fwd(tables, xyzt, spec), lambda: fli.field_interp_plain(tables, xyzt, spec),
                lambda: fli.field_interp_plain(tables, xyzt, spec)))
            if where == "render":
                g = torch.tensor(rng.normal(size=(P, F_, N)).astype(np.float32), device=device)
                rows["bwd"].append(field_check(
                    "bwd", dims, lambda: fli._launch_bwd(g, xyzt, spec, T),
                    lambda: fli.field_interp_bwd_plain(g, xyzt, spec, T),
                    lambda: fli.field_interp_bwd_plain(g.double(), xyzt, spec, T)))
    # A record per direction: one field query (grids + vectors) of the render pass.
    return {d: summarize([r for r in rs if r["positions"] == "render"]) | {"per_shape": rs} for d, rs in rows.items()}


def dense_train(device, pool) -> tuple:
    """Phase 7(b): the dense step at the paper's field width (see the module
    docstring). → (its launches, the kernels' dense records)."""
    model = paper_model(device)
    cfg = pipeline.PipelineConfig(**DENSE_STEP_CONFIG)
    log(f"dense step: fresh paper-width model, {sum(p.numel() for p in model.parameters())} parameters, "
        f"T = {model.segment_grid_configs[0].grid.table_size} per segment; {cfg}")
    generator = torch.Generator(device).manual_seed(2)
    key = make_key(0, device)
    width, height = pool.width, pool.height

    batch = sample_batch(cfg, pool.pixel_rgba, generator)
    grads_step = make_train_step(cfg, model, _GradientsOnly(model), width, height)
    queries = capture_queries(grads_step, batch, pool, key)
    log(f"dense step-0 queries: render pass {queries['render'].shape[0]} samples, prune pass "
        f"{queries['prune'].shape[0]} (the segment with the most of each)")
    records = check_dense_kernels(device, model, queries)
    del queries

    runs = {}
    for which in ("kernel", "plain"):
        patch = (mock.patch.object(fused_field, "field_interp", fli.PlainFieldInterp.apply) if which == "plain"
                 else contextlib.nullcontext())
        with patch:
            loss, _ = grads_step(batch, pool.pool, pool.grids, pool.aabb, key)
        runs[which] = (float(loss), {n: p.grad.clone() for n, p in model.named_parameters()})
    (loss_k, grads_k), (loss_p, grads_p) = runs["kernel"], runs["plain"]
    rel = abs(loss_k - loss_p) / abs(loss_p)
    cosines = {n: cosine(grads_k[n], grads_p[n]) for n in grads_k}
    worst = min(cosines, key=cosines.get)
    log(f"dense step-0 A/B: loss kernel {loss_k:.7f}, plain {loss_p:.7f} (rel {rel:.2e}); "
        f"gradient cosine min {cosines[worst]:.7f} ({worst})")
    if not rel <= STEP0_LOSS_REL:
        raise AssertionError(f"dense step-0 loss through the kernels differs from the plain run by {rel:.2e} relative")
    if not cosines[worst] >= STEP0_GRAD_COSINE:
        raise AssertionError(f"dense step-0 gradient of {worst} has cosine {cosines[worst]:.7f} to the plain run's")
    del runs, grads_k, grads_p
    model.zero_grad(set_to_none=True)

    optimizer = make_optimizer(model.named_parameters(), lr=1e-2, lr_decay=0.5, max_steps=50_001, weight_decay=0.03)
    step = make_train_step(cfg, model, optimizer, width, height)
    losses, mses, supervised, per_step = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    fli.reset_launches()
    fi.reset_launches()
    start = None
    for i in range(DENSE_STEPS):
        if i == WARM_STEPS:
            torch.cuda.synchronize()
            start = time.perf_counter()
        before = dict(fli.launches)
        b = sample_batch(cfg, pool.pixel_rgba, generator)
        loss, aux = step(b, pool.pool, pool.grids, pool.aabb, fold_in(key, torch.tensor(i, device=device)))
        per_step.append({d: fli.launches[d] - before[d] for d in before})
        losses.append(loss)
        mses.append(aux["mse"])
        supervised.append(aux["num_rays_supervised"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches, old_launches = dict(fli.launches), dict(fi.launches)
    peak = torch.cuda.max_memory_allocated(device)
    losses, mses, supervised = torch.stack(losses).cpu(), torch.stack(mses).cpu(), torch.stack(supervised).cpu()
    warm = DENSE_STEPS - WARM_STEPS
    ms_per_step = 1e3 * seconds / warm

    counts = {}
    with torch.no_grad():
        for i in range(DENSE_STATS_STEPS):
            b = sample_batch(cfg, pool.pixel_rgba, generator)
            rays = pipeline.build_rays(cfg, b, pool.pool, pool.grids, pool.aabb, width, height)
            candidates = pipeline.build_samples(cfg, rays, pool.pool, pool.grids, b.buffer_idx)
            _, pruned = pipeline.prune_and_render(cfg, model, rays, candidates, 0.0,
                                                  fold_in(key, torch.tensor(50_000 + i, device=device)))
            counts = add_counts(counts, sampler_counts(rays, candidates, pruned))
    prof = profile_step(step, sample_batch(cfg, pool.pixel_rgba, generator), pool, key, device)

    log(f"dense step: {DENSE_STEPS} steps, loss {float(losses[0]):.5f} → {float(losses[-1]):.5f}, mse "
        f"{float(mses[:5].mean()):.5f} (first 5) → {float(mses[-20:].mean()):.5f} (last 20); skipped updates "
        f"{int(optimizer.skipped)}; field_interp launches {launches} ({per_step[-1]} in the last step), fused_interp {old_launches}")
    log(f"dense step: {ms_per_step:.2f} ms per warm step (mean of {warm}, batch draw included), "
        f"{cfg.num_rays * warm / seconds:.0f} rays/s, {float(supervised[WARM_STEPS:].sum()) / seconds:.0f} supervised rays/s "
        f"({float(supervised.float().mean()):.0f} supervised rays per step), peak memory {peak / 2**30:.2f} GiB")
    log(f"dense step: {DENSE_STATS_STEPS} more batches through the trained model's sampler (no update): "
        f"{describe_counts(counts)}")
    log(f"dense step: one profiled warm step: {prof['kernels']} kernels, {prof['device_ms']:.2f} ms of device time "
        f"in {prof['wall_ms']:.1f} ms profiled wall; device busy {100 * prof['device_ms'] / ms_per_step:.1f}% "
        f"of a {ms_per_step:.2f} ms warm step; top: {prof['top']}")
    if old_launches != {"fwd": 0, "bwd": 0} or launches["fwd"] == 0 or launches["bwd"] == 0:
        raise AssertionError(f"the dense step launched field_interp {launches} and fused_interp {old_launches}")
    if not torch.isfinite(losses).all():
        raise AssertionError("non-finite dense training loss")
    if int(optimizer.skipped) != 0:
        raise AssertionError(f"{int(optimizer.skipped)} dense updates skipped as non-finite")
    if not float(mses[-20:].mean()) <= MSE_DROP * float(mses[:5].mean()):
        raise AssertionError("dense training mse did not fall to half its start")
    return launches, records


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

    # Phase 2: build, both libraries side by side.
    with ThreadPoolExecutor(2) as pool:
        built = dict(zip(("field_interp", "fused_interp"), pool.map(load_library, ("field_interp", "fused_interp"))))
    for name, lib in built.items():
        log(f"build: {lib.path.name} in {lib.build_seconds:.2f} s; per kernel, from -Xptxas -v (shared memory is "
            f"dynamic, set at launch): " + "; ".join(ptxas_summary(lib.ptxas_log)))

    # Phase 3: the kernels against their plain versions, random and real positions.
    view = load_view_inputs(RUN_DIR / "torch_view_inputs.npz", device)
    train_pool = load_train_inputs(RUN_DIR / "torch_train_inputs.npz", device)
    old_kernels = check_kernels(device)
    real_xyzt = capture_real_xyzt(device, view, train_pool)
    log(f"real positions: {real_xyzt.shape[0]} samples of phase 5's step-0 field query (segment with the most)")
    new_kernels = check_field_kernels(device, view, real_xyzt)
    for direction, record in new_kernels.items():
        log(f"field_interp_{direction} at real positions, one field query (grids + vectors): "
            f"{record['ms']:.4f} ms against the old path's {record['old_path_ms']:.4f} ms "
            f"({record['old_path_ms'] / record['ms']:.2f}×), bound {record['bound_ms']:.4f} ms")

    # Phase 4: the render.
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

    fli.reset_launches()
    fi.reset_launches()
    img, first_s = timed_render(model, view)
    launches, old_launches = dict(fli.launches), dict(fi.launches)
    log(f"render (kernel, first): {first_s:.3f} s, {num_pixels / first_s:.0f} rays/s, field_interp launches "
        f"{launches}, fused_interp {old_launches}")
    if launches != {"fwd": expected_launches, "bwd": 0} or old_launches != {"fwd": 0, "bwd": 0}:
        raise AssertionError(f"the render launched field_interp {launches} and fused_interp {old_launches}, "
                             f"expected {expected_launches} field_interp forward and nothing else")

    # Warm renders in turns: plain (the field's kernel call swapped for its
    # plain version), old (eager corners plus the (idx, w) kernel), new.
    times = {"plain": [], "old": [], "new": []}
    swaps = {"plain": fli.field_interp_plain, "old": old_path}
    for which in ("plain", "old", "new", "new", "old", "plain"):
        if which in swaps:
            with mock.patch.object(fused_field, "field_interp", swaps[which]):
                out, seconds = timed_render(model, view)
            if which == "plain":
                img_plain = out
        else:
            _, seconds = timed_render(model, view)
        times[which].append(seconds)
    for which, runs in times.items():
        mean = sum(runs) / len(runs)
        log(f"render ({which}): " + ", ".join(f"{t:.3f}" for t in runs)
            + f" s; mean {mean:.3f} s, {1e3 * mean / num_batches:.1f} ms per batch, {num_pixels / mean:.0f} rays/s")

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
    train_launches = train(device, view, train_pool)

    with tempfile.TemporaryDirectory(prefix="humanrf_r4_") as tmp:
        scene = write_r4_scene(device, Path(tmp))
        # Phase 6: the CLI.
        ws = Path(tmp) / "workspace"
        cli_launches = cli_phase("cli", scene, ws, lambda steps, every: r4_flags(scene, ws, steps, every), CLI_STEPS)

        # Phase 7: dense sampling.
        dense_render_launches = dense_render(device, view, model, port_roi)
        dense_step_launches, dense_records = dense_train(device, train_pool)
        dense_ws = Path(tmp) / "dense_workspace"
        dense_cli_launches = cli_phase(
            "dense cli", scene, dense_ws,
            lambda steps, every: r4_flags(scene, dense_ws, steps, every) + PAPER_DENSE_FLAGS,
            DENSE_CLI_STEPS)

    by_phase = {"render": launches, "train_step": train_launches, "cli": cli_launches,
                "dense_render": dense_render_launches, "dense_step": dense_step_launches, "dense_cli": dense_cli_launches}
    records = [
        {
            "name": f"field_interp_{direction}",
            "route": "cuda",
            "source": "humanrf_torch/csrc/field_interp.cu",
            "replaces": f"humanrf_tpu/ops/fused_interp.py:{line}",
            "launches": dense_cli_launches[direction],
            "launches_by_phase": {phase: counts[direction] for phase, counts in by_phase.items()},
            "library_ms": None,  # no one PyTorch call computes the corners and the lookup
            **new_kernels[direction],
            "dense": dense_records[direction],
        }
        for direction, line in (("fwd", 87), ("bwd", 97))
    ] + [
        {
            "name": f"fused_interp_{direction}",
            "route": "cuda",
            "source": "humanrf_torch/csrc/fused_interp.cu",
            "replaces": f"humanrf_tpu/ops/fused_interp.py:{line}",
            "launches": 0,  # the earlier design: off the main path, launched by phase 3 only
            "launches_by_phase": {phase: 0 for phase in by_phase},
            **old_kernels[direction],
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
