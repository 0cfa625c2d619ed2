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
  with the paper's field and sampler on the r4 scene;
- the CLI's trajectory phases with best.ckpt, the occupancy carve of the
  toolbox, and a CLI training run with the light-bloom filter, the
  profiler and the TensorBoard events;
- multi-GPU training (`humanrf_torch/parallel`): the data-parallel and
  FSDP steps on spawned ranks, and the CLI with `--tpu.num_devices 2`;
- the mesh tools: the subject of the r4 scene as meshes, through an
  Alembic archive and the port's extractor, rasterized into masks and
  depth maps by the hand-written `mesh_raster` kernels, through the mesh
  renderer's CLI and on to the occupancy carve;
- the protocol drivers (`humanrf_torch/protocol/`), each through its own
  entry point and cut to fit: the evaluate phase of the banked best.ckpt,
  the parallax probe, the four-segment run, the reference-capacity field
  (T = 2^22 per level) and the throughput probe.

The earlier design, the (idx, w) `fused_interp` kernels fed by eager corner
math ("the old path"), is off the main path; phases 3-5 time it beside the
new kernels in the same call.

Phases, each of which raises on failure:

1. device: a CUDA Hopper card (capability 9.0) is required;
2. build: `humanrf_torch/csrc/field_interp.cu`, `fused_interp.cu` and
   `mesh_raster.cu` with nvcc for sm_90a, side by side (registers, shared
   memory and spills from `-Xptxas -v`);
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
   the r4 flags, resumed to DENSE_CLI_STEPS;
8. the CLI's other features, on phase 6's scene:
   (1) the trajectory phases: `humanrf_torch.run.main` with the r4 flags,
   `--train false --evaluate false`, `--test.checkpoint` best.ckpt, a keycam
   path through TRAJ_KEYCAMS of TRAJ_VIEWS cameras and a calibration file
   of TRAJ_CSV_CAMERAS copied verbatim: 50 + 50 frames %06d.png, each of
   the scene's size with a subject coverage in COVERAGE_RANGE; the
   calibration file's view 0 ≥ CALIB_VIEW_PSNR_MIN from the test render of
   the same camera and frame, the keycam path's view 0 (t = 1e-5 from key
   camera 0) ≥ KEYCAM_ENDPOINT_PSNR_MIN from key camera 0's; forward
   launches counted, no backward; s per view, and whether ffmpeg wrote a
   video;
   (2) the occupancy carve of all 50 frames at CARVE_RESOLUTION³ on the card
   (`toolbox/generate_occupancy_grids_from_masks`, threshold
   CARVE_THRESHOLD, on a copy of the masks): frames CARVE_CHECK_FRAMES equal
   the CPU's carve voxel for voxel, every frame's hull covers ≥
   CARVE_CORE_MIN of its scene grid's core; ms per frame;
   (3) BLOOM_STEPS CLI steps from a fresh workspace with
   `--dataset.filter_light_bloom true` (discs of BLOOM_RADIUS on the subject
   in BLOOM_CAMERAS, written into `light_annotations.csv` and restored after)
   and `--tpu.profile_dir`: a filtered pool-pixel share > 0, no skipped
   update, supervised rays/s beside phase 6's; the events file read back
   with every record's CRC, holding JAX_SCALAR_TAGS and the comparison
   images; one trace, of steps 20–24, whose `field_interp` kernels equal the
   launches counted in its window;
9. multi-GPU training, every rank a spawned process (`parallel/launch.py`)
   running `parallel/harness.py::run_steps` on inputs saved to a file. The
   card is one, and NCCL refuses two ranks on one GPU, so ranks that share
   cuda:0 talk over gloo through host memory, and NCCL runs at world size 1;
   a time of the shared-card runs is a harness number, not a scaling one.
   The parity runs (a)-(c) use fresh models of PARALLEL_DENSITY_SCALE (see
   there).
   (a) data-parallel, PARALLEL_RANKS ranks on cuda:0 at the r4 width
   (16,384 slots): at candidate factor 1 the step-0 loss within
   STEP0_LOSS_REL and the summed gradient at cosine ≥ STEP0_GRAD_COSINE
   per parameter against one process's step on the same batch and key; at
   factor 2 the same bars against an emulation in this process (each rank's
   block through the single-device step with its global ray ids, the means
   combined by supervised rays); then PARALLEL_STEPS AdamW steps after which
   every rank's parameters are bit-equal, no update skipped; ms per step and
   the bytes all-reduced per step;
   (b) NCCL at world size 1 on cuda:0: the data-parallel and the FSDP step
   for PARALLEL_STEPS AdamW steps each at the r4 width, against one process
   run twice: the step-0 losses bit-equal, the step-0 summed gradient at
   cosine ≥ STEP0_GRAD_COSINE per parameter, the losses of the first
   PARALLEL_LOSS_STEPS steps within max(STEP0_LOSS_REL, 4× one process's
   own run-to-run spread) (the backward kernel sums in fp32 atomics, so no
   run is bit-equal to another after step 0); the parameters' distance
   after the steps printed beside that spread; ms per step beside one
   process's;
   (c) FSDP, PARALLEL_RANKS ranks on cuda:0 at the paper's field width (T =
   2^17, phase 7(b)'s dense step, budgets halved per rank): PARALLEL_STEPS
   SGD steps against one process's, the step-0 loss within STEP0_LOSS_REL
   and every gathered parameter within PARALLEL_RTOL / PARALLEL_ATOL
   (tests/test_fsdp.py's bars); AdamW steps after which each rank holds 1/2
   of the table parameters and of both moments; each rank's peak memory;
   (d) the CLI, `humanrf_torch.run.main(..., allow_shared_device=True)`
   with the r4 flags at candidate factor 1 and the deterministic loader on
   phase 6's scene, data-parallel
   and FSDP on PARALLEL_RANKS ranks: PARALLEL_CLI_STEPS steps validated and
   saved, the workspace's files those of one process's run of the same
   flags, one events file, the step-1 loss within STEP0_LOSS_REL of one
   process's, then a resume in one process;
   where the machine has ≥ 2 GPUs, (a) and (c) again over NCCL on
   min(count, 4) ranks, one GPU each; else one line says so;
10. the mesh tools on phase 6's scene (`humanrf_torch/toolbox/`
   `mesh_renderer`, `alembic_extractor`, `mesh_io`; `ops/rasterize.py`):
   (a) the subject of each of the 50 frames tessellated on the scene's own
   geometry (`core/synthetic.py::subject_mesh`: ≥ MESH_MIN_TRIANGLES
   triangles, 32 segments around each rod), written as OBJ, packed into
   one .abc by `write_alembic.objs_to_abc` and extracted by the port's
   extractor: every extracted mesh equals the written one (vertices within
   rtol 1e-6, faces equal); s per frame of each step;
   (b) all 600 views rasterized on the card (launches: one of each kernel
   per frame), each view's mask IoU against the scene's analytic mask ≥
   MESH_IOU_MIN (min and median printed); at MESH_AB_FRAMES, each kernel
   against its plain version on the same inputs, and the views against the
   plain resolve, bit for bit; kernel ms per view (CUDA events), plain ms,
   fragments per view, the bound and its share;
   (c) the mesh renderer's CLI for MESH_CLI_FRAMES with --mask --depth
   into a copy of the scene: every PFM and mask reads back as the kernel's
   view; s per view with the file writes; the carve (128³, threshold 12)
   of those frames from the mesh's masks against the carve from the
   scene's: occupied-voxel IoU ≥ MESH_CARVE_IOU_MIN;
   (d) frame 0 in RIG_CAMERAS cameras (`make_cameras` of the r4 scene, the
   ActorsHQ rig's count) at 748²: cameras RIG_CHECK_CAMERAS bit-equal to
   the plain version; ms per view;
11. the protocol drivers, each run in this process with its CLI commands
   in this process too (`drivers_in_process`), so that the launches are
   counted here:
   (a) `finish_phases --skip-trajectory` from the banked best.ckpt on phase
   6's scene (stamped as full_schedule's cache): the 17 Cam012 frames of
   siggraph_test coverage, each row's masked PSNR within EVAL_PSNR_SLACK of
   the banked JAX metrics.csv row, the mean SSIM within EVAL_SSIM_SLACK of
   the banked mean; per-frame deltas, and the PSNR of the port's renders of
   EVAL_IMAGE_FRAMES against the banked JAX renders; the random-feature
   LPIPS on the card within LPIPS_TOL of the CPU's;
   (b) `parallax_probe` at PARALLAX_FRAMES, eight views: every row finite,
   the 330° replica's masked PSNR within EVAL_PSNR_SLACK of (a)'s frame-0
   row;
   (c) `multiseg` at MULTISEG_SIZE², 100 frames, MULTISEG_STEPS steps and
   one validation: segments [25, 25, 25, 25], finite losses, the mean of the
   last 10 below that of the first 10, the checkpoint reloaded into a fresh
   model; ms and launches per step beside phase 6's two-segment step;
   (d) `quality_at_capacity`'s gather-ref-capacity arm (T = 2^22) at
   CAPACITY_SIZE², CAPACITY_FRAMES frames, CAPACITY_STEPS steps without
   validation or saves: each field_interp kernel at step 0's render query
   against its plain version (phase 3's bars), a finite step-0 loss, no
   skipped update; peak memory and ms per step;
   (e) `throughput_probe`, THROUGHPUT_STEPS steps resumed from the banked
   step_00050000.ckpt: ms per step and rays/s.

The last three lines of output are the kernel table as JSON (the six
kernels: `field_interp` forward and backward, with `launches` counted over
phase 11, each phase's counts beside them, their phase-3 times at the r4
shapes, their phase-7(b) times at the dense ones under "dense" and their
11(d) times at T = 2^22 under "ref_capacity"; the
earlier `fused_interp` design, launched by phase 3 only; `mesh_project`
and `mesh_raster`, with `launches` counted over 10(b), their times per
view at 10(b)'s frames and 10(d)'s under "rig_ms"), the card's name and
power limit from nvidia-smi, and `{"ok": true, "device": {...}}`.
Usage: python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import shutil
import struct
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
from humanrf_torch.configs.args import parse_args
from humanrf_torch.core.dataset import VolumetricDataset
from humanrf_torch.data.loader import DataLoader
from humanrf_torch.core.camera import write_calibration_csv
from humanrf_torch.core.synthetic import GENERATOR_VERSION, make_cameras, render_cameras, subject_mesh
from humanrf_torch.evaluation.metrics import LpipsModel
from humanrf_torch.models import decomposition4d, fused_field
from humanrf_torch.models.hash_encoding import HashGridConfig
from humanrf_torch.models.humanrf import HumanRFConfig, HumanRFModel, segment_grid_config
from humanrf_torch.ops import field_interp as fli
from humanrf_torch.ops import fused_interp as fi
from humanrf_torch.ops import rasterize as raster
from humanrf_torch.ops.cuda_build import load_library
from humanrf_torch.parallel import harness
from humanrf_torch.parallel.launch import launch
from humanrf_torch.parallel.mesh import shard_pipeline_config
from humanrf_torch.protocol import finish_phases, multiseg, parallax_probe, quality_at_capacity, supervisor
from humanrf_torch.protocol import throughput_probe
from humanrf_torch.r4 import NUM_FRAMES, PAPER_DENSE_FLAGS, R4_SCENE, r4_flags, write_scene
from humanrf_torch.train.partitioning import compute_adaptive_segment_sizes
from humanrf_torch.train.checkpoint import load_checkpoint
from humanrf_torch.train import pipeline
from humanrf_torch.train import trainer as trainer_module
from humanrf_torch.train.pipeline import make_train_step
from humanrf_torch.toolbox import alembic_extractor, mesh_io, mesh_renderer
from humanrf_torch.toolbox import generate_occupancy_grids_from_masks as occ
from humanrf_torch.toolbox.write_alembic import objs_to_abc
from humanrf_torch.train.trainer import Trainer, make_optimizer, render_image, render_pipeline_config, sample_batch
from humanrf_torch.utils.profiling import Trace
from humanrf_torch.utils.rngs import fold_in, make_key
from humanrf_torch.utils.summary import masked_crc32c
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
CLI_STEPS = 200            # phase 6: resumed to this step, validated and saved every CLI_STEPS / 2
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
DENSE_CLI_STEPS = 200      # phase 7(c): resumed to this step, validated and saved every DENSE_CLI_STEPS / 2
# Phase 8.1: the trajectory phases through the CLI on the r4 scene with
# best.ckpt: a keycam path of TRAJ_VIEWS cameras (the JAX r4 run rendered 50
# trajectory views) and a calibration file of four of the scene's cameras,
# rows copied verbatim, the test camera first.
TRAJ_KEYCAMS = (0, 4, 8)
TRAJ_VIEWS = 50
TRAJ_CSV_CAMERAS = (11, 2, 5, 9)
CALIB_VIEW_PSNR_MIN = 50.0      # dB: the same camera and frame as the test render, the same kernel
# dB: key camera 0 moved by t = 1e-5 of the path (CPU rehearsal at 96²:
# 62.49 dB; the path's next view, t = 1/49, reads 28.34 dB against it).
KEYCAM_ENDPOINT_PSNR_MIN = 40.0
COVERAGE_LEVEL = 8              # a pixel shows the subject when a channel is above this (black background)
COVERAGE_RANGE = (0.03, 0.12)   # share of a view's pixels (CPU rehearsal at 96²: 0.0561–0.0617)
# Phase 8.2: the occupancy carve of all frames; every camera must see a voxel.
CARVE_RESOLUTION, CARVE_THRESHOLD = 128, 12
CARVE_CHECK_FRAMES = (0, 25)
CARVE_CORE_MIN = 0.95           # the hull's share of the scene grid's core (tests/test_exporters.py)
# Phase 8.3: a fresh CLI run with light-bloom discs, a profiled window and the events.
BLOOM_STEPS = 30
BLOOM_CAMERAS = (0, 1, 2)       # train cameras of the derived split
BLOOM_RADIUS = 40               # px
# The JAX trainer's scalar tags (humanrf_tpu/train/trainer.py:398-415, 527)
# that a run which validates and skips no update writes (the step-500
# `stability/skipped_nonfinite_updates` only follows a skipped update).
JAX_SCALAR_TAGS = {"photometric/training", "psnr/training", "mask_loss/training", "throughput/rays_per_sec",
                   "throughput/rays_per_sec_wall", "throughput/supervised_rays_per_sec", "throughput/steps_per_sec",
                   "throughput/host_fetch_fraction", "psnr/validation", "ssim/validation"}
# dB, a written q98 JPEG decoded back against the rendered image. JPEG's own
# loss on this texture is ~44 dB (Cam001 frame 0: 44.14 dB on the CPU, the
# bytes cv2 writes); a wrong colour conversion or upsampling falls far below.
JPEG_PSNR_MIN = 40.0
# Phase 9: multi-GPU training on the one card: ranks that share cuda:0 over
# gloo (NCCL refuses two ranks on one GPU), and NCCL at world size 1.
PARALLEL_RANKS = 2
PARALLEL_STEPS = 20        # steps of each 9(a)-(c) run
PARALLEL_CLI_STEPS = 30    # 9(d): the CLI's steps, validated and saved at the end
PARALLEL_LOSS_STEPS = 3    # 9(b): steps whose losses are held to one process's
SGD_LR = 1e-2              # the parity runs' plain SGD (tests/test_fsdp.py's optimizer)
PARALLEL_ADAMW = {"kind": "adamw", "lr": 1e-2, "lr_decay": 0.5, "max_steps": 50_001, "weight_decay": 0.03}
PARALLEL_RTOL, PARALLEL_ATOL = 1e-4, 1e-6  # 9(c): tests/test_fsdp.py's bars on the parameters
# 9(a)-(c) hold the ranks against one process on fresh models of density
# scale 10, not 100 (tests/test_torch_train.py's choice): at 100 a fresh
# model is opaque on every ray, where BCE's gradient (~1e10 at p = 1, ~2e7
# one ulp below) follows the last bit of p, which a GEMM of another row count
# may round the other way (CPU rehearsal at 100: the factor-2 emulation's
# gradient of one table at cosine 0.33; at 10: 0.99999).
PARALLEL_DENSITY_SCALE = 10.0
TABLE_NAMES = ("xyz", "xyt", "yzt", "xzt")
# Phase 10: the mesh tools on phase 6's scene.
MESH_MIN_TRIANGLES = 100_000     # per frame (subject_mesh's defaults give 109,824; 32 segments per rod)
MESH_IOU_MIN = 0.97              # per view, the mesh's mask against the scene's analytic mask
MESH_AB_FRAMES = (0, 25, 49)     # kernel against plain, every camera, bit for bit
MESH_CLI_FRAMES = (0, 12, 25, 37, 49)
MESH_CARVE_IOU_MIN = 0.95        # occupied voxels, the carve of the mesh's masks against that of the scene's
RIG_CAMERAS = 160                # the ActorsHQ rig's count
RIG_CHECK_CAMERAS = (0, 53, 106, 159)
# Phase 11: the protocol drivers (humanrf_torch/protocol/), cut to fit.
EVAL_PSNR_SLACK = 0.5            # dB, each evaluate row's masked PSNR against the banked JAX row (phase 4's bar)
EVAL_SSIM_SLACK = 0.01           # the evaluate phase's mean SSIM against the banked JAX mean
EVAL_IMAGE_FRAMES = (0, 3, 6)    # the banked JAX renders eval_Cam012_rgb00000{0,3,6}.png
PARALLAX_FRAMES = (0,)
# 11(c) and 11(d) train 40 steps: the trainer times 20-step windows after
# step 20, so 40 is the least run with an ms per step.
MULTISEG_STEPS = 40
MULTISEG_SIZE = 192
CAPACITY_STEPS = 40
CAPACITY_SIZE = 384
CAPACITY_CONFIG = "gather-ref-capacity"  # L16/F2, log2 24
CAPACITY_T = 1 << 22             # its table rows per level on one 25-frame segment
CAPACITY_FRAMES = 25
THROUGHPUT_STEPS = 200
LPIPS_TOL = 1e-5                 # relative, the random-feature LPIPS on the card against the CPU
# Operations per fragment (the pixel centre, w0, w1, w2, iz and 1/z) and per
# (camera, triangle) of setup (the box, the area and 1/area), and per
# (camera, vertex) of the projection.
RASTER_FRAGMENT_OPS, RASTER_SETUP_OPS, PROJECT_OPS = 26, 40, 30


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


def fresh_model(device, view, **overrides):
    """Phase 5's fresh model: initialised on the CPU from seed 0, the same
    start on any machine; `overrides` replace fields of its configuration."""
    model = HumanRFModel(dataclasses.replace(view.model_config, **overrides))
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

    def capture(params, xyz, times, field_cfg, tables=None):
        captured["render" if torch.is_grad_enabled() else "prune"].append(torch.cat([xyz, times], dim=-1).detach().clone())
        return field(params, xyz, times, field_cfg, tables)

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


def field_check(direction: str, dims: dict, kernel, plain, reference, old=None, table_entries=None) -> dict:
    """One field_interp kernel call against `reference` (its plain version,
    the backward's summed in fp64) at `dims` (shape, positions, P, C, F, T,
    N); raises past KERNEL_TOL. Its time beside its plain version's, the old
    path's when given (in turns: old, new, new, old) and its bound → the row.
    The bound reads `table_entries` table rows (default all P·T): a forward
    whose samples touch far fewer rows than the tables hold needs only those."""
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
    rows = P * T if table_entries is None else table_entries
    bound_ms, bound_by = bound(16 * N + 4 * F_ * rows + 4 * P * F_ * N, P * N * (CORNER_OPS[C] + 2 * C * F_))
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
    # R4_SCENE is full_schedule's 748² × 50-frame scene: stamped as its
    # cache stamps it, the protocol drivers of phase 11 reuse it.
    (scene / "scene_meta.json").write_text(json.dumps({"size": R4_SCENE.width, "frames": NUM_FRAMES,
                                                       "generator_version": GENERATOR_VERSION}))
    return scene


def cli_phase(name: str, scene: Path, ws: Path, flags, total_steps: int) -> dict:
    """Phases 6 and 7(c) (see the module docstring): `flags(steps, every)`
    is the run's command line. EARLY_STEPS steps validated and saved, then
    resumed to `total_steps` with validation and saves every half, the test
    frame rendered and evaluated, then RESUME_STEPS more. → the launches of
    the first two runs, and the second run's `Trainer.run_stats`."""
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
    return launches, stats


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


def paper_model(device, **overrides):
    """Phase 7(b)'s fresh model: example_humanrf's field (L16/F2, log2
    hashmap 19, so T = 2^17 per 25-frame segment, coarsest 32, finest 2048,
    camera embedding 2), no proposal, initialised on the CPU from seed 0."""
    model = HumanRFModel(HumanRFConfig(sorted_frame_numbers=tuple(range(NUM_FRAMES)), segment_sizes=(25, 25),
                                       camera_embedding_dim=2, **overrides))
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


# ------------------------------------------------------------------ phase 8


def read_events(path: Path) -> dict:
    """An events file → {"scalars": {tag: [(step, value)]}, "images": {tag:
    [step]}}, each record's length and data checked against their masked
    CRC-32C, each `Event` decoded by hand (wall_time 1, step 2, summary 5;
    Summary.Value tag 1, simple_value 2, image 4)."""

    def varint(buf, pos):
        shift = value = 0
        while True:
            byte = buf[pos]
            pos += 1
            value |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                return value, pos

    def fields(buf):
        pos, out = 0, []
        while pos < len(buf):
            key, pos = varint(buf, pos)
            if key & 7 == 0:
                value, pos = varint(buf, pos)
            elif key & 7 == 2:
                size, pos = varint(buf, pos)
                value, pos = buf[pos : pos + size], pos + size
            else:
                size = {1: 8, 5: 4}[key & 7]
                value, pos = buf[pos : pos + size], pos + size
            out.append((key >> 3, value))
        return out

    data, pos = path.read_bytes(), 0
    out = {"scalars": {}, "images": {}}
    while pos < len(data):
        (length,) = struct.unpack_from("<Q", data, pos)
        body = data[pos + 12 : pos + 12 + length]
        crcs = struct.unpack_from("<I", data, pos + 8) + struct.unpack_from("<I", data, pos + 12 + length)
        if crcs != (masked_crc32c(data[pos : pos + 8]), masked_crc32c(body)):
            raise AssertionError(f"{path.name}: a record at byte {pos} fails its CRC")
        pos += 16 + length
        event = dict(fields(body))
        if 5 not in event:
            continue
        value = dict(fields(dict(fields(event[5]))[1]))
        tag = value[1].decode()
        if 2 in value:
            out["scalars"].setdefault(tag, []).append((event.get(2, 0), struct.unpack("<f", value[2])[0]))
        if 4 in value:
            out["images"].setdefault(tag, []).append(event.get(2, 0))
    return out


def render_views(flags, sequence, out: Path) -> list:
    """The port's test render of (camera, frame) pairs, as the evaluate phase
    renders its test frames (`Trainer.test` over a TEST loader, the model
    from `--test.checkpoint`) → their PNG paths."""
    config = parse_args(flags)
    device = cli.resolve_device(config.device)
    data_folder = Path(config.dataset.path) / config.dataset.actor / config.dataset.sequence / f"{config.dataset.scale}x"
    segment_sizes = cli.compute_segment_sizes(config, data_folder, tuple(config.dataset.frame_numbers))
    loader = DataLoader(
        dataset=VolumetricDataset(data_folder), mode=DataLoader.Mode.TEST,
        space_pruning_mode=DataLoader.SpacePruningMode.OCCUPANCY_GRID, batch_size=config.test.rays_batch_size,
        camera_numbers=tuple(sorted({c for c, _ in sequence})), frame_numbers=tuple(sorted({f for _, f in sequence})),
        max_buffer_size=1, render_sequence=list(sequence), seed=config.random_seed, device=device)
    trainer = Trainer(config=config, workspace=Path(config.workspace), checkpoint=config.test.checkpoint,
                      model=cli.build_model(config, segment_sizes, device),
                      pipeline_config=cli.build_pipeline_config(config), optimizer=None,
                      resolution=loader.resolution, seed=config.random_seed)
    try:
        trainer.test(loader, out)
    finally:
        loader.shutdown()
    paths = loader.dataset.filepaths
    return [out / f"{paths.get_rgb_path(loader.cameras[c].name, f).stem}.png" for c, f in sequence]


def trajectory_phase(scene: Path, tmp: Path, device) -> dict:
    """Phase 8.1 (see the module docstring) → the field_interp launches of
    the CLI call."""
    data_dir = scene / "SynthActor" / "Sequence1" / "1x"
    ws = tmp / "trajectory_workspace"
    rows = (data_dir / "calibration.csv").read_text().splitlines()
    csv_path = tmp / "trajectory_cameras.csv"
    csv_path.write_text("\n".join([rows[0], *(rows[1 + c] for c in TRAJ_CSV_CAMERAS)]) + "\n")
    flags = r4_flags(scene, ws, 1, 1, device=device.type) + [
        "--train", "false", "--evaluate", "false", "--test.checkpoint", str(RUN_DIR / "best.ckpt"),
        "--test.trajectory_via_keycams", *(str(c) for c in TRAJ_KEYCAMS),
        "--test.trajectory_num_cameras", str(TRAJ_VIEWS), "--test.trajectory_via_calibration_file", str(csv_path)]
    torch.cuda.synchronize()
    fli.reset_launches()
    fi.reset_launches()
    t0 = time.perf_counter()
    cli.main(flags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, old_launches = dict(fli.launches), dict(fi.launches)

    results = ws / "results"
    # Both paths ping-pong their cameras against the 50 frames (`data/trajectory.py::_ping_pong_sequence`).
    expected = {"test_keycams": max(TRAJ_VIEWS, NUM_FRAMES),
                "test_calibration_file": max(len(TRAJ_CSV_CAMERAS), NUM_FRAMES)}
    width = VolumetricDataset(data_dir).cameras[0].width
    coverages = []
    for name, count in expected.items():
        views = sorted(p.name for p in (results / name).glob("*.png"))
        if views != [f"{i:06d}.png" for i in range(count)]:
            raise AssertionError(f"{name}: expected {count} frames %06d.png, found {len(views)}: {views[:3]}...")
        for view in views:
            img = image_io.imread(results / name / view)
            coverage = float((img.max(axis=-1) > COVERAGE_LEVEL).mean())
            if img.shape != (width, width, 3) or not COVERAGE_RANGE[0] <= coverage <= COVERAGE_RANGE[1]:
                raise AssertionError(f"{name}/{view}: shape {img.shape}, subject coverage {coverage:.4f} "
                                     f"outside {COVERAGE_RANGE}")
            coverages.append(coverage)
    videos = sorted(p.name for p in results.glob("video_*.mp4"))
    total = sum(expected.values())
    log(f"trajectory: {total} views ({expected}) through the CLI in {wall:.1f} s wall, {wall / total:.3f} s per view "
        f"(loaders and checkpoint loads included); field_interp launches {launches}, fused_interp {old_launches}; "
        f"subject coverage {min(coverages):.4f}–{max(coverages):.4f}; "
        + (f"ffmpeg wrote {videos}" if videos else "no video (ffmpeg is not installed), the frames are on disk"))

    # The same view through the test render: the calibration file's first
    # camera at frame 0, and key camera 0 at frame 0 (the keycam path's
    # first view sits at t = 1e-5 along it, with key camera 4's intrinsics).
    reference = render_views(flags, [(TRAJ_CSV_CAMERAS[0], 0), (TRAJ_KEYCAMS[0], 0)], tmp / "trajectory_reference")
    read = lambda path: image_io.imread(path) / 255.0
    calib_psnr = psnr(read(results / "test_calibration_file" / "000000.png"), read(reference[0]))
    keycam_psnr = psnr(read(results / "test_keycams" / "000000.png"), read(reference[1]))
    log(f"trajectory: calibration-file view 0 vs the test render of Cam{TRAJ_CSV_CAMERAS[0] + 1:03d} frame 0: "
        f"{calib_psnr:.2f} dB (bar {CALIB_VIEW_PSNR_MIN}); keycam view 0 (t = 1e-5) vs key camera "
        f"{TRAJ_KEYCAMS[0]}'s render at frame 0: {keycam_psnr:.2f} dB (bar {KEYCAM_ENDPOINT_PSNR_MIN})")
    if not calib_psnr >= CALIB_VIEW_PSNR_MIN:
        raise AssertionError(f"the calibration-file view is {calib_psnr:.2f} dB from the test render")
    if not keycam_psnr >= KEYCAM_ENDPOINT_PSNR_MIN:
        raise AssertionError(f"the keycam path's first view is {keycam_psnr:.2f} dB from key camera 0's render")
    if not (launches["fwd"] > 0 and launches["bwd"] == 0) or old_launches != {"fwd": 0, "bwd": 0}:
        raise AssertionError(f"the trajectory phases launched field_interp {launches}, fused_interp {old_launches}")
    return launches


def carve_phase(scene: Path, tmp: Path, device) -> None:
    """Phase 8.2: the occupancy carve of every frame on the card, on a copy
    of the scene's masks (its rgb folder linked: the tool lists cameras and
    frames by their images)."""
    src = scene / "SynthActor" / "Sequence1"
    dst = tmp / "carve" / "SynthActor" / "Sequence1"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("rgbs", "occupancy_grids", "test"))
    (dst / "1x" / "rgbs").symlink_to(src / "1x" / "rgbs")
    carve_seconds = []
    real_carve = occ._carve

    def timed_carve(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        grid = real_carve(*args, **kwargs)  # a host array: the device has finished
        carve_seconds.append(time.perf_counter() - t)
        return grid

    t0 = time.perf_counter()
    with mock.patch.object(occ, "_carve", timed_carve):
        occ.generate_occupancy_grid_from_masks(dst / "1x", CARVE_RESOLUTION, CARVE_THRESHOLD, device=device)
    wall = time.perf_counter() - t0
    if len(carve_seconds) != NUM_FRAMES:
        raise AssertionError(f"the tool carved {len(carve_seconds)} frames, not {NUM_FRAMES}")

    dataset, original = VolumetricDataset(dst / "1x"), VolumetricDataset(src / "1x")
    inputs = occ.carve_inputs(dataset)
    for frame in CARVE_CHECK_FRAMES:
        cpu = occ.carve_frame(dataset, inputs, frame, CARVE_THRESHOLD, CARVE_RESOLUTION, device="cpu")
        differ = int((cpu != dataset.get_occupancy_grid(frame)).sum())
        if differ:
            raise AssertionError(f"frame {frame}: the card's carve differs from the CPU's in {differ} voxels")
    coverage, volume_ratio = [], []
    for frame in range(NUM_FRAMES):
        sphere, hull = original.get_occupancy_grid(frame) > 0, dataset.get_occupancy_grid(frame) > 0
        core = sphere & np.roll(sphere, 2, 0) & np.roll(sphere, -2, 0) & np.roll(sphere, 2, 2) & np.roll(sphere, -2, 2)
        coverage.append((hull & core).sum() / max(core.sum(), 1))
        volume_ratio.append(hull.mean() / sphere.mean())
    log(f"carve: {NUM_FRAMES} frames at {CARVE_RESOLUTION}³, {len(inputs.camera_numbers)} cameras, threshold "
        f"{CARVE_THRESHOLD}: {1e3 * wall / NUM_FRAMES:.1f} ms per frame with the masks' load and dilation, "
        f"{1e3 * sum(carve_seconds) / NUM_FRAMES:.2f} ms per frame of carve; frames {CARVE_CHECK_FRAMES} equal the "
        f"CPU's voxel for voxel; core coverage {min(coverage):.4f}–{max(coverage):.4f}, hull / scene grid volume "
        f"{min(volume_ratio):.3f}–{max(volume_ratio):.3f}")
    if not min(coverage) >= CARVE_CORE_MIN:
        raise AssertionError(f"the hull covers {min(coverage):.4f} of a frame's core (< {CARVE_CORE_MIN})")


def light_bloom_phase(scene: Path, tmp: Path, device, cli_stats: dict) -> dict:
    """Phase 8.3 (see the module docstring) → the run's field_interp launches."""
    data_dir = scene / "SynthActor" / "Sequence1" / "1x"
    dataset = VolumetricDataset(data_dir)
    annotations = dataset.filepaths.get_light_annotations_path()
    original = annotations.read_bytes()
    rows = ["camera,x,y,r"]
    for cam in BLOOM_CAMERAS:  # a disc on the leftmost subject pixel of the middle row, frame 0
        mask = dataset.get_mask(cam, 0)[..., 0] > 0.5
        ys, xs = np.nonzero(mask)
        row = (int(ys.min()) + int(ys.max())) // 2
        rows.append(f"{dataset.cameras[cam].name},{int(xs[ys == row].min())},{row},{BLOOM_RADIUS}")

    ws, profile_dir = tmp / "bloom_workspace", tmp / "profile"
    flags = r4_flags(scene, ws, BLOOM_STEPS, BLOOM_STEPS, device=device.type) + [
        "--dataset.filter_light_bloom", "true", "--tpu.profile_dir", str(profile_dir)]
    pixels = {"filtered": 0, "all": 0}
    window = {}
    real_light_ok, real_start, real_stop = DataLoader._light_ok, Trace.start, Trace.stop

    def light_ok(self, mask, discs):
        ok = real_light_ok(self, mask, discs)
        pixels["filtered"] += int((~ok).sum())
        pixels["all"] += ok.size
        return ok

    def start(self):
        real_start(self)
        window["start"] = dict(fli.launches)

    def stop(self):
        window["stop"] = dict(fli.launches)
        return real_stop(self)

    try:
        annotations.write_text("\n".join(rows) + "\n")
        with mock.patch.object(DataLoader, "_light_ok", light_ok), mock.patch.object(Trace, "start", start), \
                mock.patch.object(Trace, "stop", stop):
            torch.cuda.synchronize()
            fli.reset_launches()
            fi.reset_launches()
            t0 = time.perf_counter()
            stats = cli.main(flags)["train"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        annotations.write_bytes(original)
    launches, old_launches = dict(fli.launches), dict(fi.launches)

    share = pixels["filtered"] / max(pixels["all"], 1)
    (events_file,) = (ws / "run").glob("events.out.tfevents.*")
    events = read_events(events_file)
    ((_, supervised),) = [e for e in events["scalars"]["throughput/supervised_rays_per_sec"] if e[0] == 20]
    log(f"light bloom: {BLOOM_STEPS} CLI steps with discs in {len(BLOOM_CAMERAS)} train cameras in {wall:.1f} s "
        f"wall (pool load, a profiled window and a validation included); filtered pixels {pixels['filtered']} of "
        f"{pixels['all']} loaded ({100 * share:.3f}%); {supervised:.0f} supervised rays/s over steps 2–20 (the "
        f"events' window; phase 6's timed windows: {cli_stats['supervised_rays_per_s']:.0f}); skipped updates "
        f"{stats['skipped_nonfinite']}; field_interp launches {launches}, fused_interp {old_launches}")
    if not share > 0:
        raise AssertionError("the light-bloom filter dropped no pool pixel")
    if stats["skipped_nonfinite"] != 0:
        raise AssertionError(f"{stats['skipped_nonfinite']} updates skipped as non-finite")

    tags = set(events["scalars"])
    log(f"events: {events_file.name}: scalars {sorted(tags)}, images {sorted(events['images'])}")
    if tags != JAX_SCALAR_TAGS or not events["images"]:
        raise AssertionError(f"the events hold scalars {sorted(tags)} and images {sorted(events['images'])}, "
                             f"not the JAX trainer's {sorted(JAX_SCALAR_TAGS)} and its comparison images")

    traces = list(profile_dir.iterdir())
    if len(traces) != 1:
        raise AssertionError(f"expected one trace in {profile_dir}, found {traces}")
    trace_events = json.loads(traces[0].read_text())["traceEvents"]
    # A step's span is on the host's timeline and, as a GPU annotation, on the device's.
    steps = sorted({int(e["name"].split()[1]) for e in trace_events if str(e.get("name")).startswith("train_step ")})
    traced = {d: sum(e.get("cat") == "kernel" and f"field_{d}_kernel" in e.get("name", "") for e in trace_events)
              for d in ("fwd", "bwd")}
    in_window = {d: window["stop"][d] - window["start"][d] for d in ("fwd", "bwd")}
    log(f"profile: {traces[0].name} ({traces[0].stat().st_size / 2**20:.1f} MiB), steps {steps}; field_interp "
        f"kernels in the trace {traced}, launches counted in its window {in_window}")
    if steps != list(range(20, 25)):
        raise AssertionError(f"the trace holds steps {steps}, not 20–24")
    if not (launches["fwd"] > 0 and launches["bwd"] > 0) or old_launches != {"fwd": 0, "bwd": 0}:
        raise AssertionError(f"the light-bloom run launched field_interp {launches}, fused_interp {old_launches}")
    if traced != in_window or not min(traced.values()) > 0:
        raise AssertionError(f"the trace holds field_interp kernels {traced}; its window launched {in_window}")
    return launches


# ------------------------------------------------------------------ phase 9

def parallel_inputs(path: Path, model, cfg, optimizer: dict, batches, keys, pool) -> Path:
    """The inputs of `harness.run_steps` on every rank: `model`'s state, `cfg`,
    the optimizer, the global batches and keys, the pool."""
    harness.save_inputs(path, model.config, model.state_dict(), cfg, optimizer, batches, keys, pool.pool, pool.grids,
                        pool.aabb, pool.width, pool.height)
    return path


def run_ranks(num_ranks: int, jobs, shared: bool) -> float:
    """`harness.run_jobs` over `jobs` [(inputs, out_dir, mode)] on `num_ranks`
    spawned ranks: on cuda:0 over gloo when `shared`, else one GPU each over
    NCCL. → wall seconds (spawn, build check, loads and steps)."""
    t0 = time.perf_counter()
    launch(harness.run_jobs, num_ranks, jobs, device_type="cuda", allow_shared_device=shared)
    return time.perf_counter() - t0


def params_of(result: dict, prefix: str = "param/") -> dict:
    return {k[len(prefix):]: v for k, v in result.items() if k.startswith(prefix)}


def rank_launches(results) -> dict:
    """The field_interp launches of a run, summed over its ranks."""
    total = sum(r["launches"] for r in results)
    return {"fwd": int(total[0]), "bwd": int(total[1])}


def check_launched(name: str, launches: dict) -> None:
    if not (launches["fwd"] > 0 and launches["bwd"] > 0):
        raise AssertionError(f"{name} launched field_interp {launches}")


def max_abs_diff(a: dict, b: dict) -> float:
    return max(float(np.abs(a[k].astype(np.float64) - b[k]).max()) for k in a)


def grad_cosines(grads: dict, ref: dict) -> dict:
    return {n: cosine(torch.from_numpy(grads[n]), torch.from_numpy(ref[n])) for n in ref}


def check_step0(name: str, loss: float, grads: dict, ref_loss: float, ref_grads: dict) -> None:
    """A step's loss within STEP0_LOSS_REL and its summed gradient at cosine ≥
    STEP0_GRAD_COSINE per parameter, against a reference's."""
    rel = abs(loss - ref_loss) / abs(ref_loss)
    cosines = grad_cosines(grads, ref_grads)
    worst = min(cosines, key=cosines.get)
    log(f"{name}: step-0 loss {loss:.7f} vs {ref_loss:.7f} (rel {rel:.2e}); summed gradient cosine min "
        f"{cosines[worst]:.7f} ({worst})")
    if not rel <= STEP0_LOSS_REL:
        raise AssertionError(f"{name}: step-0 loss differs by {rel:.2e} relative")
    if set(grads) != set(ref_grads) or not cosines[worst] >= STEP0_GRAD_COSINE:
        raise AssertionError(f"{name}: step-0 gradient of {worst} has cosine {cosines[worst]:.7f}")


def emulate_dp(device, view, cfg, batch, key, pool, num_ranks: int) -> tuple:
    """The data-parallel step-0 loss and summed gradient computed in this
    process: each rank's block of `batch` through the single-device step at
    the per-rank settings, its candidates keyed by their global ids; the
    ranks' means combined by their supervised rays (the group's means are
    over every rank's rays). → (loss, {name: gradient})."""
    model = fresh_model(device, view, density_scale=PARALLEL_DENSITY_SCALE)
    shard_cfg = shard_pipeline_config(cfg, num_ranks)
    step = make_train_step(shard_cfg, model, _GradientsOnly(model), pool.width, pool.height)
    n = shard_cfg.num_rays * shard_cfg.candidate_rays_factor
    losses, grads, counts = [], [], []
    for r in range(num_ranks):
        block = pipeline.HostBatch(*(f[r * n:(r + 1) * n] for f in batch))
        loss, aux = step(block, pool.pool, pool.grids, pool.aabb, key, ray_ids=r * n + torch.arange(n, device=device))
        losses.append(float(loss))
        counts.append(int(aux["num_rays_supervised"]))
        grads.append({name: p.grad.double().clone() for name, p in model.named_parameters()})
    total = sum(counts)
    loss = sum(c * l for c, l in zip(counts, losses)) / total
    return loss, {n: (sum(c * g[n] for c, g in zip(counts, grads)) / total).float().cpu().numpy() for n in grads[0]}


def parallel_dp(device, view, pool, tmp: Path, num_ranks: int = PARALLEL_RANKS, shared: bool = True) -> dict:
    """Phase 9(a) (see the module docstring) → its launches, summed over ranks."""
    transport = "gloo, sharing cuda:0" if shared else "NCCL, one GPU each"
    model = fresh_model(device, view, density_scale=PARALLEL_DENSITY_SCALE)
    cfg2 = train_config(view)
    cfg1 = dataclasses.replace(cfg2, candidate_rays_factor=1)
    generator = torch.Generator(device).manual_seed(3)
    keys = [fold_in(make_key(0, device), torch.tensor(i, device=device)) for i in range(PARALLEL_STEPS)]
    batch1 = sample_batch(cfg1, pool.pixel_rgba, generator)
    batches2 = [sample_batch(cfg2, pool.pixel_rgba, generator) for _ in range(PARALLEL_STEPS)]
    sgd = {"kind": "sgd", "lr": SGD_LR}
    factor1 = parallel_inputs(tmp / "dp_factor1.npz", model, cfg1, sgd, [batch1], keys[:1], pool)
    factor2 = parallel_inputs(tmp / "dp_factor2.npz", model, cfg2, sgd, batches2[:1], keys[:1], pool)
    steps = parallel_inputs(tmp / "dp_steps.npz", model, cfg2, PARALLEL_ADAMW, batches2, keys, pool)
    wall = run_ranks(num_ranks, [(p, tmp / p.stem, "dp") for p in (factor1, factor2, steps)], shared)
    log(f"9(a) data-parallel, {num_ranks} ranks over {transport}, r4 width ({cfg2.num_rays} slots, "
        f"{cfg2.num_rays // num_ranks} per rank): launch and three runs in {wall:.1f} s wall")

    ranks = harness.load_results(tmp / "dp_factor1", num_ranks)
    single = harness.run_steps(None, device, factor1, tmp / "dp_factor1_single", "single")
    check_step0(f"9(a) factor 1 vs one process", float(ranks[0]["losses"][0]), params_of(ranks[0], "grad0/"),
                float(single["losses"][0]), params_of(single, "grad0/"))

    ranks = harness.load_results(tmp / "dp_factor2", num_ranks)
    emu_loss, emu_grads = emulate_dp(device, view, cfg2, batches2[0], keys[0], pool, num_ranks)
    check_step0(f"9(a) factor 2 vs the per-rank emulation", float(ranks[0]["losses"][0]),
                params_of(ranks[0], "grad0/"), emu_loss, emu_grads)

    ranks = harness.load_results(tmp / "dp_steps", num_ranks)
    launches = rank_launches(ranks)
    unequal = [n for n, v in params_of(ranks[0]).items() if any(not np.array_equal(v, r[f"param/{n}"]) for r in ranks)]
    ms = [float(r["ms_per_step"]) for r in ranks]
    log(f"9(a) {PARALLEL_STEPS} AdamW steps: loss {float(ranks[0]['losses'][0]):.5f} → "
        f"{float(ranks[0]['losses'][-1]):.5f}; skipped {[int(r['skipped']) for r in ranks]}; parameters unequal "
        f"across ranks: {unequal or 'none'}; {ms[0]:.2f} ms per step (rank 0; ranks {', '.join(f'{m:.2f}' for m in ms)}; "
        f"a harness number: {num_ranks} processes on {'one card, gloo through host memory' if shared else 'their cards'},"
        f" not a scaling number); gradient bucket {int(ranks[0]['bucket_bytes']) / 1e6:.3f} MB all-reduced per step; "
        f"field_interp launches {launches} over the ranks")
    if unequal or any(int(r["skipped"]) for r in ranks):
        raise AssertionError(f"9(a): replicas unequal after {PARALLEL_STEPS} steps ({unequal}) or updates skipped")
    if not np.isfinite(ranks[0]["losses"]).all():
        raise AssertionError("9(a): non-finite loss")
    check_launched("9(a)", launches)
    return launches


def parallel_nccl(device, view, pool, tmp: Path) -> dict:
    """Phase 9(b) (see the module docstring) → its launches."""
    model = fresh_model(device, view, density_scale=PARALLEL_DENSITY_SCALE)
    cfg = train_config(view)
    generator = torch.Generator(device).manual_seed(4)
    keys = [fold_in(make_key(0, device), torch.tensor(i, device=device)) for i in range(PARALLEL_STEPS)]
    batches = [sample_batch(cfg, pool.pixel_rgba, generator) for _ in range(PARALLEL_STEPS)]
    inputs = parallel_inputs(tmp / "nccl.npz", model, cfg, PARALLEL_ADAMW, batches, keys, pool)
    wall = run_ranks(1, [(inputs, tmp / "nccl_dp", "dp"), (inputs, tmp / "nccl_fsdp", "fsdp")], shared=False)
    runs = {mode: harness.load_results(tmp / f"nccl_{mode}", 1)[0] for mode in ("dp", "fsdp")}
    singles = [harness.run_steps(None, device, inputs, tmp / f"nccl_single{i}", "single") for i in range(2)]
    ref = params_of(singles[0])
    # field_interp's backward sums in fp32 atomics, whose order varies from
    # run to run, and so do the steps after step 0. The one-process run twice
    # measures that spread; a world-1 sum is the identity, so the world-1
    # runs' step-0 gradients are one process's and their first losses lie
    # within a few times that spread.
    spread = max_abs_diff(params_of(singles[1]), ref)
    ms_single = float(singles[0]["ms_per_step"])
    ref_losses = singles[0]["losses"][:PARALLEL_LOSS_STEPS].astype(np.float64)
    loss_spread = np.abs(singles[1]["losses"][:PARALLEL_LOSS_STEPS] - ref_losses) / np.abs(ref_losses)
    loss_bar = np.maximum(STEP0_LOSS_REL, 4 * loss_spread)
    launches = {"fwd": 0, "bwd": 0}
    for mode, result in runs.items():
        params = params_of(result, "full/" if mode == "fsdp" else "param/")
        diff = max_abs_diff(params, ref)
        step0 = [float(result["losses"][0]), float(singles[0]["losses"][0]), float(singles[1]["losses"][0])]
        loss_rel = np.abs(result["losses"][:PARALLEL_LOSS_STEPS] - ref_losses) / np.abs(ref_losses)
        log(f"9(b) NCCL world 1, {mode}: {float(result['ms_per_step']):.2f} ms per step against one process's "
            f"{ms_single:.2f} ms (the bucket and the collectives: {float(result['ms_per_step']) - ms_single:+.2f} ms); "
            f"step-0 losses {step0[0]!r} vs {step0[1]!r}, {step0[2]!r}; losses of steps 0-{PARALLEL_LOSS_STEPS - 1} "
            f"rel {', '.join(f'{x:.2e}' for x in loss_rel)} vs one process (bars "
            f"{', '.join(f'{x:.2e}' for x in loss_bar)}; one process run twice: "
            f"{', '.join(f'{x:.2e}' for x in loss_spread)}); max|Δ parameter| after {PARALLEL_STEPS} steps "
            f"{diff:.3e} vs one process (one process run twice: {spread:.3e}; printed, not a gate: Adam's first "
            f"steps move a parameter by ±lr whatever its gradient's size); skipped {int(result['skipped'])}")
        if len(set(step0)) != 1:
            raise AssertionError(f"9(b) {mode}: the step-0 losses are not bit-equal: {step0}")
        check_step0(f"9(b) {mode} vs one process", step0[0], params_of(result, "grad0/"), step0[1],
                    params_of(singles[0], "grad0/"))
        if not (loss_rel <= loss_bar).all():
            raise AssertionError(f"9(b) {mode}: losses of the first steps {loss_rel} from one process's, beyond "
                                 f"{loss_bar}")
        if int(result["skipped"]):
            raise AssertionError(f"9(b) {mode}: updates skipped")
        launches = {d: launches[d] + rank_launches([result])[d] for d in launches}
        check_launched(f"9(b) {mode}", rank_launches([result]))
    log(f"9(b): {wall:.1f} s wall for the one-rank launch; field_interp launches {launches}")
    return launches


def parallel_fsdp(device, pool, tmp: Path, num_ranks: int = PARALLEL_RANKS, shared: bool = True) -> dict:
    """Phase 9(c) (see the module docstring) → its launches, summed over ranks."""
    transport = "gloo, sharing cuda:0" if shared else "NCCL, one GPU each"
    model = paper_model(device, density_scale=PARALLEL_DENSITY_SCALE)
    cfg = pipeline.PipelineConfig(**DENSE_STEP_CONFIG)
    generator = torch.Generator(device).manual_seed(5)
    keys = [fold_in(make_key(0, device), torch.tensor(i, device=device)) for i in range(PARALLEL_STEPS)]
    batches = [sample_batch(cfg, pool.pixel_rgba, generator) for _ in range(PARALLEL_STEPS)]
    sgd = parallel_inputs(tmp / "fsdp_sgd.npz", model, cfg, {"kind": "sgd", "lr": SGD_LR}, batches, keys, pool)
    adamw = parallel_inputs(tmp / "fsdp_adamw.npz", model, cfg, PARALLEL_ADAMW, batches[:5], keys[:5], pool)
    table_bytes = sum(p.numel() * 4 for n, p in model.named_parameters() if n.rsplit(".", 1)[-1] in TABLE_NAMES)
    del model
    wall = run_ranks(num_ranks, [(sgd, tmp / "fsdp_sgd", "fsdp"), (adamw, tmp / "fsdp_adamw", "fsdp")], shared)
    ranks = harness.load_results(tmp / "fsdp_sgd", num_ranks)
    single = harness.run_steps(None, device, sgd, tmp / "fsdp_single", "single")
    rel = abs(float(ranks[0]["losses"][0]) - float(single["losses"][0])) / abs(float(single["losses"][0]))
    full, ref = params_of(ranks[0], "full/"), params_of(single)
    beyond = {n: int((np.abs(full[n] - ref[n]) > PARALLEL_ATOL + PARALLEL_RTOL * np.abs(ref[n])).sum()) for n in ref}
    beyond = {n: c for n, c in beyond.items() if c}
    launches = rank_launches(ranks)
    log(f"9(c) FSDP, {num_ranks} ranks over {transport}, paper width (T = 2^17, budgets "
        f"{cfg.candidate_budget // num_ranks:,} / {cfg.sample_budget // num_ranks:,} per rank): launch and two runs in "
        f"{wall:.1f} s wall; step-0 loss {float(ranks[0]['losses'][0]):.7f} vs one process {float(single['losses'][0]):.7f}"
        f" (rel {rel:.2e}); after {PARALLEL_STEPS} SGD steps max|Δ| {max_abs_diff(full, ref):.3e}, entries beyond rtol "
        f"{PARALLEL_RTOL} / atol {PARALLEL_ATOL}: {beyond or 'none'}; {float(ranks[0]['ms_per_step']):.2f} ms per step "
        f"(rank 0; one process {float(single['ms_per_step']):.2f} ms; a harness number); field_interp launches "
        f"{launches} over the ranks")
    if not rel <= STEP0_LOSS_REL or beyond:
        raise AssertionError(f"9(c): FSDP differs from one process (loss rel {rel:.2e}; {beyond})")

    ranks = harness.load_results(tmp / "fsdp_adamw", num_ranks)
    peaks = [int(r["peak_bytes"]) for r in ranks]
    log(f"9(c) AdamW: table state per rank {int(ranks[0]['shard_bytes']) / 1e6:.1f} MB of parameters + "
        f"{int(ranks[0]['moment_bytes']) / 1e6:.1f} MB of moments (full: {table_bytes / 1e6:.1f} + "
        f"{2 * table_bytes / 1e6:.1f} MB); peak device memory per rank "
        f"{', '.join(f'{b / 2**30:.2f} GiB' for b in peaks)}; skipped {[int(r['skipped']) for r in ranks]}")
    for r in ranks:
        if int(r["shard_bytes"]) * num_ranks != table_bytes or int(r["moment_bytes"]) * num_ranks != 2 * table_bytes:
            raise AssertionError(f"9(c): rank {int(r['rank'])} holds {int(r['shard_bytes'])} + "
                                 f"{int(r['moment_bytes'])} bytes of table state, not 1/{num_ranks}")
        if int(r["skipped"]):
            raise AssertionError("9(c): AdamW updates skipped")
    check_launched("9(c)", launches)
    return launches


def workspace_files(ws: Path) -> set:
    """A workspace's files, but for TensorBoard's events file, named by time and host."""
    return {str(p.relative_to(ws)) for p in ws.rglob("*") if p.is_file() and p.parent.name != "run"}


def parallel_cli(scene: Path, tmp: Path, device) -> dict:
    """Phase 9(d) (see the module docstring) → the two-rank runs' launches."""
    # One candidate per slot and the deterministic loader (the free-running
    # replacer would change the pool before step 1 by the ranks' start-up
    # time), so that step 1 is one process's; the r4 flags' own density
    # scale, since only the forward's loss is compared.
    def flags(ws: Path, steps: int = PARALLEL_CLI_STEPS):
        return r4_flags(scene, ws, steps, PARALLEL_CLI_STEPS, device=device.type) + [
            "--tpu.candidate_rays_factor", "1", "--dataset.deterministic_loader", "true"]

    single_ws = tmp / "parallel_single"
    single = cli.main(flags(single_ws))["train"]
    launches = {"fwd": 0, "bwd": 0}
    for name, extra in (("dp", []), ("fsdp", ["--tpu.param_sharding", "fsdp"])):
        ws = tmp / f"parallel_{name}"
        t0 = time.perf_counter()
        stats = cli.main(flags(ws) + ["--tpu.num_devices", str(PARALLEL_RANKS), *extra], allow_shared_device=True)["train"]
        wall = time.perf_counter() - t0
        rel = abs(stats["first_loss"] - single["first_loss"]) / abs(single["first_loss"])
        blocks = validation_blocks(ws)
        events = list((ws / "run").glob("events.out.tfevents.*"))
        resumed = cli.main(flags(ws, PARALLEL_CLI_STEPS + 2) + ["--training.checkpoint", "latest"])["train"]
        log(f"9(d) CLI {name}, {PARALLEL_RANKS} ranks sharing cuda:0: {PARALLEL_CLI_STEPS} steps in {wall:.1f} s wall "
            f"(spawn, pool load and a validation included); step-1 loss {stats['first_loss']!r} vs one process's "
            f"{single['first_loss']!r} (rel {rel:.2e}); validation {blocks}; field_interp launches {stats['field_interp_launches']} over the ranks; resumed in one "
            f"process from step {resumed['start_step']} to {resumed['end_step']}")
        if workspace_files(ws) != workspace_files(single_ws) or len(events) != 1:
            raise AssertionError(f"9(d) {name}: workspace {sorted(workspace_files(ws))} with {len(events)} events "
                                 f"files, not one process's {sorted(workspace_files(single_ws))}")
        if not rel <= STEP0_LOSS_REL:
            raise AssertionError(f"9(d) {name}: step-1 loss differs from one process's by {rel:.2e}")
        if sorted(blocks) != [PARALLEL_CLI_STEPS] or len(blocks[PARALLEL_CLI_STEPS]) != 3 or \
                not np.isfinite(blocks[PARALLEL_CLI_STEPS]).all():
            raise AssertionError(f"9(d) {name}: validation {blocks}")
        if stats["skipped_nonfinite"] or (resumed["start_step"], resumed["end_step"]) != (
                PARALLEL_CLI_STEPS, PARALLEL_CLI_STEPS + 3):
            raise AssertionError(f"9(d) {name}: skipped updates or a wrong resume: {stats}, {resumed}")
        check_launched(f"9(d) {name}", stats["field_interp_launches"])
        launches = {d: launches[d] + stats["field_interp_launches"][d] for d in launches}
    return launches


def parallel_phase(device, view, pool, scene: Path, tmp: Path) -> dict:
    """Phase 9 → {sub-phase: field_interp launches summed over its ranks}."""
    t0 = time.perf_counter()
    launches = {"parallel_dp": parallel_dp(device, view, pool, tmp),
                "parallel_nccl": parallel_nccl(device, view, pool, tmp),
                "parallel_fsdp": parallel_fsdp(device, pool, tmp),
                "parallel_cli": parallel_cli(scene, tmp, device)}
    count = torch.cuda.device_count()
    if count >= 2:
        ranks = min(count, 4)
        (tmp / "gpus").mkdir()
        launches["parallel_dp_gpus"] = parallel_dp(device, view, pool, tmp / "gpus", ranks, shared=False)
        launches["parallel_fsdp_gpus"] = parallel_fsdp(device, pool, tmp / "gpus", ranks, shared=False)
    else:
        log(f"9: NCCL across GPUs not run: this machine has {count} GPU (9(a) and 9(c) run there on min(count, 4) "
            "ranks when it has two or more)")
    log(f"9: multi-GPU phase in {time.perf_counter() - t0:.1f} s")
    return launches


# ------------------------------------------------------------------ phase 10


def mesh_bytes(params: raster.CameraParams, num_vertices: int, num_faces: int, fragments: int) -> dict:
    """Bytes each step must move for one frame in every camera: the
    projection (vertices in, (C, V, 4) out), the raster pass (faces and
    projections in, the depth buffer's fill and 4 B per fragment's atomic)
    and the whole `rasterize` (vertices and faces in, the buffer's fill, the
    resolve's read and its mask and depth written, the atomics)."""
    C, pixels = params.floats.shape[0], params.total
    return {"project": 12 * num_vertices + 16 * C * num_vertices,
            "raster": 12 * num_faces + 16 * C * num_vertices + 4 * pixels + 4 * fragments,
            "rasterize": 12 * num_vertices + 12 * num_faces + (4 + 4 + 1 + 4) * pixels + 4 * fragments}


def mesh_extract(tmp: Path) -> list:
    """Phase 10(a): the subject of every frame tessellated and written as
    OBJ, packed into one .abc and extracted → the extracted meshes."""
    written_dir, extracted_dir = tmp / "mesh_written", tmp / "mesh_extracted"
    written_dir.mkdir()
    t0 = time.perf_counter()
    written = [written_dir / f"Frame{frame:06d}.obj" for frame in range(NUM_FRAMES)]
    for frame, path in enumerate(written):
        mesh_io.write_obj(path, *subject_mesh(R4_SCENE, frame))
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    abc = objs_to_abc(written, tmp / "subject.abc", mesh_name="subject")
    t_pack = time.perf_counter() - t0
    t0 = time.perf_counter()
    if alembic_extractor.main(["--alembic", str(abc), "--output", str(extracted_dir)]) != 0:
        raise AssertionError("the extractor failed")
    t_extract = time.perf_counter() - t0
    extracted = sorted(extracted_dir.glob("Frame*.obj"))
    if [p.name for p in extracted] != [p.name for p in written]:
        raise AssertionError(f"the extractor wrote {len(extracted)} frames, not {NUM_FRAMES}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(8) as pool:
        meshes = list(pool.map(mesh_io.load_obj, extracted))
        sources = list(pool.map(mesh_io.load_obj, written))
    t_load = time.perf_counter() - t0
    for frame, ((v, f), (wv, wf)) in enumerate(zip(meshes, sources)):
        # tests/test_alembic_extractor.py's bars: vertices within rtol 1e-6, faces equal.
        if not (v.shape == wv.shape and np.allclose(v, wv, rtol=1e-6, atol=0) and np.array_equal(f, wf)):
            raise AssertionError(f"frame {frame}: the extracted mesh differs from the written one")
    triangles = min(len(f) for _, f in meshes)
    log(f"10(a) extract: {NUM_FRAMES} frames of {triangles} triangles ({len(meshes[0][0])} vertices; sphere 128 × "
        f"384, {R4_SCENE.num_rods} capsule rods of 32 segments); s per frame: tessellate and write OBJ "
        f"{t_write / NUM_FRAMES:.4f}, pack into .abc (objs_to_abc) {t_pack / NUM_FRAMES:.4f}, extract "
        f"{t_extract / NUM_FRAMES:.4f}, parse an OBJ (load_obj, 8 threads) {t_load / (2 * NUM_FRAMES):.4f}; the "
        f"extracted meshes equal the written ones (rtol 1e-6, faces equal)")
    if triangles < MESH_MIN_TRIANGLES:
        raise AssertionError(f"{triangles} triangles per frame, fewer than {MESH_MIN_TRIANGLES}")
    return meshes


def check_mesh_kernels(v, f, cameras, kept, device) -> dict:
    """Phase 10(b)'s A/B at one frame: each kernel against its plain version
    on the same inputs, bit for bit, and the main run's views against the
    plain resolve → the frame's numbers."""
    params = raster.CameraParams.build(cameras, device)
    proj = raster.launch_project(v, params, 1.0)
    plain_proj = raster.project_plain(v, params, 1.0)
    buf = raster.launch_raster(proj, f, params)
    plain_buf, fragments = raster.depth_buffer_plain(plain_proj, f, params)
    torch.cuda.synchronize()
    if not torch.equal(proj.view(torch.int32), plain_proj.view(torch.int32)):
        raise AssertionError("mesh_project differs from its plain version")
    if not torch.equal(buf.view(torch.int32), plain_buf.view(torch.int32)):
        differ = int((buf.view(torch.int32) != plain_buf.view(torch.int32)).sum())
        raise AssertionError(f"mesh_raster differs from its plain version on {differ} pixels")
    for (mask, depth), (plain_mask, plain_depth) in zip(kept, raster.resolve(plain_buf, params)):
        if not (torch.equal(mask, plain_mask) and torch.equal(depth.view(torch.int32), plain_depth.view(torch.int32))):
            raise AssertionError("a rendered view differs from the plain version's")
    finite = torch.isfinite(proj) & torch.isfinite(plain_proj)
    errors = {"project": float((proj - plain_proj)[finite].abs().max()),
              "raster": float((buf - plain_buf)[torch.isfinite(plain_buf)].abs().max())}
    return {"errors": errors, "fragments": int(fragments.sum()), "params": params, "proj": proj,
            "ms": {"project": time_ms(lambda: raster.launch_project(v, params, 1.0)),
                   "raster": time_ms(lambda: raster.launch_raster(proj, f, params)),
                   "rasterize": time_ms(lambda: raster.rasterize(v, f, cameras))},
            "plain_ms": {"project": time_ms(lambda: raster.project_plain(v, params, 1.0), iters=5),
                         "raster": time_ms(lambda: raster.depth_buffer_plain(plain_proj, f, params), iters=3),
                         "rasterize": time_ms(lambda: raster.rasterize_plain(v, f, cameras), iters=3)}}


def mesh_phase(scene: Path, tmp: Path, device, smi: str) -> list:
    """Phase 10 (see the module docstring) → the two kernels' records."""
    t_phase = time.perf_counter()
    data_dir = scene / "SynthActor" / "Sequence1" / "1x"
    meshes = mesh_extract(tmp)
    on_device = [(torch.from_numpy(v).to(device), torch.from_numpy(f).to(device)) for v, f in meshes]
    cameras = mesh_io.read_calibration_f32(data_dir / "calibration.csv")

    # (b) every frame in every camera through the kernels.
    def truth(frame):
        return np.stack([image_io.decode_png((data_dir / "masks" / c.name / f"{c.name}_mask{frame:06d}.png")
                                             .read_bytes())[..., 0] > 0 for c in cameras])

    with ThreadPoolExecutor(8) as pool:
        truths = list(pool.map(truth, range(NUM_FRAMES)))
    kept, ious = {}, []
    torch.cuda.synchronize()
    raster.reset_launches()
    t0 = time.perf_counter()
    for frame, (v, f) in enumerate(on_device):
        views = raster.rasterize(v, f, cameras)
        if frame in MESH_AB_FRAMES or frame in MESH_CLI_FRAMES:
            kept[frame] = views
        masks = torch.stack([m for m, _ in views]) > 0
        analytic = torch.from_numpy(truths[frame]).to(device)
        ious.append((masks & analytic).sum((1, 2)) / (masks | analytic).sum((1, 2)).clamp_min(1))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    render_launches = dict(raster.launches)
    views_total = NUM_FRAMES * len(cameras)
    ious = torch.cat(ious).cpu().numpy()
    log(f"10(b) render: {views_total} views ({NUM_FRAMES} frames × {len(cameras)} cameras, "
        f"{cameras[0].width}x{cameras[0].height}) in {wall:.3f} s wall with the IoUs; launches {render_launches}; "
        f"mask IoU against the scene's analytic masks min {ious.min():.5f}, median {np.median(ious):.5f} "
        f"(bar {MESH_IOU_MIN}) [{smi}]")
    if render_launches != {"project": NUM_FRAMES, "raster": NUM_FRAMES}:
        raise AssertionError(f"the render launched {render_launches}, not one of each kernel per frame")
    if not ious.min() >= MESH_IOU_MIN:
        raise AssertionError(f"a view's mask IoU is {ious.min():.5f} (< {MESH_IOU_MIN})")

    rows = []
    for frame in MESH_AB_FRAMES:
        v, f = on_device[frame]
        row = check_mesh_kernels(v, f, cameras, kept[frame], device)
        row["bytes"] = mesh_bytes(row["params"], v.shape[0], f.shape[0], row["fragments"])
        row["ops"] = {"project": PROJECT_OPS * len(cameras) * v.shape[0],
                      "raster": RASTER_SETUP_OPS * len(cameras) * f.shape[0] + RASTER_FRAGMENT_OPS * row["fragments"]}
        row["ops"]["rasterize"] = row["ops"]["project"] + row["ops"]["raster"]
        rows.append(row)
    per_view = {}
    for step in ("project", "raster", "rasterize"):
        ms = sum(r["ms"][step] for r in rows) / (len(rows) * len(cameras))
        plain_ms = sum(r["plain_ms"][step] for r in rows) / (len(rows) * len(cameras))
        bound_ms, bound_by = bound(sum(r["bytes"][step] for r in rows) / (len(rows) * len(cameras)),
                                   sum(r["ops"][step] for r in rows) / (len(rows) * len(cameras)))
        per_view[step] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by}
        log(f"10(b) {step} at frames {MESH_AB_FRAMES}, per view: kernel {ms:.5f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.5f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of it [{smi}]")
    fragments = sum(r["fragments"] for r in rows) / (len(rows) * len(cameras))
    log(f"10(b) kernels against plain at frames {MESH_AB_FRAMES} × {len(cameras)} cameras: bit-equal (masks, "
        f"depths, projections); {fragments:.0f} fragments per view")

    # (c) the CLI for MESH_CLI_FRAMES into a copy of the scene, then the carve.
    src = scene / "SynthActor" / "Sequence1"
    dst = tmp / "mesh_chain" / "SynthActor" / "Sequence1"
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("rgbs", "occupancy_grids", "test"))
    (dst / "1x" / "rgbs").symlink_to(src / "1x" / "rgbs")
    objs = sorted(str(p) for p in (tmp / "mesh_extracted").glob("Frame*.obj"))
    torch.cuda.synchronize()
    raster.reset_launches()
    t0 = time.perf_counter()
    rc = mesh_renderer.main(["--objs", *objs, "--csv", str(dst / "1x" / "calibration.csv"), "--output",
                             str(dst / "1x"), "--mask", "--depth", "--frames", *map(str, MESH_CLI_FRAMES),
                             "--device", device.type])
    torch.cuda.synchronize()
    cli_wall = time.perf_counter() - t0
    cli_launches = dict(raster.launches)
    if rc != 0 or cli_launches != {"project": len(MESH_CLI_FRAMES), "raster": len(MESH_CLI_FRAMES)}:
        raise AssertionError(f"the mesh renderer's CLI returned {rc} with launches {cli_launches}")
    for frame in MESH_CLI_FRAMES:
        for cam, (mask, depth) in zip(cameras, kept[frame]):
            pfm = mesh_io.read_pfm(dst / "1x" / "depths" / cam.name / f"{cam.name}_depth{frame:06d}.pfm")
            png = image_io.decode_png((dst / "1x" / "masks" / cam.name / f"{cam.name}_mask{frame:06d}.png")
                                      .read_bytes())[..., 0]
            if pfm.tobytes() != depth.cpu().numpy().tobytes() or not np.array_equal(png, mask.cpu().numpy()):
                raise AssertionError(f"{cam.name} frame {frame}: the CLI's files differ from the kernel's views")
    mesh_data, scene_data = VolumetricDataset(dst / "1x"), VolumetricDataset(src / "1x")
    mesh_inputs, scene_inputs = occ.carve_inputs(mesh_data), occ.carve_inputs(scene_data)
    carve_ious = []
    for frame in MESH_CLI_FRAMES:
        hull = occ.carve_frame(mesh_data, mesh_inputs, frame, CARVE_THRESHOLD, CARVE_RESOLUTION, device) > 0
        reference = occ.carve_frame(scene_data, scene_inputs, frame, CARVE_THRESHOLD, CARVE_RESOLUTION, device) > 0
        carve_ious.append((hull & reference).sum() / max((hull | reference).sum(), 1))
    cli_views = len(MESH_CLI_FRAMES) * len(cameras)
    log(f"10(c) the CLI: {cli_views} views with --mask --depth in {cli_wall:.3f} s, {cli_wall / cli_views:.4f} s "
        f"per view with the OBJ loads and file writes; launches {cli_launches}; every PFM and mask reads back as "
        f"the kernel's view; carve at {CARVE_RESOLUTION}³, threshold {CARVE_THRESHOLD}, of the mesh's masks "
        f"against the scene's: occupied-voxel IoU min {min(carve_ious):.5f} (bar {MESH_CARVE_IOU_MIN}) [{smi}]")
    if not min(carve_ious) >= MESH_CARVE_IOU_MIN:
        raise AssertionError(f"the carve of the mesh's masks has IoU {min(carve_ious):.5f} with the scene's")

    # (d) the 160-camera rig at frame 0.
    rig_csv = tmp / "rig_calibration.csv"
    rig_cfg = dataclasses.replace(R4_SCENE, num_cameras=RIG_CAMERAS, width=cameras[0].width,
                                  height=cameras[0].height)
    write_calibration_csv(make_cameras(rig_cfg), rig_csv)
    rig = mesh_io.read_calibration_f32(rig_csv)
    v, f = on_device[0]
    torch.cuda.synchronize()
    raster.reset_launches()
    rig_views = raster.rasterize(v, f, rig)
    torch.cuda.synchronize()
    rig_launches = dict(raster.launches)
    plain = raster.rasterize_plain(v, f, [rig[i] for i in RIG_CHECK_CAMERAS])
    for i, (plain_mask, plain_depth) in zip(RIG_CHECK_CAMERAS, plain):
        mask, depth = rig_views[i]
        if not (torch.equal(mask, plain_mask) and torch.equal(depth.view(torch.int32), plain_depth.view(torch.int32))):
            raise AssertionError(f"rig camera {i}: the kernel's view differs from the plain version's")
    rig_params = raster.CameraParams.build(rig, device)
    rig_proj = raster.launch_project(v, rig_params, 1.0)
    rig_ms = {"project": time_ms(lambda: raster.launch_project(v, rig_params, 1.0), iters=5) / RIG_CAMERAS,
              "raster": time_ms(lambda: raster.launch_raster(rig_proj, f, rig_params), iters=5) / RIG_CAMERAS,
              "rasterize": time_ms(lambda: raster.rasterize(v, f, rig), iters=5) / RIG_CAMERAS}
    log(f"10(d) rig: {RIG_CAMERAS} cameras at {rig[0].width}x{rig[0].height}, frame 0: launches {rig_launches}; "
        f"cameras {RIG_CHECK_CAMERAS} bit-equal to the plain version; ms per view: project {rig_ms['project']:.5f}, "
        f"raster {rig_ms['raster']:.5f}, rasterize {rig_ms['rasterize']:.5f} [{smi}]")
    log(f"10: mesh phase in {time.perf_counter() - t_phase:.1f} s")
    by_phase = {"mesh_render": render_launches, "mesh_cli": cli_launches, "mesh_rig": rig_launches}
    return [
        {
            "name": f"mesh_{step}",
            "route": "cuda",
            "source": "humanrf_torch/csrc/mesh_raster.cu",
            "replaces": "humanrf_tpu/native/mesh_renderer/main.cpp:227",
            "launches": render_launches[step],
            "launches_by_phase": {phase: counts[step] for phase, counts in by_phase.items()},
            "max_abs_err": max(r["errors"][step] for r in rows),
            **per_view[step],
            "library_ms": None,  # no PyTorch call rasterizes
            "per": "view, the mean over frames 0, 25 and 49 × 12 cameras",
            "rasterize": per_view["rasterize"],
            "fragments_per_view": fragments,
            "rig_ms": rig_ms[step],
        }
        for step in ("project", "raster")
    ]


# ------------------------------------------------------------------ phase 11


@contextlib.contextmanager
def drivers_in_process():
    """The protocol drivers' supervised CLI commands run in this process
    (`cli.main`, the command's flags), their output appended to the
    driver's log, so that the launch counts are this process's → the list
    of `cli.main` results, one per command, each with its flags ("argv")."""
    results = []

    def run(cmd, log, env, cwd, **kwargs):
        if cmd[1:3] != ["-m", "humanrf_torch.run"]:
            raise AssertionError(f"a driver ran {cmd[:3]}, not the port's CLI")
        with open(log, "a") as out, contextlib.redirect_stdout(out):
            results.append({**cli.main(cmd[3:]), "argv": cmd[3:]})
        return 0, 0

    with mock.patch.object(supervisor, "supervise", run):
        yield results


@contextlib.contextmanager
def recorded_losses():
    """The loss of every training step the CLI takes, kept on the device →
    the list of losses."""
    losses, real = [], trainer_module.make_train_step

    def make(*args, **kwargs):
        step = real(*args, **kwargs)

        def recorded(*step_args):
            loss, aux = step(*step_args)
            losses.append(loss.detach())
            return loss, aux

        return recorded

    with mock.patch.object(trainer_module, "make_train_step", make):
        yield losses


@contextlib.contextmanager
def first_render_query():
    """The (N, 4) coordinates of the first field query made with autograd on
    (step 0's render pass) → a dict that holds them under "xyzt"."""
    captured, field = {}, decomposition4d.apply_decomposition4d_fused

    def capture(params, xyz, times, field_cfg, tables=None):
        if torch.is_grad_enabled() and "xyzt" not in captured:
            captured["xyzt"] = torch.cat([xyz, times], dim=-1).detach().clone().contiguous()
        return field(params, xyz, times, field_cfg, tables)

    with mock.patch.object(decomposition4d, "apply_decomposition4d_fused", capture):
        yield captured


def counted(name: str, fn, backward: bool):
    """`fn()` with the field_interp counts set to 0 before and read after →
    (its result, the launches); raises unless both directions (or, without
    `backward`, the forward alone) launched and `fused_interp` did not."""
    torch.cuda.synchronize()
    fli.reset_launches()
    fi.reset_launches()
    result = fn()
    torch.cuda.synchronize()
    launches, old_launches = dict(fli.launches), dict(fi.launches)
    if not (launches["fwd"] > 0 and (launches["bwd"] > 0) == backward) or old_launches != {"fwd": 0, "bwd": 0}:
        raise AssertionError(f"{name} launched field_interp {launches}, fused_interp {old_launches}")
    return result, launches


def read_csv(path: Path) -> list:
    lines = path.read_text().strip().splitlines()
    keys = lines[0].split(",")
    return [dict(zip(keys, line.split(","))) for line in lines[1:]]


def evaluate_phase(scene: Path, tmp: Path, device) -> tuple:
    """11(a): `finish_phases` (evaluate only) from the banked best.ckpt on
    phase 6's scene → (Cam012 frame 0's masked PSNR, the launches)."""
    root = tmp / "finish_phases"
    (root / "workspace" / "checkpoints").mkdir(parents=True)
    (root / "scene").symlink_to(scene)
    shutil.copyfile(RUN_DIR / "best.ckpt", root / "workspace" / "checkpoints" / "best.ckpt")
    t0 = time.perf_counter()
    with drivers_in_process():
        phases, launches = counted("11(a) evaluate", lambda: finish_phases.main(
            ["--root", str(root), "--skip-trajectory", "--device", device.type]), backward=False)
    wall = time.perf_counter() - t0
    results = root / "workspace" / "results"
    port = {(r["camera"], r["frame"]): r for r in read_csv(results / "metrics.csv")}
    banked = {(r["camera"], r["frame"]): r for r in read_csv(RUN_DIR / "metrics.csv")}
    if sorted(port) != sorted(banked):
        raise AssertionError(f"the evaluate phase scored {sorted(port)}, the banked run {sorted(banked)}")
    deltas = {key: float(port[key]["PSNR"]) - float(banked[key]["PSNR"]) for key in banked}
    ssim = float(np.mean([float(r["SSIM"]) for r in port.values()]))
    banked_ssim = float(read_csv(RUN_DIR / "averages.csv")[0]["SSIM"])
    log(f"11(a) evaluate: {len(port)} Cam012 frames from best.ckpt in {wall:.1f} s wall "
        f"({phases['evaluate']['wall_s']} s in finish_phases); field_interp launches {launches}; masked PSNR − "
        "banked JAX per frame: " + ", ".join(f"{int(f)}: {d:+.3f}" for (_, f), d in
                                            sorted(deltas.items(), key=lambda kv: int(kv[0][1])))
        + f" dB (max |Δ| {max(abs(d) for d in deltas.values()):.3f}, bar {EVAL_PSNR_SLACK}); mean masked PSNR "
        f"{np.mean([float(r['PSNR']) for r in port.values()]):.4f} dB (banked 19.2234); mean SSIM {ssim:.4f} "
        f"(banked {banked_ssim:.4f}, bar ±{EVAL_SSIM_SLACK})")
    images = {}
    for frame in EVAL_IMAGE_FRAMES:
        name = f"Cam012_rgb{frame:06d}.png"
        ours, theirs = image_io.imread(results / "test_frames" / name), image_io.imread(RUN_DIR / f"eval_{name}")
        images[frame] = psnr(ours / 255.0, theirs / 255.0)
    log("11(a): PSNR(port render, banked JAX render): " + ", ".join(f"frame {f} {v:.2f} dB" for f, v in images.items()))
    bad = {key: d for key, d in deltas.items() if not abs(d) <= EVAL_PSNR_SLACK}
    if bad:
        raise AssertionError(f"evaluate rows off the banked JAX rows by more than {EVAL_PSNR_SLACK} dB: {bad}")
    if not abs(ssim - banked_ssim) <= EVAL_SSIM_SLACK:
        raise AssertionError(f"mean SSIM {ssim:.4f} against the banked {banked_ssim:.4f}")

    # The random-feature LPIPS on the card against the CPU, on frame 0's ROI.
    pred = image_io.imread(results / "test_frames" / "Cam012_rgb000000.png")[..., ::-1] / 255.0
    gt = image_io.imread(scene / "SynthActor" / "Sequence1" / "1x" / "rgbs" / "Cam012" / "Cam012_rgb000000.jpg")[..., ::-1] / 255.0
    lpips = {where: LpipsModel.load_or_init(where) for where in (device, "cpu")}
    on_card, on_cpu = (model(pred, gt) for model in lpips.values())
    rel = abs(on_card - on_cpu) / abs(on_cpu)
    log(f"11(a): LPIPS ({lpips['cpu'].metric_name}) of frame 0 on the card {on_card:.8f}, on the CPU {on_cpu:.8f} "
        f"(rel {rel:.2e}, bar {LPIPS_TOL})")
    if not rel < LPIPS_TOL:
        raise AssertionError(f"LPIPS on the card differs from the CPU's by {rel:.2e} relative")
    return float(port[("12", "0")]["PSNR"]), launches


def parallax_phase(tmp: Path, frame0_psnr: float, device) -> dict:
    """11(b): `parallax_probe` at PARALLAX_FRAMES, eight views → the launches."""
    root = tmp / "parallax_probe"
    t0 = time.perf_counter()
    rows, launches = counted("11(b) parallax", lambda: parallax_probe.main(
        ["--frames", *map(str, PARALLAX_FRAMES), "--size", str(R4_SCENE.width), "--root", str(root),
         "--device", device.type]), backward=False)
    wall = time.perf_counter() - t0
    log(f"11(b) parallax probe: {len(rows)} views in {wall:.1f} s wall (the probe scene written included); "
        f"field_interp launches {launches}")
    for line in parallax_probe.summary(rows):
        log(f"11(b): {line}")
    replica = [r for r in rows if r["azimuth_deg"] == parallax_probe.TEST_DEG and r["frame"] == 0][0]
    log(f"11(b): the 330° replica's masked PSNR {replica['psnr_masked']:.3f} dB, 11(a)'s Cam012 frame 0 "
        f"{frame0_psnr:.3f} dB")
    if len(rows) != len(parallax_probe.probe_angles_deg()) * len(PARALLAX_FRAMES) or not all(
            np.isfinite([r[k] for r in rows for k in ("psnr_roi", "psnr_masked", "ssim")])):
        raise AssertionError(f"parallax rows are not finite or not one per view: {rows}")
    if not abs(replica["psnr_masked"] - frame0_psnr) <= EVAL_PSNR_SLACK:
        raise AssertionError("the test camera's replica is off 11(a)'s frame-0 row by more than "
                             f"{EVAL_PSNR_SLACK} dB")
    return launches


def steps_of(stats: dict) -> int:
    return stats["end_step"] - stats["start_step"]


def per_step(launches: dict, steps: int) -> str:
    return f"{launches['fwd'] / steps:.1f} forward + {launches['bwd'] / steps:.1f} backward"


def multiseg_phase(tmp: Path, device, r4_stats: dict) -> dict:
    """11(c): `multiseg` at MULTISEG_SIZE² over 100 frames, MULTISEG_STEPS
    steps and one validation → the launches."""
    root = tmp / "multiseg"
    t0 = time.perf_counter()
    with drivers_in_process() as runs, recorded_losses() as losses:
        result, launches = counted("11(c) multiseg", lambda: multiseg.main(
            ["--steps", str(MULTISEG_STEPS), "--size", str(MULTISEG_SIZE), "--validate-every", str(MULTISEG_STEPS),
             "--root", str(root), "--device", device.type]), backward=True)
    wall = time.perf_counter() - t0
    stats = runs[0]["train"]
    loss = torch.stack(losses).cpu().numpy()
    early, late = float(loss[:10].mean()), float(loss[-10:].mean())
    blocks = result["validation_blocks"]
    log(f"11(c) multiseg: segments {result['segment_sizes']}, {len(loss)} steps in {wall:.1f} s wall (the 100-frame "
        f"scene written included); loss first 10 {early:.5f}, last 10 {late:.5f}; validation {blocks}; "
        f"{stats['ms_per_step']:.2f} ms per step ({stats['steps']} timed), field_interp launches per step "
        f"{per_step(stats['field_interp_launches'], steps_of(stats))} (1,024 rays from 2× candidates, Kc 16, Kf 8); "
        f"phase 6's [25, 25] r4 step: {r4_stats['ms_per_step']:.2f} ms, "
        f"{per_step(r4_stats['field_interp_launches'], steps_of(r4_stats))} (8,192 rays, Kc 32, Kf 16)")
    if result["segment_sizes"] != [25, 25, 25, 25]:
        raise AssertionError(f"the 100-frame scene partitioned into {result['segment_sizes']}")
    if len(loss) != steps_of(stats) or not np.isfinite(loss).all() or not late < early:
        raise AssertionError(f"multiseg losses: {loss}")
    if len(blocks) != 1 or not np.isfinite(blocks[0]["psnr"]):
        raise AssertionError(f"multiseg validation blocks: {blocks}")
    # The checkpoint in a fresh model of the same flags.
    config = parse_args(runs[0]["argv"])
    params, _, step, _, _ = load_checkpoint(root / "ws" / "checkpoints" / f"step_{MULTISEG_STEPS:08d}.ckpt")
    fresh = cli.build_model(config, result["segment_sizes"], device)
    fresh.load_state_dict(convert_params(params))
    if step != MULTISEG_STEPS or not all(torch.isfinite(p).all() for p in fresh.parameters()):
        raise AssertionError(f"the step-{step} checkpoint did not reload into a finite model")
    log(f"11(c): step_{MULTISEG_STEPS:08d}.ckpt reloaded into a fresh 4-segment model "
        f"({sum(p.numel() for p in fresh.parameters())} parameters)")
    return launches


def capacity_phase(tmp: Path, device) -> tuple:
    """11(d): `quality_at_capacity`'s gather-ref-capacity arm (L16/F2, log2
    24: T = 2^22 on one 25-frame segment) at CAPACITY_SIZE² for
    CAPACITY_STEPS steps, no validation and no save; each field_interp
    kernel at step 0's render query against its plain version → (the
    launches, {direction: [rows]})."""
    root = tmp / "quality_sweep"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    never = str(10 * CAPACITY_STEPS)
    with drivers_in_process() as runs, first_render_query() as query:
        results, launches = counted("11(d) reference capacity", lambda: quality_at_capacity.main(
            ["--size", str(CAPACITY_SIZE), "--frames", str(CAPACITY_FRAMES), "--steps", str(CAPACITY_STEPS),
             "--only", CAPACITY_CONFIG, "--root", str(root), "--device", device.type,
             "--extra", f"--training.save_checkpoint_every_n_steps {never} --validation.every_n_steps {never}"]),
            backward=True)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    stats, segments = runs[0]["train"], runs[0]["segment_sizes"]
    _, log2, levels, features, _ = quality_at_capacity.CONFIGS[CAPACITY_CONFIG]
    model_cfg = HumanRFConfig(sorted_frame_numbers=tuple(range(CAPACITY_FRAMES)), segment_sizes=tuple(segments),
                              log2_hashmap_size=log2, n_levels=levels, n_features_per_level=features,
                              finest_resolution=2048)
    seg = segment_grid_config(model_cfg, segments[0])
    T = seg.grid.table_size
    log(f"11(d) reference capacity: segments {segments}, T = 2^{T.bit_length() - 1} per level; {steps_of(stats)} "
        f"steps in {wall:.1f} s wall (the scene written included); step-0 loss {stats['first_loss']:.6f}; "
        f"{stats['ms_per_step']:.2f} ms per step ({stats['steps']} timed); skipped updates "
        f"{stats['skipped_nonfinite']}; peak memory {peak:.2f} GiB; field_interp launches per step "
        f"{per_step(stats['field_interp_launches'], steps_of(stats))}; {results[0]}")
    if segments != [CAPACITY_FRAMES] or T != CAPACITY_T:
        raise AssertionError(f"the reference-capacity arm ran segments {segments} at T = {T}")
    if not np.isfinite(stats["first_loss"]) or stats["skipped_nonfinite"] != 0:
        raise AssertionError(f"step-0 loss {stats['first_loss']}, {stats['skipped_nonfinite']} updates skipped")

    xyzt = query["xyzt"]
    N = xyzt.shape[0]
    gen = torch.Generator(device).manual_seed(0)
    rows = {"fwd": [], "bwd": []}
    for name, spec, P, F_, table in (
            ("grids", fli.grid_spec(seg.grid), 4 * seg.grid.n_levels, seg.grid.n_features_per_level, T),
            ("vectors", fli.VECTOR_SPEC, 4, seg.grid.feature_dim, seg.vectors_finest_resolution)):
        C = 8 if spec.mode == fli.MODE_GRID else 2
        tables = torch.randn((P, F_, table), generator=gen, device=device)
        g = torch.randn((P, F_, N), generator=gen, device=device)
        idx, _ = fli.corner_idx_w(xyzt, spec, table)
        touched = int(torch.unique(idx.long() + torch.arange(P, device=device)[:, None, None] * table).numel())
        dims = {"shape": name, "positions": "real", "P": P, "C": C, "F": F_, "T": table, "N": N}
        rows["fwd"].append(field_check(
            "fwd", dims, lambda: fli._launch_fwd(tables, xyzt, spec), lambda: fli.field_interp_plain(tables, xyzt, spec),
            lambda: fli.field_interp_plain(tables, xyzt, spec), table_entries=touched))
        rows["bwd"].append(field_check(
            "bwd", dims, lambda: fli._launch_bwd(g, xyzt, spec, table),
            lambda: fli.field_interp_bwd_plain(g, xyzt, spec, table),
            lambda: fli.field_interp_bwd_plain(g.double(), xyzt, spec, table)))
        log(f"11(d): the {name}' samples touch {touched} of {P * table} table rows")
        del tables, g
    return launches, rows


def throughput_phase(scene: Path, tmp: Path, device) -> dict:
    """11(e): `throughput_probe`, THROUGHPUT_STEPS steps resumed from the
    banked step_00050000.ckpt on phase 6's scene → the launches."""
    t0 = time.perf_counter()
    with drivers_in_process() as runs:
        result, launches = counted("11(e) throughput", lambda: throughput_probe.main(
            ["--steps", str(THROUGHPUT_STEPS), "--root", str(tmp / "tput_probe"), "--scene-root", str(scene.parent),
             "--device", device.type]), backward=True)
    stats = runs[0]["train"]
    log(f"11(e) throughput probe: resumed step {stats['start_step']} to {stats['end_step']} in "
        f"{time.perf_counter() - t0:.1f} s wall; {stats['ms_per_step']:.2f} ms per step ({stats['steps']} timed), "
        f"{stats['rays_per_s']:.0f} rays/s nominal, {stats['supervised_rays_per_s']:.0f} supervised, host fetch "
        f"{100 * stats['fetch_share']:.1f}%; the probe's own reading {result['ms_per_step']} ms, "
        f"{result['rays_per_s']} rays/s")
    if stats["start_step"] != throughput_probe.RESUME_STEP or stats["skipped_nonfinite"] != 0:
        raise AssertionError(f"the throughput probe ran {stats}")
    return launches


def protocol_phase(scene: Path, tmp: Path, device, r4_stats: dict) -> tuple:
    """Phase 11 → ({sub-phase: launches}, {direction: T = 2^22 rows})."""
    t0 = time.perf_counter()
    frame0_psnr, eval_launches = evaluate_phase(scene, tmp, device)
    launches = {"evaluate": eval_launches, "parallax": parallax_phase(tmp, frame0_psnr, device),
                "multiseg": multiseg_phase(tmp, device, r4_stats)}
    launches["ref_capacity"], capacity_rows = capacity_phase(tmp, device)
    launches["throughput"] = throughput_phase(scene, tmp, device)
    log(f"11: protocol phase in {time.perf_counter() - t0:.1f} s")
    return launches, capacity_rows


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

    # Phase 2: build, the three libraries side by side.
    names = ("field_interp", "fused_interp", "mesh_raster")
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(load_library, names)))
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
        cli_launches, cli_stats = cli_phase("cli", scene, ws, lambda steps, every: r4_flags(scene, ws, steps, every),
                                            CLI_STEPS)

        # Phase 7: dense sampling.
        dense_render_launches = dense_render(device, view, model, port_roi)
        dense_step_launches, dense_records = dense_train(device, train_pool)
        dense_ws = Path(tmp) / "dense_workspace"
        dense_cli_launches, _ = cli_phase(
            "dense cli", scene, dense_ws,
            lambda steps, every: r4_flags(scene, dense_ws, steps, every) + PAPER_DENSE_FLAGS,
            DENSE_CLI_STEPS)

        # Phase 8: the trajectory phases, the occupancy carve, the light-bloom CLI run.
        trajectory_launches = trajectory_phase(scene, Path(tmp), device)
        carve_phase(scene, Path(tmp), device)
        bloom_launches = light_bloom_phase(scene, Path(tmp), device, cli_stats)

        # Phase 9: multi-GPU training.
        parallel_launches = parallel_phase(device, view, train_pool, scene, Path(tmp))

        # Phase 10: the mesh tools.
        mesh_records = mesh_phase(scene, Path(tmp), device, smi)

        # Phase 11: the protocol drivers.
        protocol_launches, capacity_rows = protocol_phase(scene, Path(tmp), device, cli_stats)

    by_phase = {"render": launches, "train_step": train_launches, "cli": cli_launches,
                "dense_render": dense_render_launches, "dense_step": dense_step_launches, "dense_cli": dense_cli_launches,
                "trajectory": trajectory_launches, "light_bloom_cli": bloom_launches, **parallel_launches,
                **protocol_launches}
    records = [
        {
            "name": f"field_interp_{direction}",
            "route": "cuda",
            "source": "humanrf_torch/csrc/field_interp.cu",
            "replaces": f"humanrf_tpu/ops/fused_interp.py:{line}",
            "launches": sum(counts[direction] for counts in protocol_launches.values()),
            "launches_by_phase": {phase: counts[direction] for phase, counts in by_phase.items()},
            "library_ms": None,  # no one PyTorch call computes the corners and the lookup
            **new_kernels[direction],
            "dense": dense_records[direction],
            "ref_capacity": summarize(capacity_rows[direction]),
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
    ] + mesh_records
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
