#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA Hopper GPU.

Drives the port's paths at the full width of the r4 HumanRF model (2
segments [25, 25], L8/F4 grids with T=2048 per segment, rank-32 proposal,
camera embedding 2) through its own entry points, with every field query on
the hand-written CUDA kernels of `csrc/field_interp.cu` (forward and
backward), which compute the field's corners from the sample coordinates
themselves, the lookups and their composition:

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
  (T = 2^22 per level) and the throughput probe;
- K-Planes (hybrid), `--model.representation kplanes` at the widths of the
  benchmark's kplanes-hybrid.train, on the same r4 scene: its plane
  queries on the hand-written kernels of `csrc/kplanes.cu`, its graphed
  train step and its CLI.

The single-process train step and the render function are CUDA graphs
(`train/graphs.py`), captured once per input signature and replayed; every
path below that trains or renders through `make_train_step`,
`make_render_fn`, `render_image` or the CLI replays them. Phases 4, 5 and
7(a)-(b) also run the same functions eagerly (`graph=False`) and hold the
graphs to them; the swap of the field's query for its plain version runs
eagerly, since a graph replays what it captured.

Phases, each of which raises on failure:

1. device: a CUDA Hopper card (capability 9.0) is required;
2. build: `humanrf_torch/csrc/field_interp.cu`, `mesh_raster.cu`,
   `adamw.cu` and `kplanes.cu` with nvcc for sm_90a, side by side
   (registers, shared memory and spills from `-Xptxas -v`); then 2(b),
   AdamW's kernels (`adamw_phase`) over the parameter lists of the r4 model,
   the paper's dense field and the 1000-frame model: two steps of the
   kernel route bit-equal to two of the plain body from the same state, and
   the device time of `adamw_finite`, `adamw_update`, the whole step, the
   plain body and PyTorch's own fused calls (`torch._fused_adamw_`,
   `torch._amp_foreach_non_finite_check_and_unscale_`), each a CUDA graph
   replayed, with their bounds. Every later phase of this process counts
   AdamW's launches (`read_launches`): both kernels as often, some in a
   phase that trains, none in one that only renders or evaluates;
3. kernels: the field query's kernels (`query_checks`) at the render
   pass's query of phase 5's step 0 (the model's two segments over the
   whole buffer, with its skip inputs, one launch each way as the main path
   makes them): the forward bit for bit against its plain version
   (`field_query_plain`: per segment the plain per-pair lookups, then
   PyTorch's segment sum and composition); the backward's every table and
   vector within KERNEL_TOL of its scale against the plain version summed
   in fp64; each timed beside the plain version, with its bound;
4. the render through its graphs: kernel launches counted over it (one
   field query forward per batch, over both segments; no backward), kernel
   render vs plain render
   (PSNR ≥ 50 dB), ROI-PSNR against the ground truth within 0.5 dB of the
   JAX package's banked render of the same view, warm renders of the plain
   version once and of the eager render and the graphs in turns (s per
   view), and
   the graph render bit-equal to the eager one;
5. training: a step-0 A/B of loss and gradients through the kernels against
   both directions' plain versions (eager); the eager body of a fresh model
   for one step under `torch.cuda.set_sync_debug_mode("error")` (no op may
   wait for the device), then the graph's first replay (step 1; step 0 is
   its warm-up, the eager body) against the eager body from the same state,
   batch and key (loss bit-equal, gradient cosine ≥ GRAPH_GRAD_COSINE per
   parameter; the capture's field backward adds into every table's and
   vector's `.grad`, `field.grads_fresh` 0, those gradients within
   KERNEL_TOL of the eager body's fresh buffers; the peak memory of each);
   TRAIN_STEPS graph steps with launches
   counted (one field query forward and backward per step), finite
   losses, no skipped update and falling mse; ms
   per step beside the eager step's before the graphs, supervised rays/s,
   peak memory and
   the device's busy share in one profiled step; then windows of the eager
   body and the graph in turns (ms per step, peak memory,
   kernels, device time and busy share of a profiled step each); the
   held-out Cam012 view's ROI-PSNR before and after training;
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
   and the CSVs, no skipped update, launches of both field query
   directions counted over these runs; then a
   resume from `latest` for RESUME_STEPS more steps. Prints ms per step
   (beside the eager step's before the graphs), nominal and supervised
   rays/s, the host
   fetch share and the pool's replacement rate;
7. dense sampling:
   (a) best.ckpt's 748² view through the dense sampler at the r4 run's
   settings (R4_DENSE, scaled to the 16,384-ray batches): launches counted
   (forward only), a finite image, kernel render vs
   plain render ≥ 50 dB, and the baked 128² patch (`torch_dense_inputs.npz`,
   16 batches of 1,024 rays at the baked settings) ≥ DENSE_PATCH_PSNR_MIN
   from the JAX package's dense render of it, both through the graphs, and
   the graph render bit-equal to the eager one; prints s per view of the
   plain, eager and graph renders, ms per batch, the sampler's counts per
   view and the ROI-PSNR beside phase 4's;
   (b) the dense step (DENSE_STEP_CONFIG) on a fresh model with the paper's
   field, fed from phase 5's pool: the field query's kernels at step 0's
   render-pass and prune-pass queries over the budgets' whole buffers
   (`query_checks`, the prune pass's forward only), a step-0
   kernel-vs-plain A/B (loss within 1e-5, gradient cosine ≥ 0.9999), the
   sync check and graph-vs-eager first replay as phase 5's, DENSE_STEPS timed
   graph steps (2 forward + 1 backward launches each: the prune and render
   passes' field queries, the render pass's backward)
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
   images; one trace, of steps 20–24 (the recorder's `train.step` spans it
   holds), whose field query kernels equal the launches counted in its
   window, and its idle gaps labelled by the program's spans;
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
   (b) all 600 views rasterized on the card (launches per frame: one
   `mesh_project`, two `mesh_bin`, one `mesh_raster`), each view's mask IoU
   against the scene's analytic mask ≥ MESH_IOU_MIN (min and median
   printed); at MESH_AB_FRAMES, each kernel against its plain version on
   the same inputs, bit for bit (the projections, the tile lists with each
   tile's faces sorted, the masks and depths of `mesh_raster`), and the
   main run's views against them; kernel ms per view (CUDA events), plain ms, fragments and
   (triangle, tile) pairs per view, each step's bound and its share;
   (c) the mesh renderer's CLI for MESH_CLI_FRAMES with --mask --depth
   into a copy of the scene: every PFM and mask reads back as the kernel's
   view; s per view with the file writes; the carve (128³, threshold 12)
   of those frames from the mesh's masks against the carve from the
   scene's: occupied-voxel IoU ≥ MESH_CARVE_IOU_MIN;
   (d) frame 0 in RIG_CAMERAS cameras (`make_cameras` of the r4 scene, the
   ActorsHQ rig's count) at 748²: cameras RIG_CHECK_CAMERAS bit-equal to
   the plain version; ms per view of each step;
   (e) the ActorsHQ rig at its full size: RIG_CAMERAS cameras of RIG_12MP
   (every tenth portrait, so that one pass mixes two image shapes) at
   RIG_12MP_FRAMES: every kernel against its plain version in all cameras,
   bit for bit, as in (b); ms per frame and per view of each step, its
   bound and share, fragments and pairs per view, peak memory; then the
   renderer's CLI for one frame with --mask (s per view with the PNG
   writes; two of its masks read back as the kernel's);
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
   model, the field query's kernels at step 0's render query over the four
   segments (`query_checks`); ms and launches per step beside phase 6's
   two-segment step;
   (d) `quality_at_capacity`'s gather-ref-capacity arm (T = 2^22) at
   CAPACITY_SIZE², CAPACITY_FRAMES frames, CAPACITY_STEPS steps without
   validation or saves: the field query's kernels at step 0's render query
   (`query_checks`), a finite step-0 loss, no skipped update; peak memory
   and ms per step;
   (e) `throughput_probe`, THROUGHPUT_STEPS steps resumed from the banked
   step_00050000.ckpt: ms per step and rays/s;
12. K-Planes (hybrid) on phase 6's scene, `r4_flags` then KPLANES_FLAGS:
   (a) the plane query's kernels (`plane_query_checks`) at the three
   queries of the graphed train step's first call (its eager warm-up):
   proposal 1 (1,048,576 samples, M 8, one scale of 128), proposal 2
   (524,288, M 8, 256) and the field (196,608 slots with the step's valid
   count, M 32, four scales of 64·s), the planes copied with their time
   planes set to 1 + U[-0.1, 0.1] so that a fault along t shows: the
   forward bit for bit against `plane_query_plain`, every plane's backward
   within KERNEL_TOL of its scale against `plane_query_bwd_plain` summed in
   fp64; each timed beside the plain version and the library's
   (`F.grid_sample` per plane and scale and the products; its backward as
   fwd + bwd − fwd), with its bound; then the regularisers' kernels
   (`regularizer_checks`) at the model's 36 planes after that call: the
   scalar within REG_TOL of the plain formulas summed in fp64 and bit-equal
   between two launches, every plane's gradient bit-equal to
   `plane_reg_bwd_plain`; each timed beside today's autograd path over the
   plain formulas (its backward as fwd + bwd − fwd), with its bound;
   (b) KPLANES_STEPS replays of that step (`Trainer`'s, fed by the
   `DataLoader`), the launch counts reset just before: one launch each way
   per plane query per step (3 + 3), the regularisers' 2 + 1, AdamW's once
   a step, the gauge `kplanes.reg_entries` at the planes' entries, finite
   losses, no skipped update; ms per step;
   (c) the CLI as phase 6, to KPLANES_CLI_STEPS: validation PSNR rising,
   saves, a resume, the test render and the evaluation.

The last three lines of output are the kernel table as JSON (the field
query's kernels, `field_query_fwd` and `field_query_bwd`, with `launches`
counted over phase 11 and each phase's counts beside them, their phase-3
rows at the r4 query, their phase-7(b) rows at the dense queries under
"dense", 11(c)'s under "multiseg" and 11(d)'s at T = 2^22 under
"ref_capacity"; `mesh_project`, `mesh_bin` and `mesh_raster`, with `launches` counted
over 10(b), their times per view at 10(b)'s frames, 10(d)'s under
"rig_ms" and 10(e)'s under "rig_12mp_ms"; `adamw_finite` and
`adamw_update`, with `launches` counted over this process's phases and
2(b)'s rows under "r4", "paper-dense" and "paper-1000f"; `kplanes_fwd` and
`kplanes_bwd`, with `launches` counted over 12(b) and each phase's counts
beside them, their 12(a) rows under the query's name; `plane_reg_fwd` and
`plane_reg_bwd` likewise, their 12(a) row under "model"), the card's name
and power limit from nvidia-smi, and `{"ok": true, "device": {...}}`.
Usage: python3 chip_smoke.py [--mesh-only | --kplanes-only]
(--mesh-only: phases 1, 2 and 10 alone, on a freshly written r4 scene; the
kernel table then holds the mesh kernels only. --kplanes-only: phases 1,
2 and 12 alone, likewise, with the K-Planes kernels. The script runs itself with
--breakdown INPUTS for `device_breakdown`'s fresh process)
"""
from __future__ import annotations

import os

# Keep CUPTI set up between torch.profiler sessions: the script profiles
# many windows, some of them CUDA graph replays, and PyTorch's own profiler
# turns the teardown off whenever graphs are in use ("CUDA Graph does not
# work well with CUPTI teardown", torch/profiler/profiler.py).
os.environ.setdefault("TEARDOWN_CUPTI", "0")

import contextlib
import dataclasses
import gc
import json
import math
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
from humanrf_torch.models import fused_field
from humanrf_torch.models import kplanes as kplanes_model
from humanrf_torch.models.humanrf import HumanRFConfig, HumanRFModel, segment_grid_config
from humanrf_torch.ops import adamw as adamw_kernels
from humanrf_torch.ops import field_interp as fli
from humanrf_torch.ops import kplanes as kplanes_ops
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
from humanrf_torch.utils import profiling
from humanrf_torch.utils.profiling import Trace
from humanrf_torch.utils.rngs import fold_in, make_key, split
from humanrf_torch.utils.summary import masked_crc32c
from humanrf_torch.view_inputs import load_dense_inputs, load_train_inputs, load_view_inputs

REPO = Path(__file__).resolve().parent
RUN_DIR = REPO / "runs_evidence" / "r4_full_schedule_748"

# AdamW's launches (of each of its two kernels) per phase of this process's
# main path, as `read_launches` reads them.
ADAMW_LAUNCHES: dict = {}
KERNEL_TOL = 1e-5          # scaled max error, the query's backward vs the plain version summed in fp64
REG_TOL = 1e-6             # relative, the regularisers' scalar vs the plain formulas summed in fp64
RENDER_PSNR_MIN = 50.0     # dB, kernel render vs plain render
ROI_PSNR_SLACK = 0.5       # dB below the banked JAX render's ROI-PSNR

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
# Step 0 of the captured step against the eager body from the same state,
# batch and key: the loss bit-equal (the forward sums in a fixed order), the
# gradient per parameter at this cosine (the backward kernel adds in fp32
# atomics, in a run-dependent order).
GRAPH_GRAD_COSINE = 0.99999
PROFILE_LEAD_S = 0.1       # host seconds between a profiler window's start and its work (`device_profile`)
# The eager port's numbers on this card before its steps became CUDA graphs
# (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W), printed beside the graphs'.
EAGER_MS_PER_STEP = {"train step (5)": 40.83, "dense step (7(b))": 38.56, "cli (6)": 75.19,
                   "dense cli (7(c))": 58.61, "multiseg (11(c))": 205.55, "ref capacity (11(d))": 121.82,
                   "throughput (11(e))": 75.06}
EAGER_S_PER_VIEW = "0.44–0.48"  # phase 4's proposal render of a 748² view
MSE_DROP = 0.5             # mean mse of the last 20 steps ≤ this × that of the first 5
AB_WARM_STEPS = 2          # phase 5's eager/graph windows: steps before each timed window
AB_STEPS = 10              # phase 5's eager/graph windows: timed steps each

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
RIG_12MP = {"width": 4112, "height": 3008}   # the ActorsHQ rig's images (12 MP, the HumanRF paper)
RIG_12MP_PORTRAIT = tuple(range(0, RIG_CAMERAS, 10))  # every tenth camera portrait, as a rig's calibration mixes them
RIG_12MP_FRAMES = (0, 25)
RIG_12MP_PLAIN_CHUNK = 1 << 24   # (triangle, box pixel) pairs per step of the plain version at 12 MP
MESH_STEPS = ("project", "bin", "raster", "rasterize")
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
# Phase 12: K-Planes (hybrid) at the widths of the benchmark's
# kplanes-hybrid.train (the `--model.kplanes_*` defaults), given after
# `r4_flags` to override its model, sampler and loss.
KPLANES_FLAGS = [
    "--model.representation", "kplanes",
    "--model.temporal_partitioning", "none",
    "--model.camera_embedding_dim", "0",
    "--tpu.proposal_samples_per_ray", "256",
    "--tpu.proposal_mid_samples_per_ray", "128",
    "--tpu.render_samples_per_ray", "48",
    "--training.rays_initial_batch_size", "4096",
    "--training.lr", "0.01",
    "--training.weight_decay", "0",
    "--training.photometric", "mse",
    "--training.bce_loss_weight", "0",
]
KPLANES_STEPS = 100              # 12(b): replays of the graphed train step
KPLANES_CLI_STEPS = 400          # 12(c): resumed to this step, validated and saved every half (at 100
#                                  steps a fresh field still renders as at 20: its density has not formed)
# A train step's plane queries, in call order: (slots, scales, channels).
KPLANES_QUERIES = {"proposal 1": (4096 * 256, 1, 8), "proposal 2": (4096 * 128, 1, 8), "field": (4096 * 48, 4, 32)}
LPIPS_TOL = 1e-5                 # relative, the random-feature LPIPS on the card against the CPU
# Operations per fragment (the pixel centre, w0, w1, w2, iz and 1/z) and per
# (camera, triangle) of setup (the box, the area and 1/area), and per
# (camera, vertex) of the projection.
RASTER_FRAGMENT_OPS, RASTER_SETUP_OPS, PROJECT_OPS = 26, 40, 30


_START = time.perf_counter()


def log(msg: str) -> None:
    """A line of the log, after the seconds since the script started."""
    print(f"[{time.perf_counter() - _START:6.1f} s] {msg}", flush=True)


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


def fresh_model(device, view, **overrides):
    """Phase 5's fresh model: initialised on the CPU from seed 0, the same
    start on any machine; `overrides` replace fields of its configuration."""
    model = HumanRFModel(dataclasses.replace(view.model_config, **overrides))
    model.init_parameters(torch.Generator().manual_seed(0))
    return model.to(device)


def train_config(view):
    return dataclasses.replace(view.pipeline_config, **TRAIN_CONFIG)


def query_of(fields, xyzt, n_valid, seg) -> dict:
    """A field query as the field's kernels get it → {"fields" (the model's
    segments), "xyzt" (N, 4) over the whole buffer, its skip inputs
    "n_valid" and "seg"}, the inputs copied."""
    return {"fields": fields, "xyzt": xyzt.detach().clone().contiguous(),
            "n_valid": None if n_valid is None else n_valid.clone(), "seg": None if seg is None else seg.clone()}


def capture_queries(step, batch, pool, key) -> dict:
    """The field query of each pass of one eager training step (`query_of`):
    "render" (with autograd) and, under dense sampling, "prune" (without)
    → {pass: query}, which phases 3 and 7(b) check."""
    captured = {}
    query_fn = fused_field.field_query

    def capture(fields, xyzt, n_valid=None, seg=None):
        captured["render" if torch.is_grad_enabled() else "prune"] = query_of(fields, xyzt, n_valid, seg)
        return query_fn(fields, xyzt, n_valid, seg)

    with mock.patch.object(fused_field, "field_query", capture):
        step(batch, pool.pool, pool.grids, pool.aabb, key)
    return captured


def served_count(query: dict) -> int:
    """The samples a query serves: those below its valid count whose
    segment id names one of its segments."""
    xyzt, n_valid, seg = query["xyzt"], query["n_valid"], query["seg"]
    live = xyzt.shape[0] if n_valid is None else min(xyzt.shape[0], int(n_valid))
    return live if seg is None else int(((seg[:live] >= 0) & (seg[:live] < len(query["fields"]))).sum())


@contextlib.contextmanager
def field_swap():
    """The field query's plain version, `field_query_plain` (per-pair
    lookups, then PyTorch's segment sum and composition), in place of its
    kernels."""
    with mock.patch.object(fused_field, "field_query", fli.field_query_plain):
        yield


def capture_real_query(device, view, pool) -> dict:
    """The render pass's field query of phase 5's step 0 (its fresh model,
    its first batch and key; see `capture_queries`)."""
    model, cfg = fresh_model(device, view), train_config(view)
    batch = sample_batch(cfg, pool.pixel_rgba, torch.Generator(device).manual_seed(1))
    step = make_train_step(cfg, model, _GradientsOnly(model), pool.width, pool.height, graph=False)
    return capture_queries(step, batch, pool, make_key(0, device))["render"]


def touched_bytes(fields, xyzt, n_valid, seg) -> int:
    """The bytes of the table rows that a query's served samples touch, each
    (table, row) once: per segment its samples' grid corners inside the
    tables (F floats a row) and vector taps (L·F floats a row)."""
    total = 0
    for s, field in enumerate(fields):
        live = fli.served(xyzt.shape[0], xyzt.device, n_valid, seg, s)
        pts = xyzt if live is None else xyzt[live]
        for spec, (P, F_, T) in ((field.spec, (4 * field.spec.n_levels, *field.grids[0].shape[-2:])),
                                 (fli.VECTOR_SPEC, tuple(field.vectors.shape))):
            idx = fli.corner_idx_w(pts, spec, T)[0].long()
            rows = (idx + torch.arange(P, device=idx.device)[:, None, None] * T)[idx < T]
            total += 4 * F_ * int(torch.unique(rows).numel())
            del idx, rows
    return total


def query_checks(label: str, query: dict, backward: bool) -> dict:
    """The field query's kernels at a real query (`query`, from `query_of`:
    the model's own segments over the whole buffer with its skip inputs),
    one launch each way as the main path makes them → {direction: row}.
    The forward against its plain version, `field_query_plain` (per-pair
    lookups, then PyTorch's segment sum and composition), bit for bit; the
    backward against the plain version summed in fp64, every table and
    vector within KERNEL_TOL of its scale; else it raises. Each is timed
    beside the plain version ("plain_ms"; the backward's is
    `field_query_bwd_plain` in fp32), with its bound: the served samples'
    coordinates and corner math, the segment ids below the valid count, the
    features written over the whole buffer, the table rows the samples
    touch read once (`touched_bytes`); the backward reads the served
    cotangents, zeroes every table's gradient (the launch allocates them)
    and writes the touched rows once."""
    fields = [fli.SegmentField(tuple(t.detach() for t in f.grids), f.vectors.detach(), f.spec)
              for f in query["fields"]]
    xyzt, n_valid, seg = query["xyzt"], query["n_valid"], query["seg"]
    N, L, F_ = xyzt.shape[0], fields[0].spec.n_levels, fields[0].grids[0].shape[1]
    live, M = N if n_valid is None else min(N, int(n_valid)), served_count(query)
    table_bytes = 4 * sum(t.numel() for t in fli._flat(fields))
    touched = touched_bytes(fields, xyzt, n_valid, seg)
    read = 16 * M + (0 if n_valid is None else 4) + (0 if seg is None else 4 * live)
    ops = M * L * 4 * (CORNER_OPS[8] + CORNER_OPS[2] + 2 * 8 * F_ + 2 * 2 * F_ + 2 * F_)
    dims = {"shape": "query", "positions": label, "segments": len(fields), "L": L, "F": F_,
            "T": [int(f.grids[0].shape[2]) for f in fields], "N": N, "served": M}

    out, ref = fli._launch_query_fwd(fields, xyzt, n_valid, seg), fli.field_query_plain(fields, xyzt, n_valid, seg)
    torch.cuda.synchronize()
    rows = {"fwd": dict(dims, max_abs_err=float((out - ref).abs().max()), bit_exact=bool(torch.equal(out, ref)))}
    if not rows["fwd"]["bit_exact"]:
        raise AssertionError(f"field_query_fwd at {label} differs from the plain version by "
                             f"{rows['fwd']['max_abs_err']:.3e}")
    with torch.no_grad():
        rows["fwd"].update(ms=time_ms(lambda: fli._launch_query_fwd(fields, xyzt, n_valid, seg), iters=10),
                           plain_ms=time_ms(lambda: fli.field_query_plain(fields, xyzt, n_valid, seg), iters=2))
    rows["fwd"]["bound_ms"], rows["fwd"]["bound_by"] = bound(read + 4 * N * L * F_ + touched, ops)
    del out, ref
    if backward:
        g = torch.randn((N, L * F_), generator=torch.Generator(xyzt.device).manual_seed(0), device=xyzt.device)
        grads = fli._launch_query_bwd(fields, xyzt, g, n_valid, seg)
        refs = fli.field_query_bwd_plain(fields, xyzt, g.double(), n_valid, seg)
        torch.cuda.synchronize()
        scaled = max(float((a.double() - b).abs().max() / b.abs().max()) for a, b in zip(grads, refs))
        del grads, refs
        if not scaled < KERNEL_TOL:
            raise AssertionError(f"field_query_bwd at {label} disagrees with the fp64 plain sum: "
                                 f"scaled err {scaled:.3e}")
        rows["bwd"] = dict(dims, max_abs_err=scaled, bit_exact=False,
                           ms=time_ms(lambda: fli._launch_query_bwd(fields, xyzt, g, n_valid, seg), iters=10),
                           plain_ms=time_ms(lambda: fli.field_query_bwd_plain(fields, xyzt, g, n_valid, seg), iters=2))
        rows["bwd"]["bound_ms"], rows["bwd"]["bound_by"] = bound(read + 4 * M * L * F_ + table_bytes + touched,
                                                                 2 * ops)
        del g
    for direction, row in rows.items():
        check = ("bit-exact against the plain version" if direction == "fwd"
                 else f"scaled err {row['max_abs_err']:.2e} against the fp64 sum")
        log(f"kernel field_query_{direction} {label}: {len(fields)} segments, L={L} F={F_} T={dims['T']}, {N} slots "
            f"serving {M}: {check}; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms "
            f"({row['plain_ms'] / row['ms']:.0f}×), bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), {100 * row['bound_ms'] / row['ms']:.1f}% of it")
    torch.cuda.empty_cache()
    return rows


def ptxas_summary(log_text: str) -> list:
    """`-Xptxas -v` output → one entry per kernel: its name and template
    arguments, registers, spilled bytes."""
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


def timed_render(model, view, pcfg=None, graph: bool = True) -> tuple:
    """`render_image` of the view (through its graphs, or eagerly) → (the
    image, wall s)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    img = render_image(model, pcfg or view.pipeline_config, view.inputs, view.rays_batch_size, graph=graph)
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


def step0_kernel_vs_plain(label: str, grads_step, model, batch, pool, key) -> None:
    """One batch and key through `grads_step` (eager, gradients only) with the
    field's kernels and with both directions' plain versions: the loss within
    STEP0_LOSS_REL, each parameter's gradient at cosine ≥ STEP0_GRAD_COSINE."""
    runs = {}
    for which in ("kernel", "plain"):
        patch = field_swap() if which == "plain" else contextlib.nullcontext()
        with patch:
            loss, _ = grads_step(batch, pool.pool, pool.grids, pool.aabb, key)
        runs[which] = (float(loss), {n: p.grad.clone() for n, p in model.named_parameters()})
    (loss_k, grads_k), (loss_p, grads_p) = runs["kernel"], runs["plain"]
    rel = abs(loss_k - loss_p) / abs(loss_p)
    # The gradients are held by cosine, not by max error: a sum that differs
    # by an ulp can flip a near-tie bf16 rounding in the MLP, which moves a
    # few gradient entries by far more than the kernels' own rounding.
    cosines = {n: cosine(grads_k[n], grads_p[n]) for n in grads_k}
    worst = min(cosines, key=cosines.get)
    log(f"{label} step-0 A/B: loss kernel {loss_k:.7f}, plain {loss_p:.7f} (rel {rel:.2e}); "
        f"gradient cosine min {cosines[worst]:.7f} ({worst})")
    if not rel <= STEP0_LOSS_REL:
        raise AssertionError(f"{label} step-0 loss through the kernels differs from the plain run by {rel:.2e} relative")
    if not cosines[worst] >= STEP0_GRAD_COSINE:
        raise AssertionError(f"{label} step-0 gradient of {worst} has cosine {cosines[worst]:.7f} to the plain run's")
    model.zero_grad(set_to_none=True)


def adamw(model):
    return make_optimizer(model.named_parameters(), lr=1e-2, lr_decay=0.5, max_steps=50_001, weight_decay=0.03)


# Phase 2(b)'s parameter lists: the models of the three training cells (the
# r4 model's from the view's configuration), as shapes only.
ADAMW_MODELS = {
    "paper-dense": dict(sorted_frame_numbers=tuple(range(NUM_FRAMES)), segment_sizes=(25, 25),
                        camera_embedding_dim=2),
    "paper-1000f": dict(sorted_frame_numbers=tuple(range(1000)), segment_sizes=(50,) * 20, camera_embedding_dim=2),
}
ADAMW_ITERS = 20


def graphed(fn):
    """`fn` run once, then captured as a CUDA graph → its replay."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return graph.replay


def adamw_state(device, shapes):
    """Parameters N(0, 1) with gradients at 1e-3·N(0, 1), from seed 0 on the card."""
    gen = torch.Generator(device=device).manual_seed(0)
    params = [torch.nn.Parameter(torch.randn(s, generator=gen, device=device)) for s in shapes]
    for p in params:
        p.grad = 1e-3 * torch.randn(p.shape, generator=gen, device=device)
    return params


def adamw_phase(device, view) -> dict:
    """Phase 2(b) (see the module docstring) → the AdamW rows' entries,
    {"finite"/"update": {model: row}}."""
    configs = {"r4": view.model_config, **{k: HumanRFConfig(**v) for k, v in ADAMW_MODELS.items()}}
    rows = {"finite": {}, "update": {}}
    for name, config in configs.items():
        shapes = [p.shape for p in HumanRFModel(config, device="meta").parameters()]
        numel = sum(math.prod(s) for s in shapes)
        params = adamw_state(device, shapes)
        plain_params = [torch.nn.Parameter(p.detach().clone()) for p in params]
        for p, q in zip(params, plain_params):
            q.grad = p.grad
        names = [f"p{i}" for i in range(len(params))]
        kernel = make_optimizer(zip(names, params), lr=1e-2, lr_decay=0.5, max_steps=50_001, weight_decay=0.03)
        plain = make_optimizer(zip(names, plain_params), lr=1e-2, lr_decay=0.5, max_steps=50_001, weight_decay=0.03)
        plain._update_kernels = plain._update_plain
        adamw_kernels.reset_launches()
        for _ in range(2):
            kernel.step()
            plain.step()
        torch.cuda.synchronize()
        per_step = {k: n // 2 for k, n in adamw_kernels.launches.items()}
        differ = [i for i, (a, b) in enumerate(zip([*params, *kernel.mu, *kernel.nu],
                                                   [*plain_params, *plain.mu, *plain.nu]))
                  if not torch.equal(a.detach().view(torch.int32), b.detach().view(torch.int32))]
        if differ or (int(kernel.count), int(plain.count)) != (2, 2):
            raise AssertionError(f"AdamW's kernels differ from the plain body at {name}'s tensors {differ}")
        tables = len(adamw_kernels.plan([math.prod(s) for s in shapes]))
        gauge = profiling.snapshot()["counters"].get("train.optimizer_launches")
        if per_step != {"finite": tables, "update": tables} or gauge != 2 * tables:
            raise AssertionError(f"AdamW at {name} launched {per_step} a step (train.optimizer_launches {gauge}), "
                                 f"not one of each per table ({tables})")
        grads = [p.grad for p in plain_params]
        plain_ms = time_ms(graphed(plain.step), ADAMW_ITERS)
        plain_finite_ms = time_ms(graphed(lambda: torch.stack([torch.isfinite(g).all() for g in grads]).all()),
                                  ADAMW_ITERS)
        # PyTorch's own fused calls over the same tensors (the plain body's
        # state, overwritten): the flag that a GradScaler reads, and the
        # fused AdamW that reads it (decoupled decay p·(1 − lr·wd) first).
        found_inf, inv_scale = torch.zeros(1, device=device), torch.ones(1, device=device)
        steps = [torch.ones((), device=device) for _ in grads]
        library_ms = {
            "finite": time_ms(graphed(lambda: torch._amp_foreach_non_finite_check_and_unscale_(
                grads, found_inf, inv_scale)), ADAMW_ITERS),
            "update": time_ms(graphed(lambda: torch._fused_adamw_(
                plain_params, grads, plain.mu, plain.nu, [], steps, lr=1e-2, beta1=0.9, beta2=0.99,
                weight_decay=0.03, eps=1e-15, amsgrad=False, maximize=False, found_inf=found_inf)), ADAMW_ITERS),
        }
        del plain, plain_params, grads, steps
        tabs = adamw_kernels.tables(params, [p.grad for p in params], kernel.mu, kernel.nu)
        flag = torch.ones((), dtype=torch.bool, device=device)
        scalars = [torch.tensor(v, device=device) for v in (-1e-2, 0.1, 0.01)]
        constants = adamw_kernels.AdamWConstants(0.1, 0.9, 0.01, 0.99, 1e-15, 0.03,
                                                 *(t.data_ptr() for t in scalars))
        ms = {"finite": time_ms(graphed(lambda: adamw_kernels.finite(tabs, device)), ADAMW_ITERS),
              "update": time_ms(graphed(lambda: adamw_kernels.update(tabs, flag, constants)), ADAMW_ITERS)}
        step_ms = time_ms(graphed(kernel.step), ADAMW_ITERS)
        for kind, nbytes, ops, plain_kind_ms in (("finite", 4 * numel, numel, plain_finite_ms),
                                                  ("update", 28 * numel, 15 * numel, plain_ms)):
            bound_ms, bound_by = bound(nbytes, ops)
            rows[kind][name] = {"tensors": len(shapes), "params": numel, "launches_per_step": per_step[kind],
                                "ms": ms[kind], "bound_ms": bound_ms, "bound_by": bound_by,
                                "plain_ms": plain_kind_ms, "library_ms": library_ms[kind], "step_ms": step_ms}
        log(f"2(b) AdamW at {name} ({len(shapes)} tensors, {numel} parameters): two steps bit-equal to the plain "
            f"body; launches a step {per_step} (train.optimizer_launches {gauge}); adamw_finite "
            f"{ms['finite']:.4f} ms (bound {rows['finite'][name]['bound_ms']:.4f}, PyTorch's "
            f"_amp_foreach_non_finite_check_and_unscale_ {library_ms['finite']:.4f}), adamw_update "
            f"{ms['update']:.4f} ms (bound {rows['update'][name]['bound_ms']:.4f}, PyTorch's _fused_adamw_ "
            f"{library_ms['update']:.4f}), whole step {step_ms:.4f} ms; plain body {plain_ms:.4f} ms (its isfinite "
            f"stack {plain_finite_ms:.4f} ms)")
        del kernel, params, tabs
        gc.collect()
        torch.cuda.empty_cache()
    return rows


def graph_vs_eager(label: str, make_model, cfg, batch, pool, key) -> None:
    """The captured step against its eager body. First the eager body of a
    fresh model, warmed once, runs one step under
    `torch.cuda.set_sync_debug_mode("error")`, which raises at any op that
    waits for the device (a read the capture would refuse). Then a fresh
    model with AdamW takes two steps through the graph on the same batch and
    key: step 0 is the eager body (the graph's warm-up, then its capture),
    step 1 the first replay. The capture adds the field query's gradients
    straight into every table's and vector's `.grad` (the gauges
    `field.grads_fresh` 0, `field.grads_in_place` all their entries); the
    peak memory of step 0 and of the replay is printed. A second model,
    given the first's parameters and AdamW state from before step 1, takes
    that step eagerly, its gradients in fresh buffers (no `.grad` yet): the
    loss bit-equal, each parameter's gradient at cosine ≥ GRAPH_GRAD_COSINE,
    each table's and vector's within KERNEL_TOL of its scale, the
    parameters after the update printed."""
    model = make_model()
    eager = make_train_step(cfg, model, adamw(model), pool.width, pool.height, graph=False)
    eager(batch, pool.pool, pool.grids, pool.aabb, key)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        eager(batch, pool.pool, pool.grids, pool.aabb, key)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    del model, eager

    def snapshot(model, what):
        return {n: (p.grad if what == "grad" else p).detach().clone() for n, p in model.named_parameters()}

    model_g, model_e = make_model(), make_model()
    opt_g, opt_e = adamw(model_g), adamw(model_e)
    tables = {id(t) for segment in model_g.segments for t in fli._flat([segment.field()])}
    table_names = [n for n, p in model_g.named_parameters() if id(p) in tables]
    graphed = make_train_step(cfg, model_g, opt_g, pool.width, pool.height, graph=True)
    device = next(model_g.parameters()).device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    graphed(batch, pool.pool, pool.grids, pool.aabb, key)  # step 0: the warm-up, then the capture
    torch.cuda.synchronize()
    peak_capture = torch.cuda.max_memory_allocated(device)
    counters = profiling.snapshot()["counters"]
    gauges = {k: counters.get(k) for k in ("field.grads_in_place", "field.grads_fresh")}
    entries = sum(p.numel() for n, p in model_g.named_parameters() if n in table_names)
    if gauges != {"field.grads_in_place": entries, "field.grads_fresh": 0}:
        raise AssertionError(f"{label}: the captured step's field backward reports {gauges}; expected all "
                             f"{entries} table and vector entries added in place, none fresh")
    with torch.no_grad():
        for p_e, p_g in zip(model_e.parameters(), model_g.parameters()):
            p_e.copy_(p_g)
        for a, b in zip((opt_e.count, opt_e.skipped, opt_e.notfinite_count, opt_e.last_finite, *opt_e.mu, *opt_e.nu),
                        (opt_g.count, opt_g.skipped, opt_g.notfinite_count, opt_g.last_finite, *opt_g.mu, *opt_g.nu)):
            a.copy_(b)
    runs = {}
    for graph, model, step in ((True, model_g, graphed),
                               (False, model_e, make_train_step(cfg, model_e, opt_e, pool.width, pool.height,
                                                                graph=False))):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        loss, _ = step(batch, pool.pool, pool.grids, pool.aabb, key)  # step 1 (the graph's first replay)
        torch.cuda.synchronize()
        runs[graph] = (float(loss), snapshot(model, "grad"), snapshot(model, "param"),
                       torch.cuda.max_memory_allocated(device))
    del model_g, model_e, opt_g, opt_e, graphed, step, model
    (loss_e, grads_e, params_e, peak_e), (loss_g, grads_g, params_g, peak_g) = runs[False], runs[True]
    cosines = {n: cosine(grads_g[n], grads_e[n]) for n in grads_e}
    worst = min(cosines, key=cosines.get)
    scaled = {n: float((grads_g[n].double() - grads_e[n].double()).abs().max() / grads_e[n].abs().max())
              for n in table_names if grads_e[n].any()}
    worst_table = max(scaled, key=scaled.get)
    moved = max(float((params_g[n] - params_e[n]).abs().max()) for n in params_e)
    log(f"{label} graph vs eager: the eager body ran a step under sync debug mode \"error\" (no op waited for the "
        f"device); from the same state, the graph's first replay (step 1) loss {loss_g!r}, eager {loss_e!r} "
        f"(bit-equal {loss_g == loss_e}); gradient cosine min {cosines[worst]:.8f} ({worst}); tables' and vectors' "
        f"gradients added in place ({gauges['field.grads_in_place']} entries) against the eager body's fresh "
        f"buffers: scaled err max {scaled[worst_table]:.3e} ({worst_table}); parameters after the update differ by "
        f"at most {moved:.3e}; peak memory allocated: graph step 0 (eager warm-up and capture) "
        f"{peak_capture / 2**30:.3f} GiB, its first replay {peak_g / 2**30:.3f} GiB, the eager step "
        f"{peak_e / 2**30:.3f} GiB")
    if loss_g != loss_e:
        raise AssertionError(f"{label}: the graph's first replayed loss {loss_g!r} is not the eager body's {loss_e!r}")
    if not cosines[worst] >= GRAPH_GRAD_COSINE:
        raise AssertionError(f"{label}: the graph's first replayed gradient of {worst} has cosine "
                             f"{cosines[worst]:.8f} to the eager body's")
    if not scaled[worst_table] < KERNEL_TOL:
        raise AssertionError(f"{label}: the graph's in-place gradient of {worst_table} differs from the eager body's "
                             f"fresh one by {scaled[worst_table]:.3e} of its scale")
    torch.cuda.empty_cache()


def train(device, view, pool) -> dict:
    """Phase 5 (see the module docstring). → the main path's launches."""
    model = fresh_model(device, view)
    cfg = train_config(view)
    log(f"train: fresh model, {sum(p.numel() for p in model.parameters())} parameters; {cfg}; "
        f"pool of {len(pool.camera_names)} images at frames {sorted(set(pool.pool.frame_numbers.tolist()))}")
    generator = torch.Generator(device).manual_seed(1)
    key = make_key(0, device)
    width, height = pool.width, pool.height

    batch = sample_batch(cfg, pool.pixel_rgba, generator)
    step0_kernel_vs_plain("train", make_train_step(cfg, model, _GradientsOnly(model), width, height, graph=False),
                          model, batch, pool, key)
    graph_vs_eager("train", lambda: fresh_model(device, view), cfg, batch, pool, key)

    roi_before = held_out_roi_psnr(model, view)
    log(f"held-out {view.camera_name} frame {view.frame_number} before training: ROI-PSNR {roi_before:.3f} dB")

    optimizer = adamw(model)
    step = make_train_step(cfg, model, optimizer, width, height)
    losses, mses, supervised, per_step_launches = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    start = None
    for i in range(TRAIN_STEPS):
        if i == WARM_STEPS:
            torch.cuda.synchronize()
            start = time.perf_counter()
        before = dict(fli.launches)
        b = sample_batch(cfg, pool.pixel_rgba, generator)
        loss, aux = step(b, pool.pool, pool.grids, pool.aabb, fold_in(key, torch.tensor(i, device=device)))
        per_step_launches.append({d: fli.launches[d] - before[d] for d in before})
        # The graph's outputs are overwritten by its next replay: kept as copies.
        losses.append(loss.clone())
        mses.append(aux["mse"].clone())
        supervised.append(aux["num_rays_supervised"].clone())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = read_launches("training", trains=True)
    peak = torch.cuda.max_memory_allocated(device)

    losses, mses = torch.stack(losses).cpu(), torch.stack(mses).cpu()
    supervised = torch.stack(supervised).cpu()
    warm = TRAIN_STEPS - WARM_STEPS
    ms_per_step = 1e3 * seconds / warm
    log(f"train (graph): {TRAIN_STEPS} steps, loss {float(losses[0]):.5f} → {float(losses[-1]):.5f}, "
        f"mse {float(mses[:5].mean()):.5f} (first 5) → {float(mses[-20:].mean()):.5f} (last 20); "
        f"skipped updates {int(optimizer.skipped)}; field query launches {launches}")
    log(f"train (graph): {ms_per_step:.2f} ms per warm step (mean of {warm}, batch draw included; the eager step "
        f"before the graphs: {EAGER_MS_PER_STEP['train step (5)']} ms), "
        f"{float(supervised[WARM_STEPS:].sum()) / seconds:.0f} supervised "
        f"rays/s ({float(supervised.float().mean()):.0f} supervised rays per step), peak memory {peak / 2**30:.2f} GiB")
    # One field query a step (the render pass, over both segments), forward and backward.
    expected = {"fwd": 1, "bwd": 1}
    bad = [i for i, n in enumerate(per_step_launches) if n != expected]
    if bad or launches != {d: n * TRAIN_STEPS for d, n in expected.items()}:
        raise AssertionError(f"training launched field query {launches}; steps {bad[:5]} differ from {expected} per step")
    check_adamw_per_step("training", model, TRAIN_STEPS)
    if not torch.isfinite(losses).all():
        raise AssertionError(f"non-finite training loss at steps {torch.nonzero(~torch.isfinite(losses)).flatten().tolist()}")
    if int(optimizer.skipped) != 0:
        raise AssertionError(f"{int(optimizer.skipped)} updates skipped as non-finite")
    if not float(mses[-20:].mean()) <= MSE_DROP * float(mses[:5].mean()):
        raise AssertionError("training mse did not fall to half its start")

    prof = profile_step(step, sample_batch(cfg, pool.pixel_rgba, generator), pool, key, device)
    log(f"train (graph): one profiled warm step: {prof['kernels']} kernels, {prof['device_ms']:.2f} ms of device "
        f"time in {prof['wall_ms']:.1f} ms profiled wall (its activities span {prof['span_vs_events']:.3f}× the "
        f"events' time); device busy {100 * prof['device_ms'] / ms_per_step:.1f}% "
        f"of a {ms_per_step:.2f} ms warm step; top: {prof['top']}")
    eager = make_train_step(cfg, model, optimizer, width, height, graph=False)
    step_windows("train", {"graph": step, "eager": eager}, cfg, pool, generator, key, device)

    roi_after = held_out_roi_psnr(model, view)
    steps_run = TRAIN_STEPS + 1 + 4 * (AB_WARM_STEPS + AB_STEPS + 1)
    log(f"held-out {view.camera_name} frame {view.frame_number} after {steps_run} steps: "
        f"ROI-PSNR {roi_after:.3f} dB (before {roi_before:.3f} dB)")
    if not roi_after > roi_before:
        raise AssertionError("training did not raise the held-out view's ROI-PSNR")
    return launches


def step_windows(label: str, steps: dict, cfg, pool, generator, key, device) -> None:
    """Training windows in turns, eager, graph, graph, eager: the eager body
    and the captured step, on one model and optimizer: ms per step, peak
    memory allocated in the window (a graph's private pool, taken at its
    capture before the window, is not in it; the main window's peak, which
    includes the capture, is the graph's), and one profiled step's kernel
    count, device time and busy share each."""
    results = {"eager": [], "graph": []}
    for turn, which in enumerate(("eager", "graph", "graph", "eager")):
        step = steps[which]
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
        log(f"{label} windows ({which}): {ms:.2f} ms per step over {AB_STEPS}, peak memory allocated in the window "
            f"{peak / 2**30:.3f} GiB; "
            f"profiled step: {prof['kernels']} kernels, {prof['device_ms']:.2f} ms device (span "
            f"{prof['span_vs_events']:.3f}× the events' time), busy "
            f"{100 * prof['device_ms'] / ms:.1f}%; top: {prof['top']}")
    for which, rows in results.items():
        ms = np.mean([r[0] for r in rows])
        device_ms = np.mean([r[2]["device_ms"] for r in rows])
        log(f"{label} windows ({which}) mean: {ms:.2f} ms per step, peak {max(r[1] for r in rows) / 2**30:.3f} GiB, "
            f"{np.mean([r[2]['kernels'] for r in rows]):.0f} kernels and {device_ms:.2f} ms device per profiled "
            f"step, busy {100 * device_ms / ms:.1f}%")


@contextlib.contextmanager
def device_profile():
    """`torch.profiler` over the CPU and CUDA, its window opened
    PROFILE_LEAD_S before the body. The profiler keeps only the device
    activities it places inside its window, and as this process ages it
    drops more of a window's first ones (a bisection: after each rank
    launch of phase 9 a window lost more of its first kernels; a window
    opened 0.1 s early kept them there). After phase 9 that is not enough:
    see `device_breakdown`."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_LEAD_S)
        yield prof


def profile_step(step, batch, pool, key, device) -> dict:
    """One warm step under torch.profiler: its CUDA kernels' count and summed
    time, and the five largest by self device time. The device's busy share
    is that sum over an unprofiled warm step's wall time (the profiler slows
    the host). The window opens PROFILE_LEAD_S early (`device_profile`).
    Raises unless the profiler holds the whole step: as many field query
    kernels as the step launched, and its device activities spanning
    0.7-1.3× the CUDA events' time around the step (a window that lost its
    first activities spans less)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    before = dict(fli.launches)
    with device_profile() as prof:
        t0 = time.perf_counter()
        start.record()
        step(batch, pool.pool, pool.grids, pool.aabb, fold_in(key, torch.tensor(TRAIN_STEPS, device=device)))
        end.record()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = sum(fli.launches[d] - before[d] for d in before)
    events_ms = start.elapsed_time(end)
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        raise AssertionError("torch.profiler saw no CUDA kernel in a training step")
    span_ms = (max(e.time_range.end for e in kernels) - min(e.time_range.start for e in kernels)) / 1e3
    seen = sum(1 for e in kernels if re.search(r"field_(fwd|bwd)_kernel", e.name))
    if seen != launched or not 0.7 * events_ms <= span_ms <= 1.3 * events_ms:
        raise AssertionError(f"torch.profiler saw {seen} field query kernels of the step's {launched}, its device "
                             f"activities spanning {span_ms:.3f} ms against {events_ms:.3f} ms by CUDA events: it "
                             f"does not hold the whole step in this process")
    top = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)[:5]
    return {
        "device_ms": sum(e.time_range.elapsed_us() for e in kernels) / 1e3,
        "wall_ms": 1e3 * wall,
        "kernels": len(kernels),
        "span_vs_events": span_ms / events_ms,
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


def cli_phase(name: str, scene: Path, ws: Path, flags, total_steps: int, kernels=fli) -> dict:
    """Phases 6, 7(c) and 12(c) (see the module docstring): `flags(steps,
    every)` is the run's command line. EARLY_STEPS steps validated and
    saved, then resumed to `total_steps` with validation and saves every
    half, the test frame rendered and evaluated, then RESUME_STEPS more. →
    the launches of the first two runs (of the field query, or of
    `kernels`' query), and the second run's `Trainer.run_stats`."""
    half = total_steps // 2
    evaluate = ["--training.checkpoint", "latest", "--evaluate", "true", "--evaluation.frame_numbers", "0"]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    cli.main(flags(EARLY_STEPS, EARLY_STEPS))
    result = cli.main(flags(total_steps, half) + evaluate)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches(name, trains=True, kernels=kernels)
    stats = result["train"]
    blocks = validation_blocks(ws)
    means = {step: float(np.mean(v)) for step, v in blocks.items()}
    log(f"{name}: {EARLY_STEPS} steps, then resumed to {total_steps} + 3 validations + test render + evaluation "
        f"in {wall:.1f} s wall; {'field' if kernels is fli else 'plane'} query launches {launches}; validation PSNR per "
        f"block {blocks}; evaluation {result['averages']}")
    before = {"cli": EAGER_MS_PER_STEP["cli (6)"], "dense cli": EAGER_MS_PER_STEP["dense cli (7(c))"]}.get(name)
    log(f"{name}: trainer scale ({stats['steps']} steps timed, the step a CUDA graph): {stats['ms_per_step']:.2f} ms "
        f"per step" + (f" (the eager step before the graphs: {before} ms)" if before else "") + ", "
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
        raise AssertionError(f"the CLI run launched {'field' if kernels is fli else 'plane'} query {launches}")

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
    reset_launches()
    img, first_s = timed_render(model, view, pcfg)
    launches = read_launches("the dense render", trains=False)
    times, images = {"plain": [], "eager": [], "graph": []}, {}
    for which in ("plain", "eager", "graph", "graph", "eager"):
        patch = field_swap() if which == "plain" else contextlib.nullcontext()
        with patch:
            images[which], seconds = timed_render(model, view, pcfg, graph=which == "graph")
        times[which].append(seconds)
    img_plain, img_eager = images["plain"], images["eager"]
    counts = dense_view_counts(model, pcfg, view)
    img_np = img.cpu().numpy()
    vs_plain = psnr(np.clip(img_np, 0, 1), np.clip(img_plain.cpu().numpy(), 0, 1))
    vs_eager = psnr(img_np, img_eager.cpu().numpy())
    roi = roi_psnr(to_u8(img), view.images["gt_rgb"], view.images["gt_mask"])
    per_view = {which: float(np.mean(runs)) for which, runs in times.items()}
    log(f"dense render ({pcfg.samples_per_ray} lattice points per ray, budgets {R4_DENSE['candidate_budget']} / "
        f"{R4_DENSE['sample_budget']} per {R4_DENSE['num_rays']} rays, scaled to {view.rays_batch_size}-ray batches): "
        f"graph, first (warm-up and capture included) {first_s:.3f} s; s per view "
        + "; ".join(f"{which} {', '.join(f'{t:.3f}' for t in runs)} ({1e3 * per_view[which] / num_batches:.1f} ms "
                    f"per batch)" for which, runs in times.items())
        + f"; field query launches {launches}")
    log(f"dense render: per view {describe_counts(counts)}; PSNR(kernel, plain) = {vs_plain:.2f} dB; PSNR(graph, "
        f"eager) = {vs_eager:.2f} dB (bit-equal {bool(torch.equal(img, img_eager))}); ROI-PSNR vs ground truth "
        f"{roi:.3f} dB (phase 4's proposal render {proposal_roi:.3f} dB)")
    if not torch.equal(img, img_eager):
        raise AssertionError(f"the dense graph render differs from the eager render: {vs_eager:.2f} dB")
    if img_np.shape != view.images["gt_rgb"].shape or not np.isfinite(img_np).all():
        raise AssertionError(f"the dense render is not a finite image of the view's shape: {img_np.shape}")
    if not vs_plain >= RENDER_PSNR_MIN:
        raise AssertionError(f"dense kernel render differs from the plain render: {vs_plain:.2f} dB < {RENDER_PSNR_MIN}")
    if launches["fwd"] == 0 or launches["bwd"] != 0:
        raise AssertionError(f"the dense render launched field query {launches}")

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


def dense_train(device, pool) -> tuple:
    """Phase 7(b): the dense step at the paper's field width (see the module
    docstring). → (its launches, the field query's rows {pass: {direction:
    row}})."""
    model = paper_model(device)
    cfg = pipeline.PipelineConfig(**DENSE_STEP_CONFIG)
    log(f"dense step: fresh paper-width model, {sum(p.numel() for p in model.parameters())} parameters, "
        f"T = {model.segment_grid_configs[0].grid.table_size} per segment; {cfg}")
    generator = torch.Generator(device).manual_seed(2)
    key = make_key(0, device)
    width, height = pool.width, pool.height

    batch = sample_batch(cfg, pool.pixel_rgba, generator)
    grads_step = make_train_step(cfg, model, _GradientsOnly(model), width, height, graph=False)
    queries = capture_queries(grads_step, batch, pool, key)
    log(f"dense step-0 queries: render pass {served_count(queries['render'])} of "
        f"{queries['render']['xyzt'].shape[0]} slots, prune pass {served_count(queries['prune'])} of "
        f"{queries['prune']['xyzt'].shape[0]}")
    query_rows = {where: query_checks(f"dense {where}", query, where == "render") for where, query in queries.items()}
    del queries
    step0_kernel_vs_plain("dense", grads_step, model, batch, pool, key)
    graph_vs_eager("dense", lambda: paper_model(device), cfg, batch, pool, key)

    optimizer = adamw(model)
    step = make_train_step(cfg, model, optimizer, width, height)
    losses, mses, supervised, per_step = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    reset_launches()
    start = None
    for i in range(DENSE_STEPS):
        if i == WARM_STEPS:
            torch.cuda.synchronize()
            start = time.perf_counter()
        before = dict(fli.launches)
        b = sample_batch(cfg, pool.pixel_rgba, generator)
        loss, aux = step(b, pool.pool, pool.grids, pool.aabb, fold_in(key, torch.tensor(i, device=device)))
        per_step.append({d: fli.launches[d] - before[d] for d in before})
        losses.append(loss.clone())
        mses.append(aux["mse"].clone())
        supervised.append(aux["num_rays_supervised"].clone())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    launches = read_launches("the dense step", trains=True)
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

    log(f"dense step (graph): {DENSE_STEPS} steps, loss {float(losses[0]):.5f} → {float(losses[-1]):.5f}, mse "
        f"{float(mses[:5].mean()):.5f} (first 5) → {float(mses[-20:].mean()):.5f} (last 20); skipped updates "
        f"{int(optimizer.skipped)}; field query launches {launches} ({per_step[-1]} in the last step)")
    log(f"dense step (graph): {ms_per_step:.2f} ms per warm step (mean of {warm}, batch draw included; the eager step before "
        f"the graphs {EAGER_MS_PER_STEP['dense step (7(b))']} ms), "
        f"{cfg.num_rays * warm / seconds:.0f} rays/s, {float(supervised[WARM_STEPS:].sum()) / seconds:.0f} supervised rays/s "
        f"({float(supervised.float().mean()):.0f} supervised rays per step), peak memory {peak / 2**30:.2f} GiB")
    log(f"dense step: {DENSE_STATS_STEPS} more batches through the trained model's sampler (no update): "
        f"{describe_counts(counts)}")
    log(f"dense step (graph): one profiled warm step: {prof['kernels']} kernels, {prof['device_ms']:.2f} ms of device "
        f"time in {prof['wall_ms']:.1f} ms profiled wall (its activities span {prof['span_vs_events']:.3f}× the "
        f"events' time); device busy {100 * prof['device_ms'] / ms_per_step:.1f}% "
        f"of a {ms_per_step:.2f} ms warm step; top: {prof['top']}")
    step_windows("dense", {"graph": step, "eager": make_train_step(cfg, model, optimizer, width, height, graph=False)},
                 cfg, pool, generator, key, device)
    # Per step: the prune and the render pass each make one field query, and
    # the render pass's takes one backward.
    expected = {"fwd": 2, "bwd": 1}
    if any(n != expected for n in per_step):
        raise AssertionError(f"the dense step launched field query {launches}, not {expected} in every step")
    check_adamw_per_step("the dense step", model, DENSE_STEPS)
    if not torch.isfinite(losses).all():
        raise AssertionError("non-finite dense training loss")
    if int(optimizer.skipped) != 0:
        raise AssertionError(f"{int(optimizer.skipped)} dense updates skipped as non-finite")
    if not float(mses[-20:].mean()) <= MSE_DROP * float(mses[:5].mean()):
        raise AssertionError("dense training mse did not fall to half its start")
    return launches, query_rows


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
    reset_launches()
    t0 = time.perf_counter()
    cli.main(flags)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches("the trajectory phases", trains=False)

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
        f"(loaders and checkpoint loads included); field query launches {launches}; "
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
    if not (launches["fwd"] > 0 and launches["bwd"] == 0):
        raise AssertionError(f"the trajectory phases launched field query {launches}")
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
        time.sleep(PROFILE_LEAD_S)  # see `device_profile`: the window's first kernels are kept
        window["start"] = dict(fli.launches)
        window["t0"] = time.perf_counter_ns()

    def stop(self):
        window["stop"] = dict(fli.launches)
        # The recorder's steps in the trace: a span is a CPU event of the trace.
        window["steps"] = [s.id for s in profiling.snapshot()["spans"]["train.step"]
                           if s.annotated and s.start_ns >= window["t0"]]
        return real_stop(self)

    try:
        annotations.write_text("\n".join(rows) + "\n")
        with mock.patch.object(DataLoader, "_light_ok", light_ok), mock.patch.object(Trace, "start", start), \
                mock.patch.object(Trace, "stop", stop):
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            stats = cli.main(flags)["train"]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        annotations.write_bytes(original)
    launches = read_launches("the light-bloom run", trains=True)

    share = pixels["filtered"] / max(pixels["all"], 1)
    (events_file,) = (ws / "run").glob("events.out.tfevents.*")
    events = read_events(events_file)
    ((_, supervised),) = [e for e in events["scalars"]["throughput/supervised_rays_per_sec"] if e[0] == 20]
    log(f"light bloom: {BLOOM_STEPS} CLI steps with discs in {len(BLOOM_CAMERAS)} train cameras in {wall:.1f} s "
        f"wall (pool load, a profiled window and a validation included); filtered pixels {pixels['filtered']} of "
        f"{pixels['all']} loaded ({100 * share:.3f}%); {supervised:.0f} supervised rays/s over steps 2–20 (the "
        f"events' window; phase 6's timed windows: {cli_stats['supervised_rays_per_s']:.0f}); skipped updates "
        f"{stats['skipped_nonfinite']}; field query launches {launches}")
    if not share > 0:
        raise AssertionError("the light-bloom filter dropped no pool pixel")
    if stats["skipped_nonfinite"] != 0:
        raise AssertionError(f"{stats['skipped_nonfinite']} updates skipped as non-finite")

    tags = set(events["scalars"])
    log(f"events: {events_file.name}: scalars {sorted(tags)}, images {sorted(events['images'])}")
    if tags != JAX_SCALAR_TAGS or not events["images"]:
        raise AssertionError(f"the events hold scalars {sorted(tags)} and images {sorted(events['images'])}, "
                             f"not the JAX trainer's {sorted(JAX_SCALAR_TAGS)} and its comparison images")

    traces, gap_files = sorted(profile_dir.glob("*.pt.trace.json")), sorted(profile_dir.glob("*.gaps.json"))
    if len(traces) != 1 or len(gap_files) != 1:
        raise AssertionError(f"expected one trace and its gaps in {profile_dir}, found {traces} {gap_files}")
    trace_events = json.loads(traces[0].read_text())["traceEvents"]
    gaps = json.loads(gap_files[0].read_text())["idle_gaps"]
    steps = window["steps"]
    step_events = sum(e.get("name") == "train.step" for e in trace_events)
    traced = {d: sum(e.get("cat") == "kernel" and f"field_{d}_kernel" in e.get("name", "") for e in trace_events)
              for d in ("fwd", "bwd")}
    in_window = {d: window["stop"][d] - window["start"][d] for d in ("fwd", "bwd")}
    log(f"profile: {traces[0].name} ({traces[0].stat().st_size / 2**20:.1f} MiB), steps {steps}; field query "
        f"kernels in the trace {traced}, launches counted in its window {in_window}; idle gaps {gaps}")
    if steps != list(range(20, 25)) or step_events != 5:
        raise AssertionError(f"the trace holds steps {steps} ({step_events} train.step events), not 20–24")
    if not gaps or any(label != "other" and "." not in label for label, _ in gaps):
        raise AssertionError(f"the trace's idle gaps {gaps} are not labelled by the program's spans")
    if not (launches["fwd"] > 0 and launches["bwd"] > 0):
        raise AssertionError(f"the light-bloom run launched field query {launches}")
    if traced != in_window or not min(traced.values()) > 0:
        raise AssertionError(f"the trace holds field query kernels {traced}; its window launched {in_window}")
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


def mesh_work(params: raster.CameraParams, num_vertices: int, num_faces: int, fragments: int,
              entries: int) -> tuple:
    """The least bytes and operations of each step for one frame in every
    camera, by its contract (each input read once, each output written
    once) → ({step: bytes}, {step: operations}). `rasterize`: vertices and
    faces in, 1 B of mask and 4 B of depth per pixel out; `mesh_project`:
    vertices in, (C, V, 4) out; `mesh_bin`: faces and projections in, the
    tile offsets and the `entries` (triangle, tile) pairs out; `mesh_raster`:
    faces, projections, offsets and pairs in, mask and depth out.
    Operations: the projection per (camera, vertex), the setup per (camera,
    triangle) (per pair in `mesh_raster`) and the test per fragment drawn."""
    C, pixels, tiles = params.floats.shape[0], params.total, params.tiles
    projected = 16 * C * num_vertices
    nbytes = {"project": 12 * num_vertices + projected,
              "bin": 12 * num_faces + projected + 4 * (tiles + 1) + 4 * entries,
              "raster": 12 * num_faces + projected + 4 * (tiles + 1) + 4 * entries + 5 * pixels,
              "rasterize": 12 * num_vertices + 12 * num_faces + 5 * pixels}
    setup, drawn = RASTER_SETUP_OPS * C * num_faces, RASTER_FRAGMENT_OPS * fragments
    ops = {"project": PROJECT_OPS * C * num_vertices, "bin": setup,
           "raster": RASTER_SETUP_OPS * entries + drawn}
    ops["rasterize"] = ops["project"] + setup + drawn
    return nbytes, ops


def mesh_launches(frames: int) -> dict:
    """The mesh kernels' launches for `frames` frames through `rasterize`."""
    return {"project": frames, "bin": 2 * frames, "raster": frames}


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


def same_bins(bins: raster.Bins, plain: raster.Bins, num_faces: int) -> bool:
    """The kernel's tile lists against `rasterize.bin_plain`'s: offsets,
    crowded slots and counts equal, each tile's faces equal as sets."""
    tile = torch.repeat_interleave(torch.arange(bins.offsets.numel() - 1, device=bins.offsets.device),
                                   (bins.offsets[1:] - bins.offsets[:-1]).long())
    faces = (torch.sort(tile * num_faces + bins.entries.long())[0] % num_faces).to(torch.int32)
    return (torch.equal(bins.offsets, plain.offsets) and torch.equal(bins.slots, plain.slots)
            and (bins.crowded, bins.most) == (plain.crowded, plain.most) and torch.equal(faces, plain.entries))


def mesh_ab(v, f, cameras, device, chunk: int = raster.PLAIN_CHUNK) -> dict:
    """Each mesh kernel against its plain version on the same inputs, bit
    for bit (the projections, the tile lists, and the masks and depths of
    `mesh_raster`) → the frame's record: the lists, the kernel's flat
    mask and depth, fragments, max errors and the plain version's seconds
    per step (one call each, host clock around a synchronize)."""
    params = raster.CameraParams.build(cameras, device)
    plain_s = {}

    def plain(step, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        plain_s[step] = time.perf_counter() - t0
        return out

    def plain_raster():
        buf, drawn = raster.depth_buffer_plain(plain_proj, f, params, chunk)
        return (*raster.resolve(buf), drawn)

    plain_proj = plain("project", lambda: raster.project_plain(v, params, 1.0))
    plain_bins = plain("bin", lambda: raster.bin_plain(plain_proj, f, params))
    plain_mask, plain_depth, fragments = plain("raster", plain_raster)
    plain_s["rasterize"] = plain_s["project"] + plain_s["raster"]

    proj = raster.launch_project(v, params, 1.0)
    bins = raster.launch_bin(proj, f, params)
    torch.cuda.synchronize()
    if not torch.equal(proj.view(torch.int32), plain_proj.view(torch.int32)):
        raise AssertionError("mesh_project differs from its plain version")
    if not same_bins(bins, plain_bins, f.shape[0]):
        raise AssertionError("mesh_bin's tile lists differ from the plain version's")
    finite = torch.isfinite(proj) & torch.isfinite(plain_proj)
    errors = {"project": float((proj - plain_proj)[finite].abs().max()), "bin": 0.0}
    del plain_proj, plain_bins
    mask, depth = raster.launch_raster(proj, f, params, bins)
    differ = (mask != plain_mask) | (depth.view(torch.int32) != plain_depth.view(torch.int32))
    if bool(differ.any()):
        first = int(torch.nonzero(differ)[0])
        camera = int(torch.searchsorted(params.ints[:, 2], torch.tensor(first, device=device), right=True)) - 1
        raise AssertionError(f"mesh_raster differs from the plain version on {int(differ.sum())} pixels (the first "
                             f"in camera {camera})")
    errors["raster"] = float((depth - plain_depth).abs().max())
    del differ
    return {"params": params, "proj": proj, "bins": bins, "views": (mask, depth),
            "fragments": int(fragments.sum()), "errors": errors, "plain_s": plain_s}


def mesh_times(v, f, cameras, ab: dict, iters: int) -> dict:
    """Device ms of each step (CUDA events; `mesh_bin` with its host read)."""
    params, proj, bins = ab["params"], ab["proj"], ab["bins"]
    return {"project": time_ms(lambda: raster.launch_project(v, params, 1.0), iters),
            "bin": time_ms(lambda: raster.launch_bin(proj, f, params), iters),
            "raster": time_ms(lambda: raster.launch_raster(proj, f, params, bins), iters),
            "rasterize": time_ms(lambda: raster.rasterize(v, f, cameras), iters)}


def mesh_rows(v, f, cameras, ab: dict, ms: dict, plain_s: dict) -> dict:
    """{step: (ms, plain ms, bound ms, bound_by)} for one frame."""
    nbytes, ops = mesh_work(ab["params"], v.shape[0], f.shape[0], ab["fragments"], ab["bins"].entries.numel())
    return {step: (ms[step], 1e3 * plain_s[step], *bound(nbytes[step], ops[step])) for step in MESH_STEPS}


def mesh_phase(scene: Path, tmp: Path, device, smi: str) -> list:
    """Phase 10 (see the module docstring) → the mesh kernels' records."""
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
    if render_launches != mesh_launches(NUM_FRAMES):
        raise AssertionError(f"the render launched {render_launches}, not {mesh_launches(NUM_FRAMES)}")
    if not ious.min() >= MESH_IOU_MIN:
        raise AssertionError(f"a view's mask IoU is {ious.min():.5f} (< {MESH_IOU_MIN})")

    rows, errors, fragments, pairs = [], {}, 0, 0
    for frame in MESH_AB_FRAMES:
        v, f = on_device[frame]
        ab = mesh_ab(v, f, cameras, device)
        for (mask, depth), (kept_mask, kept_depth) in zip(raster.views(*ab["views"], ab["params"]), kept[frame]):
            if not (torch.equal(mask, kept_mask)
                    and torch.equal(depth.view(torch.int32), kept_depth.view(torch.int32))):
                raise AssertionError(f"frame {frame}: a rendered view differs from the plain version's")
        rows.append(mesh_rows(v, f, cameras, ab, mesh_times(v, f, cameras, ab, iters=20), ab["plain_s"]))
        errors = {step: max(errors.get(step, 0.0), e) for step, e in ab["errors"].items()}
        fragments += ab["fragments"] / (len(MESH_AB_FRAMES) * len(cameras))
        pairs += ab["bins"].entries.numel() / (len(MESH_AB_FRAMES) * len(cameras))
    per_view = {}
    for step in MESH_STEPS:
        ms, plain_ms, bound_ms = (sum(r[step][k] for r in rows) / (len(rows) * len(cameras)) for k in range(3))
        per_view[step] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": rows[0][step][3]}
        log(f"10(b) {step} at frames {MESH_AB_FRAMES}, per view: kernel {ms:.5f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.5f} ms ({rows[0][step][3]}), {100 * bound_ms / ms:.1f}% of it [{smi}]")
    v, f = on_device[MESH_AB_FRAMES[0]]
    # The profiled breakdowns run in one fresh process at the end of the phase.
    breakdowns = {f"10(b) frame {MESH_AB_FRAMES[0]}": (v, f, cameras, rows[0]["raster"][0])}
    log(f"10(b) kernels against plain at frames {MESH_AB_FRAMES} × {len(cameras)} cameras: bit-equal (projections, "
        f"tile lists, masks and depths); {fragments:.0f} fragments and {pairs:.0f} (triangle, "
        f"tile) pairs per view")

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
    if rc != 0 or cli_launches != mesh_launches(len(MESH_CLI_FRAMES)):
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
    if rig_launches != mesh_launches(1):
        raise AssertionError(f"the rig's frame launched {rig_launches}")
    plain = raster.rasterize_plain(v, f, [rig[i] for i in RIG_CHECK_CAMERAS])
    for i, (plain_mask, plain_depth) in zip(RIG_CHECK_CAMERAS, plain):
        mask, depth = rig_views[i]
        if not (torch.equal(mask, plain_mask) and torch.equal(depth.view(torch.int32), plain_depth.view(torch.int32))):
            raise AssertionError(f"rig camera {i}: the kernel's view differs from the plain version's")
    params = raster.CameraParams.build(rig, device)
    proj = raster.launch_project(v, params, 1.0)
    rig_ab = {"params": params, "proj": proj, "bins": raster.launch_bin(proj, f, params)}
    rig_ms = {step: ms / RIG_CAMERAS for step, ms in mesh_times(v, f, rig, rig_ab, iters=5).items()}
    log(f"10(d) rig: {RIG_CAMERAS} cameras at {rig[0].width}x{rig[0].height}, frame 0: launches {rig_launches}; "
        f"cameras {RIG_CHECK_CAMERAS} bit-equal to the plain version; ms per view: "
        + ", ".join(f"{step} {ms:.5f}" for step, ms in rig_ms.items()) + f" [{smi}]")
    del rig_views, rig_ab, proj
    log(f"10: mesh phase (a)-(d) in {time.perf_counter() - t_phase:.1f} s")
    rig_12mp_ms = rig_12mp_phase(tmp, device, smi, breakdowns)
    for label, line in zip(breakdowns, device_breakdowns(list(breakdowns.values()))):
        log(f"{label}, one profiled rasterize: {line}")
    by_phase = {"mesh_render": render_launches, "mesh_cli": cli_launches, "mesh_rig": rig_launches}
    return [
        {
            "name": name,
            "route": "cuda",
            "source": "humanrf_torch/csrc/mesh_raster.cu",
            "replaces": f"humanrf_tpu/native/mesh_renderer/main.cpp:{line}",
            "launches": render_launches[step],
            "launches_by_phase": {phase: counts[step] for phase, counts in by_phase.items()},
            "max_abs_err": errors[step],
            **per_view[step],
            "library_ms": None,  # no PyTorch call rasterizes
            "per": "view, the mean over frames 0, 25 and 49 × 12 cameras of 748²",
            "rasterize": per_view["rasterize"],
            "fragments_per_view": fragments,
            "rig_ms": rig_ms[step],
            "rig_12mp_ms": rig_12mp_ms[step],
        }
        for name, step, line in (("mesh_project", "project", 237), ("mesh_bin", "bin", 251),
                                 ("mesh_raster", "raster", 251))
    ]


def device_breakdowns(jobs: list) -> list:
    """For each job (v, f, cameras, raster_ms), one `raster.rasterize(v, f,
    cameras)` under torch.profiler, all in one fresh process of this script
    (`--breakdown`, a warm-up call before each) → each one's breakdown
    (`profiled_breakdown`). Late in this script, after phase 9's
    rank processes ran on the card, the profiler's windows in this process
    lose their first device activities: a bisection saw the loss grow after
    each of 9(a)-(d), and in the full script even a window opened 0.1 s
    early read no `mesh_raster_kernel` at all; a fresh process reads it
    whole, as `--mesh-only` always did."""
    with tempfile.TemporaryDirectory(prefix="breakdown_") as tmp:
        inputs = Path(tmp) / "inputs.pt"
        torch.save([(v.cpu(), f.cpu(), cameras, raster_ms) for v, f, cameras, raster_ms in jobs], inputs)
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--breakdown", str(inputs)],
                              capture_output=True, text=True)
    if proc.returncode != 0:
        raise AssertionError(f"the profiled rasterize in a fresh process failed:\n{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    return proc.stdout.strip().splitlines()[-len(jobs):]


def breakdown_child(inputs: Path) -> int:
    """`--breakdown INPUTS`: the fresh process of `device_breakdowns`."""
    device = torch.device("cuda", 0)
    load_library("mesh_raster", raster.LIBRARY_DEFINES)
    for v, f, cameras, raster_ms in torch.load(inputs, weights_only=False):
        v, f = v.to(device), f.to(device)
        raster.rasterize(v, f, cameras)
        print(profiled_breakdown(lambda: raster.rasterize(v, f, cameras), raster_ms), flush=True)
    return 0


def profiled_breakdown(fn, raster_ms: float) -> str:
    """One call of `fn` under torch.profiler → its device time per kernel
    (and copy or fill) and the device's busy share of the call's wall time.
    Kernels launched through ctypes join no PyTorch op: the sums take each
    device activity's own row of `key_averages`, and skip the ops' rows
    (`aten::*`), whose device time their kernels' rows already hold. Raises
    unless the profiler read `mesh_raster_kernel` at 0.7-1.3× `raster_ms`,
    its mean time by CUDA events (a fresh process read 0.91-1.02×; late in
    the full script, where a window lost its first activities, 0.52× and
    nothing)."""
    with device_profile() as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    def name(key: str) -> str:
        return key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0].strip()[:40]

    rows = sorted(((e.device_time_total / 1e3, name(e.key), e.count)
                   for e in prof.key_averages() if e.device_time_total > 0 and not e.key.startswith("aten::")),
                  reverse=True)
    seen = sum(ms for ms, key, _ in rows if key == "mesh_raster_kernel")
    if not 0.7 * raster_ms <= seen <= 1.3 * raster_ms:
        raise AssertionError(f"torch.profiler read mesh_raster_kernel as {seen:.4f} ms against {raster_ms:.4f} ms by "
                             f"CUDA events ({wall:.4f} ms wall): its device times do not hold in this process")
    busy = sum(ms for ms, _, _ in rows)
    return (f"device {busy:.4f} ms of {wall:.4f} ms wall ({100 * busy / wall:.1f}% busy; mesh_raster_kernel "
            f"{seen / raster_ms:.2f}× its events time): "
            + ", ".join(f"{name} {ms:.4f} ms ×{count}" for ms, name, count in rows[:8]))


def rig_12mp_phase(tmp: Path, device, smi: str, breakdowns: dict) -> dict:
    """Phase 10(e): the ActorsHQ rig at its full size, RIG_CAMERAS cameras of
    RIG_12MP (every tenth portrait), at RIG_12MP_FRAMES: each kernel against
    its plain version in every camera, bit for bit; ms per frame and per view
    of each step with its bound; fragments per view; peak memory; then the
    renderer's CLI for one frame with --mask → {step: ms per view}. Frame
    0's profiled breakdown goes into `breakdowns` (`device_breakdowns`)."""
    t_phase = time.perf_counter()
    cfg = dataclasses.replace(R4_SCENE, num_cameras=RIG_CAMERAS, portrait_camera_indices=RIG_12MP_PORTRAIT,
                              **RIG_12MP)
    csv = tmp / "rig_12mp_calibration.csv"
    write_calibration_csv(make_cameras(cfg), csv)
    rig = mesh_io.read_calibration_f32(csv)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    totals = {step: 0.0 for step in MESH_STEPS}
    objs = {frame: tmp / f"rig_12mp_{frame:06d}.obj" for frame in RIG_12MP_FRAMES}
    for frame, obj in objs.items():
        mesh_io.write_obj(obj, *subject_mesh(R4_SCENE, frame))
        v, f = (torch.from_numpy(a).to(device) for a in mesh_io.load_obj(obj))  # the mesh as the CLI reads it
        ab = mesh_ab(v, f, rig, device, RIG_12MP_PLAIN_CHUNK)
        if frame == RIG_12MP_FRAMES[0]:  # a portrait and a landscape mask, for the CLI's files
            kept = {i: raster.views(*ab["views"], ab["params"])[i][0].cpu().numpy() for i in (0, 1)}
        del ab["views"]
        rows = mesh_rows(v, f, rig, ab, mesh_times(v, f, rig, ab, iters=3), ab["plain_s"])
        for step, (ms, plain_ms, bound_ms, bound_by) in rows.items():
            totals[step] += ms
            log(f"10(e) frame {frame}, {step}: {ms:.4f} ms per frame, {ms / len(rig):.6f} per view; plain "
                f"{plain_ms:.1f} ms; bound {bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / ms:.1f}% of it [{smi}]")
        if frame == RIG_12MP_FRAMES[0]:  # profiled at the end of phase 10 (`device_breakdowns`)
            breakdowns[f"10(e) frame {frame}"] = (v, f, rig, rows["raster"][0])
        log(f"10(e) frame {frame}: {ab['fragments'] / len(rig):.0f} fragments and "
            f"{ab['bins'].entries.numel() / len(rig):.0f} "
            f"(triangle, tile) pairs per view; all {len(rig)} cameras bit-equal to the plain version (projections, "
            f"tile lists, masks and depths)")
        del ab
    log(f"10(e) peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the plain version's buffers and "
        f"the kernels' held together)")

    out = tmp / "rig_12mp_cli"
    torch.cuda.synchronize()
    raster.reset_launches()
    t0 = time.perf_counter()
    if mesh_renderer.main(["--objs", str(objs[RIG_12MP_FRAMES[0]]), "--csv", str(csv), "--output", str(out),
                           "--mask", "--device", device.type]) != 0:
        raise AssertionError("10(e): the mesh renderer's CLI failed")
    cli_s = time.perf_counter() - t0
    cli_launches = dict(raster.launches)
    pngs = sorted(out.rglob("*.png"))
    if len(pngs) != len(rig) or cli_launches != mesh_launches(1):
        raise AssertionError(f"10(e): the CLI wrote {len(pngs)} masks for {len(rig)} cameras, launches {cli_launches}")
    for i, mask in kept.items():
        name = rig[i].name
        png = image_io.decode_png((out / "masks" / name / f"{name}_mask000000.png").read_bytes())
        if not np.array_equal(png[..., 0], mask):
            raise AssertionError(f"10(e): the CLI's mask of {name} differs from the kernel's view")
    shutil.rmtree(out)
    log(f"10(e) the CLI, one frame of {len(rig)} views of {RIG_12MP['width']}x{RIG_12MP['height']} with --mask: "
        f"{cli_s:.2f} s, {cli_s / len(rig):.4f} s per view with the OBJ load and PNG writes; launches "
        f"{cli_launches}; phase 10(e) in {time.perf_counter() - t_phase:.1f} s [{smi}]")
    return {step: ms / (len(RIG_12MP_FRAMES) * len(rig)) for step, ms in totals.items()}


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
            losses.append(loss.detach().clone())  # a graph's output is overwritten by its next replay
            return loss, aux

        return recorded

    with mock.patch.object(trainer_module, "make_train_step", make):
        yield losses


@contextlib.contextmanager
def first_render_query():
    """The first field query made with autograd on (step 0's render pass, in
    the graph's warm-up) → a dict that `query_of` fills."""
    captured, query_fn = {}, fused_field.field_query

    def capture(fields, xyzt, n_valid=None, seg=None):
        if torch.is_grad_enabled() and not captured:
            captured.update(query_of(fields, xyzt, n_valid, seg))
        return query_fn(fields, xyzt, n_valid, seg)

    with mock.patch.object(fused_field, "field_query", capture):
        yield captured


def reset_launches() -> None:
    """Sets the launch counts of the field query, the plane query and AdamW to 0."""
    fli.reset_launches()
    kplanes_ops.reset_launches()
    adamw_kernels.reset_launches()


def read_launches(name: str, trains: bool, kernels=fli) -> dict:
    """The launches since the last reset → the field query's {"fwd",
    "bwd"} (with `kernels=kplanes_ops`, the plane query's); AdamW's go into
    ADAMW_LAUNCHES[name]. Raises unless AdamW's two kernels launched as
    often as each other, some times in a phase that `trains` and never in
    one that does not."""
    launches = dict(kernels.launches)
    adamw = dict(adamw_kernels.launches)
    if adamw["finite"] != adamw["update"] or (adamw["update"] > 0) != trains:
        raise AssertionError(f"{name} launched AdamW's kernels {adamw} ({'a' if trains else 'no'} training phase)")
    ADAMW_LAUNCHES[name] = adamw["update"]
    return launches


def check_adamw_per_step(name: str, model, steps: int) -> None:
    """Raises unless the phase `name` launched each of AdamW's kernels once
    a step per table of `model`'s parameters (`read_launches` counted them)."""
    tables = len(adamw_kernels.plan([p.numel() for p in model.parameters()]))
    log(f"{name}: AdamW's kernels launched {ADAMW_LAUNCHES[name]} times each in {steps} steps ({tables} table)")
    if ADAMW_LAUNCHES[name] != tables * steps:
        raise AssertionError(f"{name} launched AdamW's kernels {ADAMW_LAUNCHES[name]} times each, not {tables} a "
                             f"step over {steps} steps")


def counted(name: str, fn, backward: bool):
    """`fn()` with the launch counts set to 0 before and read after → (its
    result, the field query's launches); raises unless both directions (or,
    without `backward`, the forward alone) launched, or unless AdamW
    launched where, and only where, a backward did (`read_launches`)."""
    torch.cuda.synchronize()
    reset_launches()
    result = fn()
    torch.cuda.synchronize()
    launches = read_launches(name, trains=backward)
    if not (launches["fwd"] > 0 and (launches["bwd"] > 0) == backward):
        raise AssertionError(f"{name} launched field query {launches}")
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


def multiseg_phase(tmp: Path, device, r4_stats: dict) -> tuple:
    """11(c): `multiseg` at MULTISEG_SIZE² over 100 frames, MULTISEG_STEPS
    steps and one validation; the field query's kernels at step 0's render
    query over the four segments → (the launches, {direction: row})."""
    root = tmp / "multiseg"
    t0 = time.perf_counter()
    with drivers_in_process() as runs, recorded_losses() as losses, first_render_query() as query:
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
        f"{stats['ms_per_step']:.2f} ms per step ({stats['steps']} timed; the eager step before the graphs: "
        f"{EAGER_MS_PER_STEP['multiseg (11(c))']} ms), field_interp launches per step "
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
    if len(query["fields"]) != 4:
        raise AssertionError(f"11(c)'s render query has {len(query['fields'])} segments")
    return launches, query_checks("multiseg render", query, backward=True)


def capacity_phase(tmp: Path, device) -> tuple:
    """11(d): `quality_at_capacity`'s gather-ref-capacity arm (L16/F2, log2
    24: T = 2^22 on one 25-frame segment) at CAPACITY_SIZE² for
    CAPACITY_STEPS steps, no validation and no save; the field query's
    kernels at step 0's render query → (the launches, {direction: row})."""
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
        f"{stats['ms_per_step']:.2f} ms per step ({stats['steps']} timed; the eager step before the graphs: "
        f"{EAGER_MS_PER_STEP['ref capacity (11(d))']} ms); skipped updates "
        f"{stats['skipped_nonfinite']}; peak memory {peak:.2f} GiB; field_interp launches per step "
        f"{per_step(stats['field_interp_launches'], steps_of(stats))}; {results[0]}")
    if segments != [CAPACITY_FRAMES] or T != CAPACITY_T:
        raise AssertionError(f"the reference-capacity arm ran segments {segments} at T = {T}")
    if not np.isfinite(stats["first_loss"]) or stats["skipped_nonfinite"] != 0:
        raise AssertionError(f"step-0 loss {stats['first_loss']}, {stats['skipped_nonfinite']} updates skipped")

    if [int(f.grids[0].shape[-1]) for f in query["fields"]] != [CAPACITY_T]:
        raise AssertionError(f"11(d)'s render query reads tables of {[f.grids[0].shape for f in query['fields']]}")
    return launches, query_checks("ref capacity render", query, backward=True)


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
        f"{time.perf_counter() - t0:.1f} s wall; {stats['ms_per_step']:.2f} ms per step ({stats['steps']} timed; the eager "
        f"step before the graphs {EAGER_MS_PER_STEP['throughput (11(e))']} ms), "
        f"{stats['rays_per_s']:.0f} rays/s nominal, {stats['supervised_rays_per_s']:.0f} supervised, host fetch "
        f"{100 * stats['fetch_share']:.1f}%; the probe's own reading {result['ms_per_step']} ms, "
        f"{result['rays_per_s']} rays/s")
    if stats["start_step"] != throughput_probe.RESUME_STEP or stats["skipped_nonfinite"] != 0:
        raise AssertionError(f"the throughput probe ran {stats}")
    return launches


def protocol_phase(scene: Path, tmp: Path, device, r4_stats: dict) -> tuple:
    """Phase 11 → ({sub-phase: launches}, {"multiseg" (11(c)), "ref_capacity"
    (11(d), T = 2^22): the field query's {direction: row}})."""
    t0 = time.perf_counter()
    frame0_psnr, eval_launches = evaluate_phase(scene, tmp, device)
    launches = {"evaluate": eval_launches, "parallax": parallax_phase(tmp, frame0_psnr, device)}
    rows = {}
    launches["multiseg"], rows["multiseg"] = multiseg_phase(tmp, device, r4_stats)
    launches["ref_capacity"], rows["ref_capacity"] = capacity_phase(tmp, device)
    launches["throughput"] = throughput_phase(scene, tmp, device)
    log(f"11: protocol phase in {time.perf_counter() - t0:.1f} s")
    return launches, rows


# ------------------------------------------------------------------ phase 12


@contextlib.contextmanager
def plane_queries():
    """The first differentiated plane queries of the next train step, run
    eagerly (a graph's warm-up; never its capture) → a list that fills, in
    call order, with copies of their inputs: {"planes", "coords", "n_valid",
    "seg"}."""
    captured, query_fn = [], kplanes_model.plane_query

    def capture(planes, coords, n_valid=None, seg=None):
        if (torch.is_grad_enabled() and len(captured) < len(KPLANES_QUERIES)
                and not torch.cuda.is_current_stream_capturing()):
            captured.append({"planes": [t.detach().clone() for t in planes], "coords": coords.detach().clone(),
                             "n_valid": None if n_valid is None else n_valid.clone(),
                             "seg": None if seg is None else seg.clone()})
        return query_fn(planes, coords, n_valid, seg)

    with mock.patch.object(kplanes_model, "plane_query", capture):
        yield captured


def touched_texels(planes, coords) -> int:
    """The plane texels that the taps of `coords` touch, each once, summed
    over the planes of every scale."""
    total = 0
    for s in range(len(planes) // 6):
        res = kplanes_ops._resolution(planes[6 * s:6 * s + 6])
        taps = [kplanes_ops._taps(coords[:, a], res[a]) for a in range(4)]
        for pair in kplanes_ops.PLANES:
            idx, _ = kplanes_ops._corners(taps, pair, res[pair[0]])
            total += int(torch.unique(torch.cat(idx)).numel())
    return total


def grid_sample_query(planes_nchw, grids) -> torch.Tensor:
    """The library's plane query: per scale the product of `F.grid_sample`
    over its six (1, M, res_j, res_i) planes at `grids[p]` (1, n, 1, 2),
    the scales concatenated → (n, S·M)."""
    feats = []
    for s in range(len(planes_nchw) // 6):
        f = None
        for p in range(6):
            v = F.grid_sample(planes_nchw[6 * s + p], grids[p], mode="bilinear", padding_mode="border",
                              align_corners=True)
            f = v if f is None else f * v
        feats.append(f[0, :, :, 0])
    return torch.cat(feats).t()


def plane_query_checks(label: str, query: dict) -> dict:
    """The plane query's kernels at a train step's query (`plane_queries`),
    one launch each way as the main path makes them → {direction: row}.
    The forward against `plane_query_plain` bit for bit; every plane's
    backward within KERNEL_TOL of its scale against `plane_query_bwd_plain`
    summed in fp64 (fresh gradient buffers, as outside the train step's
    `grads_in_place()`); else it raises. Each is timed (the backward adding
    into buffers that are there, as in the train step) beside the plain
    version and the library's (`grid_sample_query` over the served
    samples), with its bound: the forward reads the served samples'
    coordinates and each touched texel once and writes the features over
    every slot, per served sample, scale and plane 4 taps × M multiply-adds
    and the product; the backward reads the served cotangents, each touched
    texel once and its gradient entry once each way, at twice the
    forward's operations (the lookups again, then the taps' adds)."""
    planes, q, n_valid, seg = query["planes"], query["coords"], query["n_valid"], query["seg"]
    gen = torch.Generator(q.device).manual_seed(0)
    with torch.no_grad():
        for t, pair in zip(planes, kplanes_ops.PLANES * (len(planes) // 6)):
            if pair[1] == 3:
                t.copy_(1.0 + 0.2 * (torch.rand(t.shape, generator=gen, device=t.device) - 0.5))
    N, S, M = q.shape[0], len(planes) // 6, planes[0].shape[-1]
    live = kplanes_ops._live(N, q.device, n_valid, seg)
    served_q = q if live is None else q[live]
    n = served_q.shape[0]
    texels = touched_texels(planes, served_q)
    ops = n * S * 6 * (2 * 4 * M + M)
    dims = {"shape": "plane query", "query": label, "N": N, "served": n, "scales": S, "M": M,
            "res": [kplanes_ops._resolution(planes[6 * s:6 * s + 6]) for s in range(S)], "texels": texels}

    out = kplanes_ops._launch_fwd(planes, q, n_valid, seg)
    ref = kplanes_ops.plane_query_plain(planes, q, n_valid, seg)
    planes_nchw = [t.permute(2, 0, 1)[None].contiguous() for t in planes]
    grids = [served_q[:, list(pair)].reshape(1, -1, 1, 2).contiguous() for pair in kplanes_ops.PLANES]
    library = grid_sample_query(planes_nchw, grids)
    served_out = out if live is None else out[live]
    torch.cuda.synchronize()
    rows = {"fwd": dict(dims, max_abs_err=float((out - ref).abs().max()), bit_exact=bool(torch.equal(out, ref)),
                        library_err=float((library - served_out).abs().max() / served_out.abs().max()))}
    if not rows["fwd"]["bit_exact"]:
        raise AssertionError(f"kplanes_fwd at {label} differs from the plain query by {rows['fwd']['max_abs_err']:.3e}")
    if not rows["fwd"]["library_err"] < KERNEL_TOL:
        raise AssertionError(f"F.grid_sample at {label} differs from the kernel by {rows['fwd']['library_err']:.3e} "
                             f"of scale: the library line computes something else")
    with torch.no_grad():
        rows["fwd"].update(ms=time_ms(lambda: kplanes_ops._launch_fwd(planes, q, n_valid, seg), iters=10),
                           plain_ms=time_ms(lambda: kplanes_ops.plane_query_plain(planes, q, n_valid, seg), iters=2),
                           library_ms=time_ms(lambda: grid_sample_query(planes_nchw, grids), iters=10))
    rows["fwd"]["bound_ms"], rows["fwd"]["bound_by"] = bound(
        16 * n + (0 if n_valid is None else 4) + 4 * N * S * M + 4 * M * texels, ops)
    del out, ref, library, served_out

    g = torch.randn((N, S * M), generator=gen, device=q.device)
    grads = kplanes_ops._launch_bwd(planes, q, g, n_valid, seg)
    refs = kplanes_ops.plane_query_bwd_plain(planes, q, g.double(), n_valid, seg)
    torch.cuda.synchronize()
    scaled = max(float((a.double() - b).abs().max() / b.abs().max()) for a, b in zip(grads, refs))
    del refs
    if not scaled < KERNEL_TOL:
        raise AssertionError(f"kplanes_bwd at {label} disagrees with the fp64 plain sum: scaled err {scaled:.3e}")
    leaves = [t.requires_grad_() for t in planes_nchw]
    g_served = g if live is None else g[live]

    def library_fwd_bwd():
        torch.autograd.grad(grid_sample_query(leaves, grids), leaves, g_served)

    with torch.no_grad():
        library_fwd = time_ms(lambda: grid_sample_query(planes_nchw, grids), iters=10)
    rows["bwd"] = dict(dims, max_abs_err=scaled, bit_exact=False,
                       ms=time_ms(lambda: kplanes_ops._run("kplanes_bwd", planes, q, g, n_valid, seg, grads), iters=10),
                       plain_ms=time_ms(lambda: kplanes_ops.plane_query_bwd_plain(planes, q, g, n_valid, seg),
                                        iters=2),
                       library_ms=time_ms(library_fwd_bwd, iters=10) - library_fwd)
    rows["bwd"]["bound_ms"], rows["bwd"]["bound_by"] = bound(16 * n + (0 if n_valid is None else 4) + 4 * n * S * M
                                                             + 3 * 4 * M * texels, 2 * ops)
    del grads, g, g_served, leaves, planes_nchw
    for direction, row in rows.items():
        check = ("bit-exact against the plain query" if direction == "fwd"
                 else f"scaled err {row['max_abs_err']:.2e} against the fp64 sum")
        log(f"kernel kplanes_{direction} {label}: {S} scale(s) of M={M} at {dims['res']}, {N} slots serving {n} "
            f"({texels} texels touched): {check}; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms "
            f"({row['plain_ms'] / row['ms']:.0f}×), F.grid_sample {row['library_ms']:.4f} ms "
            f"({row['library_ms'] / row['ms']:.1f}×), bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"{100 * row['bound_ms'] / row['ms']:.1f}% of it")
    torch.cuda.empty_cache()
    return rows


def regularizer_checks(model) -> dict:
    """The regularisers' kernels at `model`'s planes, as the main path
    launches them → {"fwd", "bwd"} rows. The forward's scalar within REG_TOL
    of the plain formulas summed in fp64 and bit-equal between two
    launches; the backward (fresh buffers, as outside the train step's
    `grads_in_place()`) bit-equal to `plane_reg_bwd_plain` on every plane;
    else it raises. Each is timed (the backward adding into buffers that
    are there, as in the train step) beside today's autograd path over the
    plain formulas (`plain_regularization`, eager; its backward as fwd +
    bwd − fwd), with its bound: the forward reads every entry once (4 B), the
    backward reads it and reads and writes its gradient (12 B)."""
    fields, weights = model.regularizer_inputs()
    planes = [t.detach() for f in fields for t in f]
    terms = kplanes_ops.reg_terms(fields, weights)
    entries = sum(t.numel() for t in planes)
    dims = {"shape": "plane regularisers", "planes": len(planes), "entries": entries}
    out = kplanes_ops._launch_reg_fwd(planes, terms)
    again = kplanes_ops._launch_reg_fwd(planes, terms)
    total = 0.0
    for f, w in zip(fields, weights):
        total += sum(wk * float(term) for wk, term in zip(w, kplanes_model.plane_regularizers(
            [t.detach().double() for t in f])))
    rel = abs(float(out) - total) / abs(total)
    rows = {"fwd": dict(dims, max_abs_err=rel, bit_exact=bool(torch.equal(out, again)))}
    if not (rel < REG_TOL and rows["fwd"]["bit_exact"]):
        raise AssertionError(f"plane_reg_fwd reads {float(out)!r} (again {float(again)!r}), the fp64 formulas {total!r}")
    g = torch.ones((), device=out.device)
    grads = kplanes_ops._launch_reg_bwd(planes, terms, g)
    mirror = kplanes_ops.plane_reg_bwd_plain(fields, weights, g)
    bad = [i for i, (a, b) in enumerate(zip(grads, mirror)) if not torch.equal(a, b)]
    if bad:
        raise AssertionError(f"plane_reg_bwd differs from plane_reg_bwd_plain on planes {bad}")
    del mirror
    leaves = [p for f in fields for p in f]
    held = [p.grad for p in leaves]
    with torch.no_grad():
        plain_fwd = time_ms(model.plain_regularization, iters=10)
    plain_both = time_ms(lambda: model.plain_regularization().backward(), iters=10)
    if any(p.grad is not h for p, h in zip(leaves, held)):
        raise AssertionError("the plain backward replaced a plane's .grad, which the captured step reads")
    # The kernels alone, their tables built once: a graph replays them so.
    fwd_table = kplanes_ops._reg_struct(planes, terms)
    partial = torch.empty(fwd_table.n_blocks, dtype=torch.float64, device=out.device)
    table = kplanes_ops._reg_struct(planes, terms, grads, [True] * len(planes))
    rows["fwd"].update(plain_ms=plain_fwd, ms=time_ms(lambda: kplanes_ops._reg_call(
        "plane_reg_fwd", planes, fwd_table, partial.data_ptr(), out.data_ptr())))
    rows["bwd"] = dict(dims, max_abs_err=0.0, bit_exact=True, plain_ms=plain_both - plain_fwd,
                       ms=time_ms(lambda: kplanes_ops._reg_call("plane_reg_bwd", planes, table, g.data_ptr())))
    for direction, nbytes in (("fwd", 4 * entries), ("bwd", 12 * entries)):
        row = rows[direction]
        row["bound_ms"], row["bound_by"] = bound(nbytes, 0)
        log(f"kernel plane_reg_{direction}: {len(planes)} planes, {entries} entries: "
            + ("within {:.1e} of the fp64 formulas, bit-equal between launches".format(rel) if direction == "fwd"
               else "bit-equal to plane_reg_bwd_plain")
            + f"; kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms ({row['plain_ms'] / row['ms']:.1f}×), "
            f"bound {row['bound_ms']:.4f} ms ({row['bound_by']}), {100 * row['bound_ms'] / row['ms']:.1f}% of it")
    del grads, table, partial
    torch.cuda.empty_cache()
    return rows


def kplanes_trainer(scene: Path, ws: Path, device):
    """The K-Planes training program as the CLI builds it (`r4_flags` then
    KPLANES_FLAGS) → (trainer, loader)."""
    config = parse_args(r4_flags(scene, ws, KPLANES_STEPS, KPLANES_STEPS) + KPLANES_FLAGS)
    data_folder = scene / config.dataset.actor / config.dataset.sequence / f"{config.dataset.scale}x"
    frames = tuple(config.dataset.frame_numbers)
    model = cli.build_model(config, cli.compute_segment_sizes(config, data_folder, frames), device)
    cameras = cli.derive_synthetic_presets(VolumetricDataset(data_folder))[config.training.camera_preset]
    loader = DataLoader(
        dataset=VolumetricDataset(data_folder, config.dataset.crop_center_square), mode=DataLoader.Mode.TRAINING,
        space_pruning_mode=DataLoader.SpacePruningMode.OCCUPANCY_GRID, frame_numbers=frames,
        batch_size=config.training.rays_initial_batch_size * config.tpu.candidate_rays_factor,
        camera_numbers=cameras, max_buffer_size=config.dataset.max_buffer_size,
        max_num_frames_per_batch=config.dataset.max_num_frames_per_batch, use_mask=True,
        filter_light_bloom=config.dataset.filter_light_bloom, deterministic=config.dataset.deterministic_loader,
        seed=config.random_seed, device=device,
    )
    trainer = Trainer(config=config, workspace=ws, checkpoint=None, model=model,
                      pipeline_config=cli.build_pipeline_config(config), optimizer=cli.optimizer_factory(config),
                      resolution=loader.resolution, seed=config.random_seed)
    return trainer, loader


def kplanes_phase(scene: Path, tmp: Path, device) -> tuple:
    """Phase 12 (see the module docstring) → (the plane query's launches by
    phase, its 12(a) rows by query)."""
    t0 = time.perf_counter()
    trainer, loader = kplanes_trainer(scene, tmp / "kplanes_step", device)
    model, step_fn, aabb = trainer.model, trainer.train_step_fn, loader.device_aabb
    log(f"12: K-Planes, {sum(p.numel() for p in model.parameters())} parameters "
        f"({sum(t.numel() for f in (model.field, *(p.field for p in model.proposals)) for t in f.planes())} in "
        f"planes); {trainer.pcfg}")
    it = iter(loader)

    def one_step():
        trainer.rng, key = split(trainer.rng)
        batch, pool, grids, _ = next(it)
        return step_fn(batch, pool, grids, aabb, key)

    with plane_queries() as captured:
        one_step()  # the graph's warm-up and capture
    torch.cuda.synchronize()
    shapes = {label: (q["coords"].shape[0], len(q["planes"]) // 6, q["planes"][0].shape[-1])
              for label, q in zip(KPLANES_QUERIES, captured)}
    if shapes != KPLANES_QUERIES:
        raise AssertionError(f"the train step's plane queries are {shapes}, not {KPLANES_QUERIES}")
    rows = {label: plane_query_checks(label, q) for label, q in zip(KPLANES_QUERIES, captured)}
    del captured
    rows["model"] = regularizer_checks(model)

    # (b) the graphed step, the launch counts reset just before.
    losses, per_step = [], []
    torch.cuda.synchronize()
    reset_launches()
    start = time.perf_counter()
    for _ in range(KPLANES_STEPS):
        before = dict(kplanes_ops.launches)
        loss, aux = one_step()
        per_step.append({d: kplanes_ops.launches[d] - before[d] for d in before})
        losses.append(loss.clone())
    torch.cuda.synchronize()
    seconds = time.perf_counter() - start
    step_launches = read_launches("kplanes step", trains=True, kernels=kplanes_ops)
    losses = torch.stack(losses).cpu()
    log(f"12(b): {KPLANES_STEPS} graphed steps in {seconds:.2f} s ({1e3 * seconds / KPLANES_STEPS:.2f} ms a step, "
        f"fetch included), loss {float(losses[0]):.5f} → {float(losses[-1]):.5f}; plane query launches "
        f"{step_launches}; skipped updates {int(trainer.optimizer.skipped)}")
    expected = {"fwd": len(KPLANES_QUERIES), "bwd": len(KPLANES_QUERIES), "reg_fwd": 2, "reg_bwd": 1}
    bad = [i for i, n in enumerate(per_step) if n != expected]
    if bad or step_launches != {d: n * KPLANES_STEPS for d, n in expected.items()}:
        raise AssertionError(f"the K-Planes step launched plane query {step_launches}; steps {bad[:5]} differ from "
                             f"{expected} a step")
    counters = profiling.snapshot()["counters"]
    log(f"12(b): kplanes.reg_entries {counters['kplanes.reg_entries']}, field.plane_params "
        f"{counters['field.plane_params']}")
    if counters["kplanes.reg_entries"] != counters["field.plane_params"]:
        raise AssertionError(f"the regularisers covered {counters['kplanes.reg_entries']} entries, not the "
                             f"{counters['field.plane_params']} of the planes")
    check_adamw_per_step("kplanes step", model, KPLANES_STEPS)
    if not torch.isfinite(losses).all() or int(trainer.optimizer.skipped):
        raise AssertionError(f"non-finite K-Planes losses or skipped updates ({int(trainer.optimizer.skipped)})")
    loader.shutdown()
    del trainer, model, step_fn, it, loader
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the CLI.
    ws = tmp / "kplanes_workspace"
    cli_launches, _ = cli_phase("kplanes cli", scene, ws,
                                lambda steps, every: r4_flags(scene, ws, steps, every) + KPLANES_FLAGS,
                                KPLANES_CLI_STEPS, kernels=kplanes_ops)
    log(f"12: K-Planes phase in {time.perf_counter() - t0:.1f} s")
    return {"kplanes_step": step_launches, "kplanes_cli": cli_launches}, rows


def kplanes_records(launches: dict, rows: dict) -> list:
    """The kernel table's rows of the plane query's two kernels and of the
    regularisers' two."""
    model = rows.pop("model")
    return [
        {
            "name": f"kplanes_{direction}",
            "route": "cuda",
            "source": "humanrf_torch/csrc/kplanes.cu",
            "replaces": "none: F.grid_sample per plane and scale and their product (K-Planes' "
                        "interpolate_ms_features)",
            "launches": launches["kplanes_step"][direction],
            "launches_by_phase": {phase: counts[direction] for phase, counts in launches.items()},
            **{label: by_direction[direction] for label, by_direction in rows.items()},
        }
        for direction in ("fwd", "bwd")
    ] + [
        {
            "name": f"plane_reg_{direction}",
            "route": "cuda",
            "source": "humanrf_torch/csrc/kplanes.cu",
            "replaces": "none: autograd over models/kplanes.py::plane_regularizers (K-Planes' plane TV, time "
                        "smoothness and L1 regularisers)",
            "launches": launches["kplanes_step"][f"reg_{direction}"],
            "launches_by_phase": {phase: counts[f"reg_{direction}"] for phase, counts in launches.items()},
            "model": model[direction],
        }
        for direction in ("fwd", "bwd")
    ]


def finish(records: list, smi: str) -> int:
    """The last three lines: the kernel table, the card, the result."""
    print(json.dumps({"kernels": records}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()},
    }))
    return 0


def render_phase(device, view) -> tuple:
    """Phase 4 (see the module docstring) → (best.ckpt's model, the render's
    launches, its ROI-PSNR)."""
    params, _, step, _, _ = load_checkpoint(RUN_DIR / "best.ckpt")
    model = HumanRFModel(view.model_config, device=device)
    model.load_state_dict(convert_params(params))
    model.eval()
    width, height = view.inputs.width, view.inputs.height
    num_pixels = width * height
    num_batches = -(-num_pixels // view.rays_batch_size)
    frame = view.frame_number
    # Every batch makes one field query, over both segments.
    expected_launches = num_batches
    log(f"model: best.ckpt step {step}, segments {view.model_config.segment_sizes}, "
        f"{sum(p.numel() for p in model.parameters())} parameters; view {view.camera_name} frame {frame}, "
        f"{width}x{height}, {num_batches} batches of {view.rays_batch_size} rays")

    reset_launches()
    img, first_s = timed_render(model, view)
    launches = read_launches("the render", trains=False)
    log(f"render (graph, first: warm-up and capture included): {first_s:.3f} s, {num_pixels / first_s:.0f} rays/s, "
        f"field query launches {launches}")
    if launches != {"fwd": expected_launches, "bwd": 0}:
        raise AssertionError(f"the render launched field query {launches}, expected {expected_launches} forward "
                             f"and nothing else")

    # Warm renders: plain (the field's query swapped for its plain version)
    # once, far slower, then the eager render and the graphs in turns; the
    # swap and the eager render run the render function eagerly (a graph
    # replays what it captured).
    times = {"plain": [], "eager": [], "graph": []}
    for which in ("plain", "eager", "graph", "graph", "eager"):
        if which == "plain":
            with field_swap():
                img_plain, seconds = timed_render(model, view, graph=False)
        else:
            out, seconds = timed_render(model, view, graph=which == "graph")
            if which == "eager":
                img_eager = out
        times[which].append(seconds)
    for which, runs in times.items():
        mean = sum(runs) / len(runs)
        log(f"render ({which}): " + ", ".join(f"{t:.3f}" for t in runs)
            + f" s per view; mean {mean:.3f} s, {1e3 * mean / num_batches:.1f} ms per batch, {num_pixels / mean:.0f} "
            f"rays/s" + (f" (the eager render before the graphs: {EAGER_S_PER_VIEW} s)" if which == "graph" else ""))
    vs_eager = psnr(img.cpu().numpy(), img_eager.cpu().numpy())
    log(f"PSNR(graph render, eager render) = {vs_eager:.2f} dB (bit-equal {bool(torch.equal(img, img_eager))})")
    if not torch.equal(img, img_eager):
        raise AssertionError(f"the graph render differs from the eager render: {vs_eager:.2f} dB")

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
    return model, launches, port_roi


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--breakdown"] and len(argv) == 2:
        return breakdown_child(Path(argv[1]))
    if argv not in ([], ["--mesh-only"], ["--kplanes-only"]):
        raise SystemExit(f"usage: python3 chip_smoke.py [--mesh-only | --kplanes-only]; got {argv}")
    mesh_only, kplanes_only = argv == ["--mesh-only"], argv == ["--kplanes-only"]
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
    names = {"field_interp": (), "mesh_raster": raster.LIBRARY_DEFINES, "adamw": (), "kplanes": ()}
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(load_library, names, names.values())))
    for name, lib in built.items():
        log(f"build: {lib.path.name} in {lib.build_seconds:.2f} s; per kernel, from -Xptxas -v (shared memory is "
            f"dynamic, set at launch): " + "; ".join(ptxas_summary(lib.ptxas_log)))

    if mesh_only:
        with tempfile.TemporaryDirectory(prefix="humanrf_r4_") as tmp:
            records = mesh_phase(write_r4_scene(device, Path(tmp)), Path(tmp), device, smi)
        return finish(records, smi)
    if kplanes_only:
        with tempfile.TemporaryDirectory(prefix="humanrf_r4_") as tmp:
            records = kplanes_records(*kplanes_phase(write_r4_scene(device, Path(tmp)), Path(tmp), device))
        return finish(records, smi)

    # Phase 2(b): AdamW's kernels at the three training models' parameter lists.
    view = load_view_inputs(RUN_DIR / "torch_view_inputs.npz", device)
    adamw_rows = adamw_phase(device, view)

    # Phase 3: the field query's kernels against their plain version at real positions.
    train_pool = load_train_inputs(RUN_DIR / "torch_train_inputs.npz", device)
    real_query = capture_real_query(device, view, train_pool)
    log(f"real positions: phase 5's step-0 render query serves {served_count(real_query)} samples of "
        f"{real_query['xyzt'].shape[0]} slots")
    r4_query = query_checks("r4 render", real_query, backward=True)
    del real_query

    # Phase 4: the render.
    model, launches, port_roi = render_phase(device, view)

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
        dense_step_launches, dense_query = dense_train(device, train_pool)
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
        protocol_launches, protocol_query = protocol_phase(scene, Path(tmp), device, cli_stats)

        # Phase 12: K-Planes.
        kplanes_launches, kplanes_rows = kplanes_phase(scene, Path(tmp), device)

    by_phase = {"render": launches, "train_step": train_launches, "cli": cli_launches,
                "dense_render": dense_render_launches, "dense_step": dense_step_launches, "dense_cli": dense_cli_launches,
                "trajectory": trajectory_launches, "light_bloom_cli": bloom_launches, **parallel_launches,
                **protocol_launches}
    records = [
        {
            "name": f"field_query_{direction}",
            "route": "cuda",
            "source": "humanrf_torch/csrc/field_interp.cu",
            "replaces": f"humanrf_tpu/ops/fused_interp.py:{line} with the composition of "
                        "humanrf_tpu/models/fused_field.py",
            "launches": sum(counts[direction] for counts in protocol_launches.values()),
            "launches_by_phase": {phase: counts[direction] for phase, counts in by_phase.items()},
            "library_ms": None,  # no one PyTorch call computes the corners, the lookups and their composition
            **r4_query[direction],
            "dense": {where: rows[direction] for where, rows in dense_query.items() if direction in rows},
            **{where: rows[direction] for where, rows in protocol_query.items()},
        }
        for direction, line in (("fwd", 87), ("bwd", 97))
    ] + mesh_records + [
        {
            "name": f"adamw_{kind}",
            "route": "cuda",
            "source": "humanrf_torch/csrc/adamw.cu",
            "replaces": "the per-tensor eager ops of humanrf_torch/train/trainer.py::AdamW._update_plain "
                        "(no TPU kernel: optax's adamw, fused by XLA)",
            "launches": sum(ADAMW_LAUNCHES.values()),
            "launches_by_phase": dict(ADAMW_LAUNCHES),
            **rows,
        }
        for kind, rows in adamw_rows.items()
    ] + kplanes_records(kplanes_launches, kplanes_rows)
    return finish(records, smi)


if __name__ == "__main__":
    sys.exit(main())
