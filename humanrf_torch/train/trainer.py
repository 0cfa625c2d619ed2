"""Training, validation, test and checkpoints around the pipeline.

Counterpart of `humanrf_tpu/train/trainer.py`:

- `make_lr_schedule` and `make_optimizer`: the JAX package's optax
  `apply_if_finite(adamw(...), max_consecutive_errors=10**9)`, as `AdamW`, a
  small class in plain torch ops;
- `Trainer`: the train loop (step keys split from PRNGKey(seed + 1), the
  loss/throughput bookkeeping every 20 and 500 steps, the replacer paused
  around saves and validation, TensorBoard events under `run/` with the
  JAX package's tags, a `torch.profiler` trace of steps 20–24 with
  `--tpu.profile_dir`), `validate` (validation.txt and the validation
  images), `test` (the test frames, or numbered frames and an ffmpeg video),
  and the rolling, best and resumed checkpoints in the JAX package's
  format;
- `sample_batch`: a training batch drawn from a baked pool of images by an
  explicit `torch.Generator` (the loader's TRAINING draw, without the loader);
- `render_pipeline_config`: the pipeline settings of a render batch, the
  dense budgets scaled to its size (the JAX `Trainer._get_render_fn`);
- `render_image`: the batched pixel loop of `Trainer.test` over one image.

With a process group of several ranks (`humanrf_torch/parallel`) the
`Trainer` trains data-parallel, or with `--tpu.param_sharding fsdp` with
its segment tables sharded, as the JAX trainer does over its mesh: rank 0
alone owns the training loader and broadcasts its batches (`parallel/feed.
py`), and rank 0 alone writes the events, validation, images, checkpoints
and trace, while the other ranks wait at a barrier.

Not ported: the K-step dispatch scan and the HBM preflight (the port keeps
K = 1's semantics).
"""
from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from humanrf_torch.convert import convert_params, export_params, load_opt_state, opt_state_to_jax
from humanrf_torch.core import image_io
from humanrf_torch.evaluation.metrics import LpipsModel, bounding_rect, compute_psnr, compute_ssim
from humanrf_torch.models.humanrf import HumanRFModel
from humanrf_torch.ops import field_interp as fli
from humanrf_torch.parallel import fsdp
from humanrf_torch.parallel.collectives import all_reduce_, all_true
from humanrf_torch.parallel.feed import Feed
from humanrf_torch.parallel.mesh import make_sharded_train_step
from humanrf_torch.train.checkpoint import CHECKPOINT_SUFFIX, load_checkpoint, resolve_checkpoint, save_checkpoint
from humanrf_torch.train.pipeline import HostBatch, PipelineConfig, PoolArrays, make_render_fn, make_train_step
from humanrf_torch.utils.profiling import Trace
from humanrf_torch.utils.rngs import make_key, split
from humanrf_torch.utils.summary import SummaryWriter

MAX_NUM_CHECKPOINTS = 2  # rolling step checkpoints kept beside best.ckpt


def make_lr_schedule(lr: float, lr_decay: float, max_steps: int):
    """lr · decay^min(step / max_steps, 1) in float32, for a step count tensor."""

    def schedule(step: torch.Tensor) -> torch.Tensor:
        return lr * lr_decay ** torch.clamp(step.float() / max_steps, max=1.0)

    return schedule


class AdamW:
    """optax `adamw(schedule, b1, b2, eps, weight_decay)` inside
    `apply_if_finite(max_consecutive_errors=10**9)`.

    An applied update is

        m ← (1−b1)·g + b1·m,   v ← (1−b2)·g² + b2·v,   t ← t + 1
        p ← p − lr(t−1)·( (m / (1−b1^t)) / (√(v / (1−b2^t)) + eps) + wd·p )

    where t (`count`) counts only applied updates. A step whose gradients
    hold any inf or NaN changes nothing (parameters, moments, t); it never
    gives up and applies one (the JAX package's `make_optimizer` says why).
    The state beside the moments is `apply_if_finite`'s: `notfinite_count`
    (consecutive skipped steps), `last_finite` (whether the last step was
    applied) and `skipped` (all skipped steps, optax's `total_notfinite`).
    Every choice is made on the device with `torch.where`, so a step never
    waits for the device. Parameters without a gradient take a zero one, as
    optax does with a zero cotangent. `torch.optim`'s fused Adam is not used:
    its state and skip semantics differ from optax's. b1, b2 and eps are the
    reference's (run.py:101).

    `named_params` are (name, parameter) pairs as `named_parameters()` gives
    them; the names (the model's state-dict keys) map the state onto optax's
    tree (`convert.opt_state_to_jax`). `group`, set by the FSDP step
    (`parallel/fsdp.py`), is the process group over which the skip is
    agreed: there each rank holds only its shards' gradients, and every rank
    must apply or skip together, as `apply_if_finite` sees the whole
    gradient.
    """

    b1, b2, eps = 0.9, 0.99, 1e-15

    def __init__(self, named_params: Iterable, lr: float, lr_decay: float, max_steps: int, weight_decay: float):
        self.names, self.params = map(list, zip(*named_params))
        self.schedule = make_lr_schedule(lr, lr_decay, max_steps)
        self.weight_decay = weight_decay
        device = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int64, device=device)            # applied updates
        self.skipped = torch.zeros((), dtype=torch.int64, device=device)          # non-finite steps skipped
        self.notfinite_count = torch.zeros((), dtype=torch.int64, device=device)  # consecutive skips
        self.last_finite = torch.ones((), dtype=torch.bool, device=device)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.group = None

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        if self.group is not None:
            finite = all_true(finite, self.group)
        count_inc = (self.count + 1).float()
        step_size = -self.schedule(self.count)
        bc1 = 1.0 - self.b1**count_inc
        bc2 = 1.0 - self.b2**count_inc
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu_new = (1.0 - self.b1) * g + self.b1 * mu
            nu_new = (1.0 - self.b2) * g**2 + self.b2 * nu
            update = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + self.eps) + self.weight_decay * p
            p.copy_(torch.where(finite, p + step_size * update, p))
            mu.copy_(torch.where(finite, mu_new, mu))
            nu.copy_(torch.where(finite, nu_new, nu))
        self.count += finite.long()
        self.skipped += (~finite).long()
        self.notfinite_count.copy_(torch.where(finite, 0, self.notfinite_count + 1))
        self.last_finite.copy_(finite)


def make_optimizer(named_params: Iterable, lr: float, lr_decay: float, max_steps: int,
                   weight_decay: float = 0.0) -> AdamW:
    """Adam(β = 0.9/0.99, eps = 1e-15) with decoupled weight decay, the
    lr · decay^(step/max_steps) schedule and non-finite-update skipping:
    `humanrf_tpu/train/trainer.py::make_optimizer` over `named_params`, the
    model's `named_parameters()` (see `AdamW`)."""
    return AdamW(named_params, lr, lr_decay, max_steps, weight_decay)


def sample_batch(cfg: PipelineConfig, pixel_rgba: torch.Tensor, generator: torch.Generator) -> HostBatch:
    """One training step's candidate rays: `num_rays × candidate_rays_factor`
    (pool entry, pixel) pairs drawn uniformly by `generator`, with their rgba
    gathered from `pixel_rgba` (B, H·W, 4) uint8 (rgb·mask, mask), as the JAX
    `DataLoader` draws a TRAINING batch. The draws happen on the generator's
    device; the batch lies on `pixel_rgba`'s."""
    num_pool, num_pixels, _ = pixel_rgba.shape
    n = cfg.num_rays * cfg.candidate_rays_factor
    buffer_idx = torch.randint(0, num_pool, (n,), generator=generator, device=generator.device)
    pixel_idx = torch.randint(0, num_pixels, (n,), generator=generator, device=generator.device)
    buffer_idx = buffer_idx.to(pixel_rgba.device, torch.int32)
    pixel_idx = pixel_idx.to(pixel_rgba.device, torch.int32)
    rgba = pixel_rgba[buffer_idx.long(), pixel_idx.long()].float() / 255.0
    light_ok = torch.ones(n, dtype=torch.bool, device=pixel_rgba.device)
    return HostBatch(buffer_idx, pixel_idx, rgba, light_ok)


class ViewInputs(NamedTuple):
    """What the test loader holds for one image: the pool, the dilated
    occupancy grids it points into, the normalized scene AABB, the landscape
    resolution and the pool entry of the image."""

    pool: PoolArrays
    grids: torch.Tensor  # (G, res, res, res) bool
    aabb: torch.Tensor   # (2, 3) float32
    width: int
    height: int
    buffer_index: int = 0


def render_pipeline_config(pcfg: PipelineConfig, batch_size: int) -> PipelineConfig:
    """`pcfg` for render batches of `batch_size` rays: the dense budgets,
    which `pcfg` sizes for its `num_rays` training rays, keep their share per
    ray (the sample density is the scene's), 128-aligned, so a render batch
    truncates a ray no more often than a training batch does."""

    def scale(budget: int) -> int:
        per_ray = max(budget // max(pcfg.num_rays, 1), 1)
        return max(128, ((per_ray * batch_size + 127) // 128) * 128)

    return dataclasses.replace(pcfg, num_rays=batch_size, candidate_budget=scale(pcfg.candidate_budget),
                               sample_budget=scale(pcfg.sample_budget))


def render_image(model: HumanRFModel, pcfg: PipelineConfig, inputs: ViewInputs, rays_batch_size: int) -> torch.Tensor:
    """Render pool entry `inputs.buffer_index` on a black background →
    (H, W, 3) float32 colors.

    Pixels go in batches of `rays_batch_size`; the last batch is padded with
    pixel 0 and its padding is dropped, as the test loader does. `pcfg`'s
    dense budgets are scaled to the batch (`render_pipeline_config`).
    """
    device = inputs.aabb.device
    width, height = inputs.width, inputs.height
    if not bool(inputs.pool.landscape[inputs.buffer_index]):
        width, height = height, width  # portrait image
    num_pixels = width * height
    render_fn = make_render_fn(render_pipeline_config(pcfg, rays_batch_size), model, inputs.width, inputs.height)

    buffer_idx = torch.full((rays_batch_size,), inputs.buffer_index, dtype=torch.int32, device=device)
    rgba = torch.zeros((rays_batch_size, 4), dtype=torch.float32, device=device)
    light_ok = torch.ones(rays_batch_size, dtype=torch.bool, device=device)
    colors = []
    for start in range(0, num_pixels, rays_batch_size):
        num_real = min(rays_batch_size, num_pixels - start)
        pixel_idx = torch.zeros(rays_batch_size, dtype=torch.int32, device=device)
        pixel_idx[:num_real] = torch.arange(start, start + num_real, dtype=torch.int32, device=device)
        batch = HostBatch(buffer_idx, pixel_idx, rgba, light_ok)
        out, _ = render_fn(batch, inputs.pool, inputs.grids, inputs.aabb, 0.0)
        colors.append(out.color[:num_real])
    return torch.cat(colors).reshape(height, width, 3)


def _to_u8(colors: np.ndarray, width: int, height: int) -> np.ndarray:
    """(H·W, 3) float colors → (H, W, 3) uint8, as the JAX trainer writes them."""
    return (np.clip(colors.reshape(height, width, 3), 0, 1) * 255).astype(np.uint8)


class Trainer:
    """The JAX package's `Trainer` over the port's step, render and loader.

    `optimizer` builds the optimizer from the model's named parameters (for
    instance `functools.partial(make_optimizer, lr=..., ...)`); None makes a
    render-only trainer for the test phase. The model's parameters are drawn
    afresh from `seed` (on the CPU, then copied), then `checkpoint` is
    resolved ("latest", "best" or a path) and restored with its optimizer
    state, step, validation count and stats.

    `group`, a process group of several ranks, makes this rank's trainer
    one of a data-parallel run, table-sharded under `--tpu.param_sharding
    fsdp` (the JAX trainer's mesh); every rank builds its trainer with the
    same arguments, and only rank 0's `train` gets loaders.
    """

    def __init__(
        self,
        config,  # the parsed run args (humanrf_tpu/configs/args.py)
        workspace: Path,
        checkpoint: Optional[str],
        model: HumanRFModel,
        pipeline_config: PipelineConfig,
        optimizer: Optional[Callable[[Iterable], AdamW]],
        resolution,
        seed: int = 123,
        group=None,
    ) -> None:
        self.config = config
        self.workspace = Path(workspace)
        self.model = model
        self.pcfg = pipeline_config
        self.resolution = resolution
        width, height = resolution
        device = model.frame_to_segment.device

        self.group = group if group is not None and dist.get_world_size(group) > 1 else None
        self.is_writer = self.group is None or dist.get_rank(self.group) == 0
        model.init_parameters(torch.Generator().manual_seed(seed))
        self.sharding = None
        if self.group is not None and optimizer is not None and config.tpu.param_sharding == "fsdp":
            self.sharding = fsdp.TableSharding(model, self.group)
            fsdp.place_params(model, self.sharding)
        self.optimizer = optimizer(model.named_parameters()) if optimizer is not None else None
        self.rng = make_key(seed + 1, device)
        self.train_step_fn = None
        if self.optimizer is not None:
            if self.sharding is not None:
                self._log_info(f"FSDP training over {self.sharding.size} ranks: the tables of segments "
                               f"{self.sharding.segments} (and their Adam moments) sharded on the table axis, "
                               "rays data-parallel")
                self.train_step_fn = fsdp.make_fsdp_train_step(self.pcfg, model, self.optimizer, width, height,
                                                               self.sharding)
            elif self.group is not None:
                self._log_info(f"data-parallel training over {dist.get_world_size(self.group)} ranks")
                self.train_step_fn = make_sharded_train_step(self.pcfg, model, self.optimizer, width, height,
                                                             self.group)
            else:
                self.train_step_fn = make_train_step(self.pcfg, model, self.optimizer, width, height)
        # Validation and test loaders have their own ray batch sizes; a render
        # function per batch size, with the budgets scaled to it.
        self._render_fns: Dict[int, Callable] = {}

        self.lpips = LpipsModel.load_or_init()
        if not self.lpips.is_pretrained:
            self._log_warning(
                "No pretrained LPIPS weights found (set HUMANRF_TPU_LPIPS_WEIGHTS to a "
                "converted lpips_alex.npz). The random-feature perceptual proxy is reported "
                f"as '{self.lpips.metric_name}' — NOT comparable to reference lpips — and "
                "best-checkpoint selection falls back to PSNR."
            )

        self.step = 0
        self.val_step = 0
        self.stats = {
            "lpips_vals": [],
            "psnr_vals": [],
            "ssim_vals": [],
            "checkpoints": [],
            "best_lpips": float("inf"),
            "best_psnr": 0.0,
            "best_ssim": 0.0,
        }
        # Throughput of the train loop over its 20-step windows after step 20
        # (pauses for validation and saves excluded): see `train`.
        self.run_stats: Dict[str, float] = {}
        self.writer: Optional[SummaryWriter] = None

        self.checkpoints_dir = self.workspace / "checkpoints"
        if self.is_writer:
            self.checkpoints_dir.mkdir(parents=True, exist_ok=True)
        self.best_checkpoint_path = self.checkpoints_dir / f"best{CHECKPOINT_SUFFIX}"

        n_params = sum(p.numel() for p in model.parameters())
        self._log_info(f"# parameters: {n_params / 1e6:.3f} million")
        self.load(checkpoint)

    def _get_render_fn(self, batch_size: int):
        if batch_size not in self._render_fns:
            width, height = self.resolution
            pcfg = render_pipeline_config(self.pcfg, batch_size)
            self._render_fns[batch_size] = make_render_fn(pcfg, self.model, width, height)
        return self._render_fns[batch_size]

    def _log_info(self, text: str) -> None:
        if self.is_writer:
            print(f"[INFO] {text}", flush=True)

    def _log_warning(self, text: str) -> None:
        if self.is_writer:
            print(f"[WARNING] {text}", flush=True)

    def _full_state(self):
        """Under FSDP, every rank gathers the full tables and moments for the
        body (a checkpoint, a validation, a load); else nothing to do."""
        if self.sharding is None:
            return contextlib.nullcontext()
        return fsdp.full_state(self.model, self.optimizer, self.sharding)

    # ------------------------------------------------------------------ train

    def train(self, training_data_loader, validation_data_loader, max_steps: int) -> None:
        """Train to `max_steps`. In a multi-rank run only rank 0 passes loaders
        (the others pass None) and writes."""
        self._log_info("no HBM preflight: it is a TPU workaround the port does not carry")
        if self.group is not None:
            training_data_loader = Feed(training_data_loader, self.group, self.model.frame_to_segment.device)
        self.writer = SummaryWriter(self.workspace / "run") if self.is_writer else None
        loss_ema = 0.0
        first_loss = None
        aabb = training_data_loader.device_aabb
        loader_iter = iter(training_data_loader)
        save_every = self.config.training.save_checkpoint_every_n_steps
        validate_every = self.config.validation.every_n_steps

        window_start = time.time()
        start_step = last_log = self.step
        start_pairs = training_data_loader.pair_load_index
        start_launches = dict(fli.launches)
        # Supervised rays (valid and budgeted, the ones the loss sees), summed
        # on the device between logs so that no step waits for the device.
        supervised_accum = torch.zeros((), dtype=torch.int64, device=aabb.device)
        fetch_accum = 0.0  # host batch assembly (loader fetch under data_lock)
        pause_accum = 0.0  # validation and checkpoint pauses
        totals = {"steps": 0, "seconds": 0.0, "fetch_seconds": 0.0, "wall_seconds": 0.0, "supervised": 0}
        # --tpu.profile_dir: one trace per run, of the five steps from the
        # first step >= 20 (the JAX trainer's window at K = 1).
        profile_dir = self.config.tpu.profile_dir if self.is_writer else None
        tracer, trace_stop_at = None, 0

        while self.step < max_steps + 1:
            self.step += 1
            if profile_dir is not None:
                if tracer is None and 20 <= self.step < 27:
                    tracer = Trace(profile_dir, cuda=aabb.device.type == "cuda")
                    tracer.start()
                    trace_stop_at = self.step + 5
                elif tracer is not None and self.step >= trace_stop_at:
                    self._log_info(f"profiler trace written to {tracer.stop()}")
                    tracer, profile_dir = None, None
            self.rng, step_rng = split(self.rng)
            span = torch.profiler.record_function(f"train_step {self.step}") if tracer else contextlib.nullcontext()
            with span:
                t_fetch = time.perf_counter()
                batch, pool, grids, _ = next(loader_iter)
                fetch_accum += time.perf_counter() - t_fetch
                loss, aux = self.train_step_fn(batch, pool, grids, aabb, step_rng)
            supervised_accum += aux["num_rays_supervised"]
            if first_loss is None:
                first_loss = float(loss)

            if self.is_writer and (self.step % 20 == 0 or self.step <= 1):
                step_loss = float(loss)
                loss_ema = 0.95 * loss_ema + 0.05 * step_loss
                elapsed = time.time() - window_start
                train_elapsed = max(elapsed - pause_accum, 1e-9)
                steps = self.step - last_log
                supervised = int(supervised_accum)
                self.writer.add_scalar("photometric/training", float(aux["photometric"]), self.step)
                self.writer.add_scalar("psnr/training", -10 * np.log10(max(float(aux["mse"]), 1e-12)), self.step)
                if "mask_loss" in aux:
                    self.writer.add_scalar("mask_loss/training", float(aux["mask_loss"]), self.step)
                if elapsed > 0:
                    rays = self.pcfg.num_rays * steps
                    self.writer.add_scalar("throughput/rays_per_sec", rays / train_elapsed, self.step)
                    self.writer.add_scalar("throughput/rays_per_sec_wall", rays / elapsed, self.step)
                    self.writer.add_scalar("throughput/supervised_rays_per_sec", supervised / train_elapsed, self.step)
                    self.writer.add_scalar("throughput/steps_per_sec", steps / train_elapsed, self.step)
                    self.writer.add_scalar("throughput/host_fetch_fraction", fetch_accum / elapsed, self.step)
                if last_log >= 20:
                    totals["steps"] += steps
                    totals["seconds"] += train_elapsed
                    totals["fetch_seconds"] += fetch_accum
                    totals["wall_seconds"] += elapsed
                    totals["supervised"] += supervised
                if self.step % 500 == 0:
                    self._log_info(
                        f"step {self.step}: loss={step_loss:.5f} ema={loss_ema:.5f} "
                        f"samples={int(aux['num_samples'])} "
                        f"rays/s={self.pcfg.num_rays * steps / train_elapsed:.0f} "
                        f"supervised_rays/s={supervised / train_elapsed:.0f}"
                        f" [fetch {100 * fetch_accum / max(elapsed, 1e-9):.0f}% device+dispatch "
                        f"{100 * (elapsed - pause_accum - fetch_accum) / max(elapsed, 1e-9):.0f}%"
                        + (f" val/ckpt {pause_accum:.0f}s" if pause_accum > 0 else "")
                        + f"] skipped_nonfinite={int(self.optimizer.skipped)}"
                    )
                    if int(self.optimizer.skipped) > 0:
                        self.writer.add_scalar("stability/skipped_nonfinite_updates", int(self.optimizer.skipped),
                                               self.step)
                supervised_accum.zero_()
                window_start = time.time()
                last_log = self.step
                fetch_accum = 0.0
                pause_accum = 0.0

            if self.step % save_every == 0 or self.step % validate_every == 0:
                t_pause = time.perf_counter()
                training_data_loader.pause_replacing()
                with self._full_state():
                    if self.is_writer:
                        if self.step % save_every == 0:
                            self.save(best=False)
                        if self.step % validate_every == 0:
                            self.validate(validation_data_loader)
                            self.save(best=True)
                if self.group is not None:
                    dist.barrier(self.group)
                training_data_loader.continue_replacing()
                pause_accum += time.perf_counter() - t_pause

        if tracer is not None:
            self._log_info(f"profiler trace written to {tracer.stop()}")
        if self.writer is not None:
            self.writer.close()
            self.writer = None

        # Pool images the loader replaced per step: how fast the data cycles.
        replaced = (training_data_loader.pair_load_index - start_pairs) / max(self.step - start_step, 1)
        # The field kernels' launches over this loop, every rank's.
        launches = torch.tensor([fli.launches[d] - start_launches[d] for d in ("fwd", "bwd")], device=aabb.device)
        if self.group is not None:
            all_reduce_(launches, self.group)
        self.run_stats = {"start_step": start_step, "end_step": self.step, "first_loss": first_loss,
                          "field_interp_launches": dict(zip(("fwd", "bwd"), launches.tolist())),
                          "skipped_nonfinite": int(self.optimizer.skipped), "images_replaced_per_step": replaced}
        if totals["steps"]:
            s = totals["seconds"]
            self.run_stats.update({
                "steps": totals["steps"],
                "ms_per_step": 1e3 * s / totals["steps"],
                "rays_per_s": self.pcfg.num_rays * totals["steps"] / s,
                "supervised_rays_per_s": totals["supervised"] / s,
                "fetch_share": totals["fetch_seconds"] / s,
            })
            self._log_info(
                f"train: {totals['steps']} steps timed (20-step windows after step 20, pauses excluded): "
                f"{self.run_stats['ms_per_step']:.2f} ms per step, {self.run_stats['rays_per_s']:.0f} rays/s, "
                f"{self.run_stats['supervised_rays_per_s']:.0f} supervised rays/s, "
                f"host fetch {100 * self.run_stats['fetch_share']:.1f}% of the train time, "
                f"{replaced:.2f} pool images replaced per step"
            )

    # --------------------------------------------------------------- validate

    def _render_images(self, data_loader):
        """Render the loader's images in order → yields (colors (H·W, 3),
        rgba (H·W, 4), info) as numpy, one per full image."""
        aabb = data_loader.device_aabb
        partial_colors: List[torch.Tensor] = []
        partial_rgba: List[torch.Tensor] = []
        for data_idx, (batch, pool, grids, info) in enumerate(data_loader):
            out, _ = self._get_render_fn(batch.pixel_idx.shape[0])(batch, pool, grids, aabb, 0.0)
            partial_colors.append(out.color[: info.num_real])
            partial_rgba.append(batch.rgba[: info.num_real])
            if (data_idx + 1) % data_loader.num_batches_per_full_image != 0:
                continue
            colors, rgba = torch.cat(partial_colors).cpu().numpy(), torch.cat(partial_rgba).cpu().numpy()
            partial_colors, partial_rgba = [], []
            yield colors, rgba, info

    def validate(self, data_loader) -> None:
        self._log_info(f"===== Validation at step {self.step} =====")
        total_loss: Dict[str, float] = {}
        metric_counts: Dict[str, int] = {}
        path_validation = self.workspace / "validation"
        path_validation.mkdir(exist_ok=True)
        log_path = self.workspace / "validation.txt"
        with open(log_path, "a") as f:
            f.write(f"Step: {self.step}\n")

        val_img_step = 0
        for colors, rgba, info in self._render_images(data_loader):
            losses_info, comparison = self._evaluate_one_image(colors, rgba, info.width, info.height, 0.0)
            val_img_step += 1
            for k, v in losses_info.items():
                if not np.isfinite(v):
                    self._log_warning(
                        f"validation metric '{k}' is non-finite for image {val_img_step}; excluded from averages"
                    )
                    continue
                total_loss[k] = total_loss.get(k, 0.0) + v
                metric_counts[k] = metric_counts.get(k, 0) + 1

            tag = f"step_{self.step:04d}_{val_img_step:04d}"
            image_io.imwrite(path_validation / f"{tag}_rgb.png", _to_u8(colors, info.width, info.height)[..., ::-1])
            comp = (np.clip(comparison, 0, 1) * 255).astype(np.uint8)
            image_io.imwrite(path_validation / f"{tag}_comparison.png", comp[..., ::-1])
            if self.writer is not None:
                self.writer.add_image(f"comp_{val_img_step:04d}", comp, self.step)
            desc = " ".join(f"{k}={v:.4f}" for k, v in losses_info.items() if k not in ("mask_loss", "photometric"))
            with open(log_path, "a") as f:
                f.write(f"image_id: {val_img_step} --- {desc}\n")

        for k in total_loss:
            total_loss[k] /= max(metric_counts.get(k, 0), 1)
        self.stats["lpips_vals"].append(total_loss.get("lpips", float("inf")))
        self.stats["psnr_vals"].append(total_loss.get("psnr", 0.0))
        self.stats["ssim_vals"].append(total_loss.get("ssim", 0.0))
        if self.writer is not None:
            for k, v in total_loss.items():
                self.writer.add_scalar(f"{k}/validation", v, self.step)
        self._log_info("validation: " + " ".join(f"{k}={v:.4f}" for k, v in total_loss.items()))
        self.val_step += 1

    def _evaluate_one_image(self, colors, rgba, width, height, background_rgb):
        """ROI-cropped PSNR, SSIM and (pretrained only) LPIPS of one image."""
        gt_rgb = rgba[:, 0:3] * rgba[:, 3:4] + background_rgb * (1 - rgba[:, 3:4])
        pred_img = colors.reshape(height, width, 3)
        gt_img = gt_rgb.reshape(height, width, 3)
        x, y, w, h = bounding_rect(rgba[:, 3].reshape(height, width) > 0)
        if w == 0 or h == 0:
            x, y, w, h = 0, 0, width, height
        pred_roi = pred_img[y : y + h, x : x + w]
        gt_roi = gt_img[y : y + h, x : x + w]
        losses_info = {
            "psnr": compute_psnr(pred_roi, gt_roi),
            "ssim": compute_ssim(pred_roi, gt_roi, data_range=1.0),
        }
        if self.lpips.is_pretrained:
            losses_info[self.lpips.metric_name] = self.lpips(pred_roi, gt_roi)
        return losses_info, np.concatenate([pred_roi, gt_roi], axis=1)

    # ------------------------------------------------------------------- test

    def test(self, data_loader, save_path: Path, render_video: bool = False) -> None:
        """Render the loader's render sequence into `save_path`, one PNG per
        image named after its ground-truth file; with `render_video`, named
        %06d.png in order and encoded by ffmpeg into
        `video_<save_path.stem>.mp4` beside `save_path` (when ffmpeg is
        missing, a warning, and the frames stay on disk)."""
        self._log_info(f"===== Test → {save_path} =====")
        save_path = Path(save_path)
        save_path.mkdir(exist_ok=True, parents=True)
        for test_img_step, (colors, _, info) in enumerate(self._render_images(data_loader)):
            if render_video:
                filename = f"{test_img_step:06d}"
            else:
                camera_number, frame_number = data_loader.render_sequence[test_img_step]
                camera_name = data_loader.cameras[camera_number].name
                filename = data_loader.dataset.filepaths.get_rgb_path(camera_name, frame_number).stem
            image_io.imwrite(save_path / f"{filename}.png", _to_u8(colors, info.width, info.height)[..., ::-1])
        if render_video:
            try:
                subprocess.run(
                    ["ffmpeg", "-r", "25", "-i", str(save_path / "%06d.png"),
                     "-filter_complex", "pad=ceil(iw/2)*2:ceil(ih/2)*2",
                     "-loglevel", "error", "-c:v", "libx264", "-crf", "14",
                     "-profile:v", "baseline", "-level", "3.0",
                     "-pix_fmt", "yuv420p", "-movflags", "faststart", "-y",
                     str(save_path.parent / f"video_{save_path.stem}.mp4")],
                    check=False,
                )
            except FileNotFoundError:
                self._log_warning("ffmpeg not found; skipping video encode (frames are on disk)")

    # ------------------------------------------------------------- checkpoint

    def _write_checkpoint(self, path: Path) -> None:
        opt_state = opt_state_to_jax(self.optimizer) if self.optimizer is not None else None
        save_checkpoint(path, export_params(self.model), opt_state, self.step, self.val_step, self.stats)

    def save(self, best: bool) -> None:
        """A rolling step checkpoint (the oldest beyond MAX_NUM_CHECKPOINTS
        deleted), or, after a validation, best.ckpt when that validation is
        the best so far: by LPIPS, by PSNR without pretrained LPIPS weights."""
        if not best:
            filepath = self.checkpoints_dir / f"step_{self.step:08d}{CHECKPOINT_SUFFIX}"
            self.stats["checkpoints"].append(str(filepath))
            if len(self.stats["checkpoints"]) > MAX_NUM_CHECKPOINTS:
                oldest = Path(self.stats["checkpoints"].pop(0))
                if oldest.exists():
                    oldest.unlink()
            self._write_checkpoint(filepath)
        elif len(self.stats["psnr_vals"]) > 0:
            self.stats["best_lpips"] = min(self.stats["best_lpips"], self.stats["lpips_vals"][-1])
            self.stats["best_psnr"] = max(self.stats["best_psnr"], self.stats["psnr_vals"][-1])
            self.stats["best_ssim"] = max(self.stats["best_ssim"], self.stats["ssim_vals"][-1])
            lpips_part = f"lpips={self.stats['lpips_vals'][-1]:.4f} " if self.lpips.is_pretrained else ""
            self._log_info(
                f"step {self.step}: {lpips_part}"
                f"psnr={self.stats['psnr_vals'][-1]:.2f} ssim={self.stats['ssim_vals'][-1]:.4f} | "
                f"best: psnr={self.stats['best_psnr']:.2f} ssim={self.stats['best_ssim']:.4f}"
            )
            if self.lpips.is_pretrained:
                is_best = self.stats["lpips_vals"][-1] == self.stats["best_lpips"]
                gate = "LPIPS"
            else:
                is_best = self.stats["psnr_vals"][-1] == self.stats["best_psnr"]
                gate = "PSNR (no pretrained LPIPS weights)"
            if is_best:
                self._log_info(f"validation {gate} improved on the previous best -> writing best checkpoint")
                self._write_checkpoint(self.best_checkpoint_path)

    def load(self, checkpoint: Optional[str]) -> None:
        if checkpoint is None:
            self._log_warning("no checkpoint requested (pass --training.checkpoint to resume)")
            return
        path = resolve_checkpoint(self.checkpoints_dir, checkpoint)
        if path is None:
            self._log_warning(
                f"checkpoint '{checkpoint}' matched nothing under {self.checkpoints_dir}; starting from random init"
            )
            return
        self._log_info(f"restoring checkpoint {path}")
        params, opt_state, step, val_step, stats = load_checkpoint(path)
        with self._full_state():  # FSDP: each rank takes its shards of the loaded tables and moments
            self.model.load_state_dict(convert_params(params))
            if self.optimizer is not None and opt_state is not None:
                load_opt_state(self.optimizer, opt_state)
        self.step = step
        self.val_step = val_step
        self.stats = stats
        self._log_info(f"restored model + optimizer + stats; resuming from step {self.step}")
