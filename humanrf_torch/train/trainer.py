"""Training and rendering around the pipeline.

Counterpart of parts of `humanrf_tpu/train/trainer.py`:

- `make_lr_schedule` and `make_optimizer`: the JAX package's optax
  `apply_if_finite(adamw(...), max_consecutive_errors=10**9)`, as `AdamW`, a
  small class in plain torch ops;
- `sample_batch`: one training step's `HostBatch`, drawn from a pool of
  images as the JAX `DataLoader` draws it in TRAINING mode (uniform pool
  entries and pixels, their rgba gathered), by an explicit `torch.Generator`;
- `render_image`: the batched pixel loop of `Trainer.test` over one image.

The `Trainer` loop, the loader's pool, checkpoint writing and the CLI are not
ported yet.
"""
from __future__ import annotations

from typing import Iterable, NamedTuple

import torch

from humanrf_torch.models.humanrf import HumanRFModel
from humanrf_torch.train.pipeline import HostBatch, PipelineConfig, PoolArrays, make_render_fn


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

    where t counts only applied updates. A step whose gradients hold any
    inf or NaN changes nothing (parameters, moments, t) and adds one to
    `skipped`; it never gives up and applies one (the JAX package's
    `make_optimizer` says why). The choice is made on the device with
    `torch.where`, so a step never waits for the device. Parameters without
    a gradient take a zero one, as optax does with a zero cotangent.
    `torch.optim`'s fused Adam is not used: its state and skip semantics
    differ from optax's. b1, b2 and eps are the reference's (run.py:101).
    """

    b1, b2, eps = 0.9, 0.99, 1e-15

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float, lr_decay: float, max_steps: int, weight_decay: float):
        self.params = list(params)
        self.schedule = make_lr_schedule(lr, lr_decay, max_steps)
        self.weight_decay = weight_decay
        device = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int64, device=device)    # applied updates
        self.skipped = torch.zeros((), dtype=torch.int64, device=device)  # non-finite steps skipped
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
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


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float, lr_decay: float, max_steps: int, weight_decay: float = 0.0) -> AdamW:
    """Adam(β = 0.9/0.99, eps = 1e-15) with decoupled weight decay, the
    lr · decay^(step/max_steps) schedule and non-finite-update skipping:
    `humanrf_tpu/train/trainer.py::make_optimizer` over `params`."""
    return AdamW(params, lr, lr_decay, max_steps, weight_decay)


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


def render_image(model: HumanRFModel, pcfg: PipelineConfig, inputs: ViewInputs, rays_batch_size: int) -> torch.Tensor:
    """Render pool entry `inputs.buffer_index` on a black background →
    (H, W, 3) float32 colors.

    Pixels go in batches of `rays_batch_size`; the last batch is padded with
    pixel 0 and its padding is dropped, as the test loader does.
    """
    device = inputs.aabb.device
    width, height = inputs.width, inputs.height
    if not bool(inputs.pool.landscape[inputs.buffer_index]):
        width, height = height, width  # portrait image
    num_pixels = width * height
    render_fn = make_render_fn(pcfg, model, inputs.width, inputs.height)

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
