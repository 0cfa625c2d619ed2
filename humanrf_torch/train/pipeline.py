"""The pipeline: pixels → rays → samples → field → composite → loss.

Counterpart of `humanrf_tpu/train/pipeline.py`, with both of its samplers
(`PipelineConfig.sampling`): `build_rays`, `compact_rays`, and then

- "dense", the reference's pipeline: a lattice of candidates every
  `render_step_size` along the ray, the occupancy filter, a compacted flat
  buffer of `candidate_budget` slots (`build_samples`), the visibility prune
  into `sample_budget` slots and the render over the flat buffer
  (`prune_and_render`); rays whose samples overflow a budget are left out of
  the loss;
- "proposal": a cheap CP proposal field shapes a per-ray PDF and the field is
  queried on a static (R, K) lattice (`proposal_render`);

then `training_loss`, `make_train_step` and `make_render_fn`.

A training step keys all its noise by global ray id (`utils/rngs.py`), as the
JAX step does: the dense jitter (by ray id and lattice slot), the proposal's
stratified offsets and the random background, so a ray draws the same noise
wherever compaction moves it, and the same as the JAX package's step under
the same key. A render has no noise, so it is deterministic.

Both are one device program, as the JAX package's jitted step and render
are: static shapes throughout (the dense passes query every slot of their
budgets), no host read inside, and on the card each is captured once as a
CUDA graph and replayed (`train/graphs.py`). The CPU runs the same
functions eagerly; `graph=False` runs them eagerly on the card too.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

import torch

from humanrf_torch.models.humanrf import HumanRFModel
from humanrf_torch.ops import field_interp as fli
from humanrf_torch.ops.occupancy import coarsen_grid, occupancy_ray_minmax, sample_occupancy
from humanrf_torch.ops.rays import aabb_intersect, pixel_to_ray
from humanrf_torch.ops.render import RenderOutput, composite_grid, prune_samples, render, render_weights_grid
from humanrf_torch.ops.resample import proposal_distillation_per_ray, sample_intervals, stratified_bins, weights_to_cdf
from humanrf_torch.ops.sampling import SampleSet, generate_samples
from humanrf_torch.train.graphs import GraphedStep, timed
from humanrf_torch.train.losses import bce_loss, huber_loss, masked_mean
from humanrf_torch.utils import profiling
from humanrf_torch.utils.rngs import split, uniform_per_id


@dataclass(frozen=True)
class PipelineConfig:
    """Sampling and loss settings, with the JAX package's names and defaults.
    A render's batch size is the batch's own length; a training step takes
    `num_rays × candidate_rays_factor` candidate rays and supervises
    `num_rays`."""

    num_rays: int = 8192
    # --- dense sampling -------------------------------------------------------
    # Candidate lattice points per ray (the longest kept span / step).
    samples_per_ray: int = 1024
    # Slots after the occupancy filter (they feed the no-grad prune pass).
    candidate_budget: int = 1 << 20
    # Slots after the visibility prune (they feed the differentiable render);
    # the reference's training.samples_max_batch_size.
    sample_budget: int = 640_000
    render_step_size: float = 4e-4
    use_visibility_prune: bool = True
    # "dense" (the reference's sampler) or "proposal".
    sampling: str = "dense"
    bce_loss_weight: Optional[float] = 1e-3
    huber_delta: float = 0.01
    # tmin/tmax march on a conservatively max-pooled grid (factor× coarser).
    march_grid_factor: int = 2
    proposal_samples_per_ray: int = 64
    render_samples_per_ray: int = 32
    # Second proposal level (0 = single level).
    proposal_mid_samples_per_ray: int = 0
    proposal_loss_weight: float = 1.0
    # Exploration floor of the resampling CDF.
    proposal_uniform_bonus: float = 5e-2
    # The host ships factor × num_rays candidate pixels; after the occupancy
    # march the hull-hitting ones are compacted into the num_rays render
    # slots (training only).
    candidate_rays_factor: int = 1
    # The photometric loss: "huber" (huber_delta) or "mse".
    photometric: str = "huber"


class PoolArrays(NamedTuple):
    """Per-pool-entry camera/frame metadata (one entry per loaded image)."""

    inverse_krs: torch.Tensor     # (B, 3, 3) float32
    camera_origins: torch.Tensor  # (B, 3) float32
    landscape: torch.Tensor       # (B,) bool
    frame_numbers: torch.Tensor   # (B,) int
    camera_numbers: torch.Tensor  # (B,) int
    grid_slots: torch.Tensor      # (B,) int — slot into the grids pool


class HostBatch(NamedTuple):
    buffer_idx: torch.Tensor    # (R,) int — pool entry per ray
    pixel_idx: torch.Tensor     # (R,) int — flat pixel within the image
    rgba: torch.Tensor          # (R, 4) float32 in [0, 1] (zeros at test time)
    ray_light_ok: torch.Tensor  # (R,) bool — light-bloom filter (True = keep)


class RayData(NamedTuple):
    origins: torch.Tensor         # (R, 3)
    directions: torch.Tensor      # (R, 3)
    tmin: torch.Tensor            # (R,)
    tmax: torch.Tensor            # (R,)
    valid: torch.Tensor           # (R,)
    frame_numbers: torch.Tensor   # (R,)
    camera_numbers: torch.Tensor  # (R,)


def build_rays(cfg: PipelineConfig, batch: HostBatch, pool: PoolArrays, grids, aabb, width: int, height: int) -> RayData:
    """Pixels → rays, with [tmin, tmax] from the AABB narrowed by the occupancy march."""
    image_number = batch.buffer_idx.long()
    is_landscape = pool.landscape[image_number]
    w = torch.where(is_landscape, width, height)
    h = torch.where(is_landscape, height, width)
    pixel_idx = batch.pixel_idx.long()
    pixel_x = (pixel_idx % w).float() + 0.5
    pixel_y = ((pixel_idx // w) % h).float() + 0.5

    origins, dirs = pixel_to_ray(pool.inverse_krs, pool.camera_origins, image_number, pixel_x, pixel_y)
    tmin, tmax = aabb_intersect(origins, dirs, aabb)

    march_grids = coarsen_grid(grids, cfg.march_grid_factor)
    tmin, tmax = occupancy_ray_minmax(origins, dirs, tmin, tmax, march_grids, pool.grid_slots[image_number])

    valid = (tmin < tmax) & batch.ray_light_ok
    return RayData(
        origins=origins,
        directions=dirs,
        tmin=tmin,
        tmax=tmax,
        valid=valid,
        frame_numbers=pool.frame_numbers[image_number],
        camera_numbers=pool.camera_numbers[image_number],
    )


def compact_rays(rays: RayData, batch: HostBatch, ray_ids: torch.Tensor, num_out: int):
    """Compact hull-hitting candidate rays into `num_out` slots: valid rays
    first, in their original order (stable sort). `ray_ids` travel with their
    rays, so identity-keyed noise does not depend on the compaction."""
    order = torch.argsort((~rays.valid).int(), stable=True)[:num_out]
    rays = RayData(*(f[order] for f in rays))
    batch = HostBatch(*(f[order] for f in batch))
    return rays, batch, ray_ids[order]


def _slot_ids(ray_ids: torch.Tensor, num_slots: int) -> torch.Tensor:
    """(R,) ray ids → (R·num_slots,) ids `ray_id·num_slots + slot`."""
    slots = torch.arange(num_slots, dtype=torch.int64, device=ray_ids.device)
    return (ray_ids.long()[:, None] * num_slots + slots[None, :]).reshape(-1)


def build_samples(cfg: PipelineConfig, rays: RayData, pool: PoolArrays, grids, buffer_idx) -> SampleSet:
    """Dense sampling's candidates: each ray's lattice over [tmin, tmax],
    occupancy-filtered, compacted into `candidate_budget` slots."""
    return generate_samples(
        rays.tmin, rays.tmax, rays.valid, rays.origins, rays.directions,
        step_size=cfg.render_step_size, samples_per_ray=cfg.samples_per_ray, budget=cfg.candidate_budget,
        grids=grids, grid_ids=pool.grid_slots[buffer_idx.long()],
    )


def prune_and_render(
    cfg: PipelineConfig,
    model: HumanRFModel,
    rays: RayData,
    samples: SampleSet,
    background_rgb,
    rng: Optional[torch.Tensor] = None,
    ray_ids: Optional[torch.Tensor] = None,
    tables=None,
):
    """`prune_samples` + `render` (`volume_rendering.py:42-150`) on the flat
    buffers → (RenderOutput, the rendered SampleSet). `tables` is passed to
    every field query (`HumanRFModel.features`).

    With a key `rng` this is the training render: every sample distance is
    jittered by U[0, step) (`volume_rendering.py:63-64`), drawn per (global
    ray id, lattice slot), and camera embeddings are on. The prune pass's
    density query runs without autograd (JAX: `stop_gradient`), so no
    activation of its `candidate_budget` slots is kept. Both passes query
    every slot of their buffer; the field's kernels skip the slots past
    `num_valid`, which stays on the device.
    """
    num_rays = rays.origins.shape[0]
    if rng is not None:
        if ray_ids is None:
            ray_ids = torch.arange(num_rays, device=rays.origins.device)
        ray_idx = samples.ray.long().clamp(0, num_rays - 1)
        lattice = torch.round((samples.t - rays.tmin[ray_idx]) / cfg.render_step_size).long()
        u = uniform_per_id(rng, ray_ids.long()[ray_idx] * cfg.samples_per_ray + lattice)
        samples = samples._replace(t=samples.t + u * cfg.render_step_size)
    if cfg.use_visibility_prune:
        with torch.no_grad():
            samples = prune_samples(
                lambda p, f, n: model.density(p, f, tables, n)[0], samples, rays.origins, rays.directions, rays.frame_numbers,
                num_rays, cfg.sample_budget, cfg.render_step_size, cfg.samples_per_ray,
            )
    out = render(
        lambda p, d, f, c, n: model(p, d, f, c, is_training=rng is not None, tables=tables, n_valid=n),
        samples, rays.origins, rays.directions, rays.frame_numbers, rays.camera_numbers,
        num_rays, background_rgb, cfg.render_step_size, cfg.samples_per_ray,
    )
    return out, samples


def _per_sample(values: torch.Tensor, k: int) -> torch.Tensor:
    """(R, ...) per-ray values → (R·k, ...), each ray's repeated k times (a
    `repeat_interleave` whose size is static)."""
    return values[:, None].expand(values.shape[0], k, *values.shape[1:]).reshape(-1, *values.shape[1:])


def proposal_render(
    cfg: PipelineConfig,
    model: HumanRFModel,
    rays: RayData,
    pool: PoolArrays,
    grids,
    buffer_idx,
    background_rgb,
    rng: Optional[torch.Tensor] = None,
    ray_ids: Optional[torch.Tensor] = None,
    tables=None,
):
    """Importance-sampled rendering over a static (R, K) lattice.

    1. bins over [tmin, tmax] → proposal density → coarse weights (with
       `proposal_mid_samples_per_ray`, a second level resampled from them);
       `model.proposal_density` is asked each level's by its index (HumanRF's
       CP proposal is one field for both, K-Planes has one a level);
    2. inverse-CDF draw of `render_samples_per_ray` intervals, from the
       detached proposal weights (gradients reach the proposal only through
       the distillation loss);
    3. one field evaluation on the (R, K_f) lattice, per-row compositing.

    With a key `rng` this is the training render: stratified offsets keyed by
    `ray_ids` (default arange), camera embeddings on, and the per-ray
    distillation loss summed over the proposal levels in the aux. Without
    one it is the deterministic render. `tables` is passed to the field
    query (`HumanRFModel.features`). → (RenderOutput, aux).
    """
    num_rays = rays.origins.shape[0]
    k_coarse = cfg.proposal_samples_per_ray
    k_mid = cfg.proposal_mid_samples_per_ray
    k_fine = cfg.render_samples_per_ray
    is_training = rng is not None

    u_coarse = u_mid = u_fine = None
    if is_training:
        if ray_ids is None:
            ray_ids = torch.arange(num_rays, device=rays.origins.device)
        rng_c, rng_m, rng_f = split(rng, 3)
        u_coarse = uniform_per_id(rng_c, _slot_ids(ray_ids, k_coarse)).reshape(num_rays, k_coarse)
        if k_mid:
            u_mid = uniform_per_id(rng_m, _slot_ids(ray_ids, k_mid + 1)).reshape(num_rays, k_mid + 1)
        u_fine = uniform_per_id(rng_f, _slot_ids(ray_ids, k_fine + 1)).reshape(num_rays, k_fine + 1)

    grid_ids = pool.grid_slots[buffer_idx.long()]

    def proposal_weights(t, dt, level):
        """Proposal level `level`'s field on a (R, K) lattice → weights; zero
        outside the occupancy hull."""
        k = t.shape[1]
        pts = rays.origins[:, None, :] + rays.directions[:, None, :] * t[..., None]
        sigma = model.proposal_density(
            pts.reshape(-1, 3), _per_sample(rays.frame_numbers, k), level
        ).reshape(num_rays, k)
        mask = rays.valid[:, None] & sample_occupancy(grids, grid_ids[:, None], pts + 0.5)
        return render_weights_grid(sigma, dt, mask)

    t_c, dt_c, edges_c = stratified_bins(rays.tmin, rays.tmax, k_coarse, u_coarse)
    w_prop = proposal_weights(t_c, dt_c, 0)
    cdf = weights_to_cdf(w_prop.detach(), cfg.proposal_uniform_bonus)
    levels = [(edges_c, w_prop)]
    if k_mid:
        t_m, dt_m, edges_c = sample_intervals(edges_c, cdf, k_mid, u_mid, return_edges=True)
        w_mid = proposal_weights(t_m, dt_m, 1)
        cdf = weights_to_cdf(w_mid.detach(), cfg.proposal_uniform_bonus)
        levels.append((edges_c, w_mid))
    t_f, dt_f = sample_intervals(edges_c, cdf, k_fine, u_fine)

    pts_f = rays.origins[:, None, :] + rays.directions[:, None, :] * t_f[..., None]
    density, radiance = model(
        pts_f.reshape(-1, 3),
        _per_sample(rays.directions, k_fine),
        _per_sample(rays.frame_numbers, k_fine),
        _per_sample(rays.camera_numbers, k_fine),
        is_training=is_training,
        tables=tables,
    )
    density = density.reshape(num_rays, k_fine)
    radiance = radiance.reshape(num_rays, k_fine, 3)
    fine_mask = rays.valid[:, None].expand(num_rays, k_fine)
    w_fine = render_weights_grid(density, dt_f, fine_mask)
    out = composite_grid(w_fine, radiance, background_rgb)

    aux = {"num_samples": fine_mask.sum()}
    if is_training:
        aux["proposal_loss_per_ray"] = sum(
            proposal_distillation_per_ray(edges, weights, t_f - 0.5 * dt_f, t_f + 0.5 * dt_f, w_fine)
            for edges, weights in levels
        )
    return out, aux


def training_loss(
    cfg: PipelineConfig,
    model: HumanRFModel,
    rays: RayData,
    rgba: torch.Tensor,
    rng: torch.Tensor,
    pool: PoolArrays,
    grids,
    buffer_idx,
    ray_ids: Optional[torch.Tensor] = None,
    samples: Optional[SampleSet] = None,
    group=None,
    tables=None,
):
    """Random-background compositing, Huber (or MSE, `cfg.photometric`) +
    BCE (+ distillation under proposal sampling, + the model's
    `regularization()` where it has one: K-Planes' plane regularisers), each
    a mean over the supervised rays (trainer.py:
    229-248 of the reference): the valid rays, and under dense sampling only
    those whose samples fit the budgets (`samples` are `build_samples`'s).
    With a process `group` (`humanrf_torch/parallel`) each mean is over the
    rays of every rank (`masked_mean`), and `ray_ids` are this rank's rays'
    global ids; `tables` goes to the field queries (`HumanRFModel.features`;
    the FSDP step's gathered tables). → (loss, aux) with aux `photometric`,
    `mask_loss`, `proposal_loss` (proposal only), `mse`, and this rank's
    `num_samples` and `num_rays_supervised`."""
    if ray_ids is None:
        ray_ids = torch.arange(cfg.num_rays, device=rgba.device)
    rng_bg, rng_jitter = split(rng)
    gt_mask = rgba[:, 3:4]
    background = uniform_per_id(rng_bg, ray_ids, num=3)
    gt_rgb = rgba[:, 0:3] * gt_mask + background * (1.0 - gt_mask)

    if cfg.sampling == "proposal":
        out, proposal_aux = proposal_render(cfg, model, rays, pool, grids, buffer_idx, background, rng_jitter, ray_ids,
                                            tables)
        loss_mask = rays.valid
        num_samples = proposal_aux["num_samples"]
    else:
        out, pruned = prune_and_render(cfg, model, rays, samples, background, rng_jitter, ray_ids, tables)
        loss_mask = rays.valid & pruned.ray_included
        num_samples = pruned.num_valid

    if cfg.photometric == "mse":
        photometric = masked_mean((out.color - gt_rgb) ** 2, loss_mask, group)
    else:
        photometric = masked_mean(huber_loss(out.color, gt_rgb, cfg.huber_delta), loss_mask, group)
    total = photometric
    aux = {"photometric": photometric}
    if cfg.bce_loss_weight is not None:
        mask_l = masked_mean(bce_loss(out.weights_sum, gt_mask), loss_mask, group) * cfg.bce_loss_weight
        total = total + mask_l
        aux["mask_loss"] = mask_l
    if cfg.sampling == "proposal":
        prop_l = masked_mean(proposal_aux["proposal_loss_per_ray"][:, None], loss_mask, group)
        total = total + cfg.proposal_loss_weight * prop_l
        aux["proposal_loss"] = prop_l
    if hasattr(model, "regularization"):
        reg = model.regularization()
        total = total + reg
        aux["regularization"] = reg

    aux["mse"] = masked_mean((out.color - gt_rgb) ** 2, loss_mask, group)
    aux["num_samples"] = num_samples
    aux["num_rays_supervised"] = loss_mask.sum()
    return total, aux


def count_segments(model: HumanRFModel, rays: RayData) -> torch.Tensor:
    """The number of segments that the frames of the valid `rays` fall in
    (one int64 on the device, no host read)."""
    seg = model.frame_to_segment[rays.frame_numbers.long()]
    slot = torch.where(rays.valid & (seg >= 0), seg + 1, 0)  # 0: no segment
    hits = torch.zeros(model.config.num_segments + 1, device=slot.device)
    hits.index_add_(0, slot, torch.ones_like(slot, dtype=hits.dtype))
    return (hits[1:] > 0).sum()


def make_train_step(cfg: PipelineConfig, model: HumanRFModel, optimizer, width: int, height: int,
                    graph: bool = True):
    """Returns train_step(batch, pool, grids, aabb, rng, ray_ids=None) → (loss, aux).

    `batch` carries `num_rays × candidate_rays_factor` candidate rays; after
    the occupancy march the valid ones are compacted into the `num_rays`
    render slots. `ray_ids` are the candidates' ids, which key their noise
    (default 0, 1, ...; a block of a larger batch passes its global ids).
    The step computes the loss, back-propagates into the
    model's parameters and applies `optimizer` (`train/trainer.py::AdamW`).
    It updates the parameters and the optimizer's state in place: the
    PyTorch form of the JAX step's donated buffers. `loss` and `aux` are
    detached device tensors; nothing waits for the device.

    On the card the step is one CUDA graph (`train/graphs.py`): forward,
    backward and `optimizer.step()`, the gradients zeroed in place inside
    it, the field queries' backward adding the tables' straight into them
    (`ops/field_interp.py::grads_in_place`, opened around its
    `loss.backward()`); `loss` and `aux` are then its static outputs, which
    the next step overwrites. The first call of a
    batch shape is the eager body (the graph's warm-up); the graph replays
    from the second on. `graph=False` runs the eager body (the CPU always
    does).

    Each step adds on the device to the recorder's counters
    (`utils/profiling.py`): `sampler.candidate_rays_valid` (the valid
    candidates), `sampler.rays_valid` (the valid rays in the `num_rays`
    slots), `sampler.rays_overflowed` (valid rays left out of the loss, those
    whose samples overflow a dense budget), `sampler.samples`,
    `sampler.steps` and `train.segments_reached` (the segments that the
    frames of the valid rays in the `num_rays` slots fall in). On the card
    `optimizer.step()` is timed per replay as `train.optimizer_ms`
    (`graphs.timed`), under the call's id.
    """
    device = next(model.parameters()).device
    counters = {name: profiling.device_counter(f"sampler.{name}", device)
                for name in ("candidate_rays_valid", "rays_valid", "rays_overflowed", "samples", "steps")}
    segments_reached = profiling.device_counter("train.segments_reached", device)

    def step(batch: HostBatch, pool: PoolArrays, grids, aabb, rng: torch.Tensor, ray_ids=None):
        rays = build_rays(cfg, batch, pool, grids, aabb, width, height)
        counters["candidate_rays_valid"] += rays.valid.sum()
        if cfg.candidate_rays_factor > 1:
            if ray_ids is None:
                ray_ids = torch.arange(cfg.num_rays * cfg.candidate_rays_factor, device=rays.origins.device)
            rays, batch, ray_ids = compact_rays(rays, batch, ray_ids, cfg.num_rays)
        segments_reached.add_(count_segments(model, rays))
        samples = None
        if cfg.sampling != "proposal":
            samples = build_samples(cfg, rays, pool, grids, batch.buffer_idx)
        model.zero_grad(set_to_none=False)
        loss, aux = training_loss(
            cfg, model, rays, batch.rgba, rng, pool, grids, batch.buffer_idx, ray_ids=ray_ids, samples=samples
        )
        with fli.grads_in_place():
            loss.backward()
        with timed("train.optimizer_ms"):
            optimizer.step()
        rays_valid = rays.valid.sum()
        counters["rays_valid"] += rays_valid
        counters["rays_overflowed"] += rays_valid - aux["num_rays_supervised"]
        counters["samples"] += aux["num_samples"]
        counters["steps"] += 1
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    return GraphedStep("the train step", step) if graph else step


def make_render_fn(cfg: PipelineConfig, model: HumanRFModel, width: int, height: int, graph: bool = True):
    """Returns render_rays(batch, pool, grids, aabb, background_rgb) →
    (RenderOutput, ray_valid) for validation/test image assembly. Under
    dense sampling the budgets are the batch's (see
    `trainer.render_pipeline_config`). On the card it is one CUDA graph
    per batch size (`train/graphs.py`; a scalar `background_rgb` is part of
    the signature): its outputs are static, overwritten by the next batch,
    so a caller that keeps them copies them. `graph=False` runs it
    eagerly."""

    @torch.no_grad()
    def fn(batch: HostBatch, pool: PoolArrays, grids, aabb, background_rgb):
        rays = build_rays(cfg, batch, pool, grids, aabb, width, height)
        if cfg.sampling == "proposal":
            out, _ = proposal_render(cfg, model, rays, pool, grids, batch.buffer_idx, background_rgb)
        else:
            samples = build_samples(cfg, rays, pool, grids, batch.buffer_idx)
            out, _ = prune_and_render(cfg, model, rays, samples, background_rgb)
        valid = rays.valid[:, None]
        color = torch.where(valid, out.color, background_rgb)
        wsum = torch.where(valid, out.weights_sum, 0.0)
        return RenderOutput(color=color, weights_sum=wsum), rays.valid

    return GraphedStep("the render function", fn) if graph else fn
