"""The render pipeline: pixels → rays → proposal samples → field → composite.

Counterpart of the validation/test half of `humanrf_tpu/train/pipeline.py`
(`build_rays`, `proposal_render`, `make_render_fn`), with `sampling =
"proposal"` and no training noise: coarse bins sit at their centres and the
inverse-CDF draw at interval midpoints, so a render is deterministic.
Training (the jittered draw, the losses, the step) arrives with the training
port; dense sampling is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from humanrf_torch.models.humanrf import HumanRFModel
from humanrf_torch.ops.occupancy import coarsen_grid, occupancy_ray_minmax, sample_occupancy
from humanrf_torch.ops.rays import aabb_intersect, pixel_to_ray
from humanrf_torch.ops.render import RenderOutput, composite_grid, render_weights_grid
from humanrf_torch.ops.resample import sample_intervals, stratified_bins, weights_to_cdf


@dataclass(frozen=True)
class PipelineConfig:
    """The render's sampling settings. The batch size is the batch's own
    length: nothing here depends on it."""

    # tmin/tmax march on a conservatively max-pooled grid (factor× coarser).
    march_grid_factor: int = 2
    proposal_samples_per_ray: int = 64
    render_samples_per_ray: int = 32
    # Second proposal level (0 = single level).
    proposal_mid_samples_per_ray: int = 0
    # Exploration floor of the resampling CDF.
    proposal_uniform_bonus: float = 5e-2


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


def proposal_render(
    cfg: PipelineConfig,
    model: HumanRFModel,
    rays: RayData,
    pool: PoolArrays,
    grids,
    buffer_idx,
    background_rgb,
) -> RenderOutput:
    """Importance-sampled rendering over a static (R, K) lattice.

    1. coarse bins over [tmin, tmax] → proposal density → coarse weights;
    2. inverse-CDF draw of `render_samples_per_ray` intervals (midpoints);
    3. one field evaluation on the (R, K_f) lattice, per-row compositing.
    """
    num_rays = rays.origins.shape[0]
    k_coarse = cfg.proposal_samples_per_ray
    k_mid = cfg.proposal_mid_samples_per_ray
    k_fine = cfg.render_samples_per_ray

    grid_ids = pool.grid_slots[buffer_idx.long()]

    def proposal_weights(t, dt):
        """The cheap proposal field on a (R, K) lattice → weights; zero
        outside the occupancy hull."""
        k = t.shape[1]
        pts = rays.origins[:, None, :] + rays.directions[:, None, :] * t[..., None]
        sigma = model.proposal_density(
            pts.reshape(-1, 3), rays.frame_numbers.repeat_interleave(k)
        ).reshape(num_rays, k)
        mask = rays.valid[:, None] & sample_occupancy(grids, grid_ids[:, None], pts + 0.5)
        return render_weights_grid(sigma, dt, mask)

    t_c, dt_c, edges_c = stratified_bins(rays.tmin, rays.tmax, k_coarse)
    cdf = weights_to_cdf(proposal_weights(t_c, dt_c), cfg.proposal_uniform_bonus)
    if k_mid:
        t_m, dt_m, edges_c = sample_intervals(edges_c, cdf, k_mid, return_edges=True)
        cdf = weights_to_cdf(proposal_weights(t_m, dt_m), cfg.proposal_uniform_bonus)
    t_f, dt_f = sample_intervals(edges_c, cdf, k_fine)

    pts_f = rays.origins[:, None, :] + rays.directions[:, None, :] * t_f[..., None]
    density, radiance = model(
        pts_f.reshape(-1, 3),
        rays.directions.repeat_interleave(k_fine, dim=0),
        rays.frame_numbers.repeat_interleave(k_fine),
        rays.camera_numbers.repeat_interleave(k_fine),
        is_training=False,
    )
    density = density.reshape(num_rays, k_fine)
    radiance = radiance.reshape(num_rays, k_fine, 3)
    fine_mask = rays.valid[:, None].expand(num_rays, k_fine)
    w_fine = render_weights_grid(density, dt_f, fine_mask)
    return composite_grid(w_fine, radiance, background_rgb)


def make_render_fn(cfg: PipelineConfig, model: HumanRFModel, width: int, height: int):
    """Returns render_rays(batch, pool, grids, aabb, background_rgb) →
    (RenderOutput, ray_valid) for validation/test image assembly, with
    proposal sampling."""

    @torch.no_grad()
    def fn(batch: HostBatch, pool: PoolArrays, grids, aabb, background_rgb):
        rays = build_rays(cfg, batch, pool, grids, aabb, width, height)
        out = proposal_render(cfg, model, rays, pool, grids, batch.buffer_idx, background_rgb)
        valid = rays.valid[:, None]
        color = torch.where(valid, out.color, torch.as_tensor(background_rgb, dtype=out.color.dtype, device=out.color.device))
        wsum = torch.where(valid, out.weights_sum, 0.0)
        return RenderOutput(color=color, weights_sum=wsum), rays.valid

    return fn
