"""Full-image rendering of a trained model.

Counterpart of the test-time part of `humanrf_tpu/train/trainer.py`: the
batched pixel loop of `Trainer.test` over one image of the pool. The sample
budgets that `Trainer._get_render_fn` scales to the render batch belong to
dense sampling, which is not ported. The trainer itself and its CLI arrive
with the training port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from humanrf_torch.models.humanrf import HumanRFModel
from humanrf_torch.train.pipeline import HostBatch, PipelineConfig, PoolArrays, make_render_fn


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
    light_ok = torch.ones(rays_batch_size, dtype=torch.bool, device=device)
    colors = []
    for start in range(0, num_pixels, rays_batch_size):
        num_real = min(rays_batch_size, num_pixels - start)
        pixel_idx = torch.zeros(rays_batch_size, dtype=torch.int32, device=device)
        pixel_idx[:num_real] = torch.arange(start, start + num_real, dtype=torch.int32, device=device)
        out, _ = render_fn(HostBatch(buffer_idx, pixel_idx, light_ok), inputs.pool, inputs.grids, inputs.aabb, 0.0)
        colors.append(out.color[:num_real])
    return torch.cat(colors).reshape(height, width, 3)
