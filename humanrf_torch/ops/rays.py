"""Ray generation and AABB intersection.

Counterpart of `humanrf_tpu/ops/rays.py` (the pixel→ray and slab-test part
of the reference's CUDA ray sampler, `ray_sampler.cu:11-26,96-147`).
"""
from __future__ import annotations

import torch


def pixel_to_ray(inverse_krs, camera_origins, image_number, pixel_x, pixel_y):
    """→ (origins (R,3), normalized directions (R,3)).

    dir = normalize(inv(KR) @ (x, y, 1)) — ray_sampler.cu:116-119.
    """
    inv_kr = inverse_krs[image_number]  # (R, 3, 3)
    dirs = inv_kr[:, :, 0] * pixel_x[:, None] + inv_kr[:, :, 1] * pixel_y[:, None] + inv_kr[:, :, 2]
    dirs = dirs / torch.sqrt((dirs * dirs).sum(dim=-1, keepdim=True))
    origins = camera_origins[image_number]
    return origins, dirs


def aabb_intersect(origins, dirs, aabb):
    """Slab test (ray_sampler.cu:11-26). aabb: (2, 3). → (tmin (R,), tmax (R,)).

    A ray misses iff tmin >= tmax (the reference's ray_mask, ray_sampler.cu:146).
    """
    inv_d = 1.0 / dirs
    t0 = (aabb[0][None] - origins) * inv_d
    t1 = (aabb[1][None] - origins) * inv_d
    tmin = torch.minimum(t0, t1).amax(dim=-1)
    tmax = torch.maximum(t0, t1).amin(dim=-1)
    return tmin, tmax
