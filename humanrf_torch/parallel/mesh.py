"""Data-parallel training over a `torch.distributed` process group.

Counterpart of `humanrf_tpu/parallel/mesh.py`. The JAX package runs one
program over a 1-D device mesh; the port runs one process per GPU (each
with its own launching thread, which a host-bound step needs), joined by a
process group (`make_group`). Every rank holds the whole model:

- it takes its contiguous block of the global candidate batch, keys all of
  its noise by the rays' global ids, compacts its own block into its
  `num_rays / D` slots and runs the unchanged pipeline at per-rank budgets
  (`shard_pipeline_config`), as each JAX shard does inside `shard_map`;
- the loss's means are over every rank's rays (`train/losses.py::masked_mean`);
- the gradients are summed over the ranks in one flat bucket, in
  `named_parameters()` order (the JAX `psum`; not DDP's mean, which the
  global normalisation would have to undo), the sample and ray counts too;
- then every rank applies the same optimizer update to the same sums, so
  the replicas stay equal bit for bit.

At `candidate_rays_factor` 1 the step is the single-device step's, up to
the order of the sums. At larger factors each rank compacts its own block,
so which rays fill the slots depends on the layout, as in JAX.
"""
from __future__ import annotations

import dataclasses
from datetime import timedelta
from typing import Dict, Iterable, Tuple

import torch
import torch.distributed as dist

from humanrf_torch.models.humanrf import HumanRFModel
from humanrf_torch.parallel.collectives import all_reduce_
from humanrf_torch.train.pipeline import (
    HostBatch,
    PipelineConfig,
    PoolArrays,
    build_rays,
    build_samples,
    compact_rays,
    training_loss,
)

# A rank that dies or stops entering collectives fails the run after this
# long instead of hanging it; long enough for rank 0's validation and
# checkpoint writes, which the other ranks wait for at a barrier.
DEFAULT_TIMEOUT = timedelta(minutes=30)


def rank_device(rank: int, num_devices: int, device_type: str, allow_shared_device: bool = False) -> torch.device:
    """The device of `rank` in a group of `num_devices`: `cuda:<rank>`, or
    `cuda:0` for every rank with `allow_shared_device`, or the CPU.

    Under-provisioning is an error, as in the JAX `make_mesh`: a run asked
    for N GPUs does not train on fewer, nor on the CPU."""
    if device_type == "cpu":
        return torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"unknown device type {device_type!r} (cuda or cpu)")
    available = torch.cuda.device_count()
    needed = 1 if allow_shared_device else num_devices
    if available < needed:
        raise RuntimeError(
            f"requested {num_devices} ranks on {needed} GPU(s) but only {available} CUDA device(s) are visible; "
            "refusing to under-provision"
        )
    return torch.device("cuda", 0 if allow_shared_device else rank)


def make_group(
    num_devices: int,
    device_type: str,
    init_method: str,
    rank: int,
    allow_shared_device: bool = False,
) -> Tuple[dist.ProcessGroup, torch.device]:
    """Join the group of `num_devices` ranks as `rank` → (group, device).

    NCCL on `cuda` (one GPU per rank, bound with `torch.cuda.set_device`
    before anything is allocated), gloo on `cpu`. `allow_shared_device`
    puts every rank on `cuda:0` over gloo, since NCCL refuses two ranks on
    one GPU: the one-card harness of the tests and `chip_smoke.py`, never a
    CLI flag. `init_method` is the rendezvous (`file://...` or
    `tcp://host:port`). The group times out after DEFAULT_TIMEOUT."""
    device = rank_device(rank, num_devices, device_type, allow_shared_device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = "nccl" if device.type == "cuda" and not allow_shared_device else "gloo"
    dist.init_process_group(backend, init_method=init_method, world_size=num_devices, rank=rank,
                            timeout=DEFAULT_TIMEOUT)
    return dist.group.WORLD, device


def shard_pipeline_config(cfg: PipelineConfig, num_devices: int) -> PipelineConfig:
    """Per-rank shapes: the rays and both sample budgets divided by the ranks."""
    for name in ("num_rays", "candidate_budget", "sample_budget"):
        if getattr(cfg, name) % num_devices:
            raise ValueError(f"{name} = {getattr(cfg, name)} does not divide over {num_devices} ranks")
    return dataclasses.replace(
        cfg,
        num_rays=cfg.num_rays // num_devices,
        candidate_budget=cfg.candidate_budget // num_devices,
        sample_budget=cfg.sample_budget // num_devices,
    )


def all_reduce_grads(params: Iterable[torch.nn.Parameter], group) -> None:
    """Sum the parameters' gradients over the ranks in one flat bucket, in
    the order given; a parameter without a gradient on this rank (its
    segment saw no sample here) adds zeros, so every rank's bucket has the
    same layout. Each `.grad` becomes a view of the summed bucket."""
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    bucket = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(bucket, group)
    offset = 0
    for p in params:
        p.grad = bucket[offset : offset + p.numel()].view_as(p)
        offset += p.numel()


def sum_counts(aux: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """`num_samples` and `num_rays_supervised` summed over the ranks (the
    losses in `aux` are already means over every rank's rays)."""
    counts = all_reduce_(torch.stack([aux["num_samples"].long(), aux["num_rays_supervised"].long()]), group)
    return {**aux, "num_samples": counts[0], "num_rays_supervised": counts[1]}


def make_sharded_train_step(cfg: PipelineConfig, model: HumanRFModel, optimizer, width: int, height: int, group):
    """Returns train_step(batch, pool, grids, aabb, rng) → (loss, aux) for
    this rank, where `batch` is the GLOBAL batch of `num_rays ×
    candidate_rays_factor` candidates (the same on every rank) and the rest
    is replicated. The loss and aux are the whole batch's; the update is
    applied in place, as `train/pipeline.py::make_train_step` does."""
    rank, size = dist.get_rank(group), dist.get_world_size(group)
    shard_cfg = shard_pipeline_config(cfg, size)
    num_candidates = shard_cfg.num_rays * shard_cfg.candidate_rays_factor
    params = [p for _, p in model.named_parameters()]

    def step(batch: HostBatch, pool: PoolArrays, grids, aabb, rng: torch.Tensor):
        # Rank r owns the candidates [r·R_c/D, (r+1)·R_c/D) and keys their
        # noise by those global ids, so every ray draws what it draws on one
        # device (mesh.py:111-113 of the JAX package).
        lo = rank * num_candidates
        block = HostBatch(*(f[lo : lo + num_candidates] for f in batch))
        ray_ids = lo + torch.arange(num_candidates, device=block.rgba.device)
        rays = build_rays(shard_cfg, block, pool, grids, aabb, width, height)
        if shard_cfg.candidate_rays_factor > 1:
            rays, block, ray_ids = compact_rays(rays, block, ray_ids, shard_cfg.num_rays)
        samples = None
        if shard_cfg.sampling != "proposal":
            samples = build_samples(shard_cfg, rays, pool, grids, block.buffer_idx)
        optimizer.zero_grad()
        loss, aux = training_loss(shard_cfg, model, rays, block.rgba, rng, pool, grids, block.buffer_idx,
                                  ray_ids=ray_ids, samples=samples, group=group)
        loss.backward()
        all_reduce_grads(params, group)
        aux = sum_counts(aux, group)
        optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    return step
