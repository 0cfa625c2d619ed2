"""The port's collectives, in one place.

Every communication of the multi-GPU path goes through these functions: a
sum or a minimum over the ranks (`all_reduce_`), a broadcast from rank 0
(`broadcast_`, `broadcast_object`), an all-gather (`all_gather`) and a
reduce-scatter (`reduce_scatter`). Every rank enters each of them in the same
order; none of them waits on the host unless its caller reads the result.

On an NCCL group they are the NCCL calls on the tensors' own device. On a
gloo group a CUDA tensor is copied to host memory, communicated there and
copied back. Gloo documents CUDA tensors for broadcast and all-reduce only,
and NCCL refuses two ranks on one GPU, so this copy is how ranks that share
a card talk (the one-card harness of `chip_smoke.py`). An NCCL group never
takes it, and a CPU tensor on a gloo group needs no copy.
"""
from __future__ import annotations

from typing import Any

import torch
import torch.distributed as dist


def _through_host(tensor: torch.Tensor, group) -> bool:
    return tensor.is_cuda and dist.get_backend(group) == dist.Backend.GLOO


def all_reduce_(tensor: torch.Tensor, group, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce `tensor` over the ranks in place (a sum by default) → `tensor`."""
    if _through_host(tensor, group):
        host = tensor.cpu()
        dist.all_reduce(host, op=op, group=group)
        tensor.copy_(host)
    else:
        dist.all_reduce(tensor, op=op, group=group)
    return tensor


def all_true(flag: torch.Tensor, group) -> torch.Tensor:
    """A bool scalar → whether it is True on every rank (a MIN over the ranks)."""
    return all_reduce_(flag.to(torch.int32), group, op=dist.ReduceOp.MIN).bool()


def broadcast_(tensor: torch.Tensor, group) -> torch.Tensor:
    """Overwrite `tensor` with rank 0's, in place → `tensor`."""
    if _through_host(tensor, group):
        host = tensor.cpu()
        dist.broadcast(host, src=0, group=group)
        tensor.copy_(host)
    else:
        dist.broadcast(tensor, src=0, group=group)
    return tensor


def broadcast_object(obj: Any, group) -> Any:
    """Rank 0's picklable `obj` on every rank (the others pass anything)."""
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=group)
    return box[0]


def all_gather(tensor: torch.Tensor, group) -> torch.Tensor:
    """Every rank's `tensor` → (D, *tensor.shape), rank d's at [d]."""
    size = dist.get_world_size(group)
    staged = _through_host(tensor, group)
    local = tensor.cpu() if staged else tensor.contiguous()
    out = torch.empty(size * tensor.numel(), dtype=tensor.dtype, device=local.device)
    dist.all_gather_into_tensor(out, local.reshape(-1), group=group)  # flat: gloo takes no stacked output
    out = out.view(size, *tensor.shape)
    return out.to(tensor.device) if staged else out


def reduce_scatter(tensor: torch.Tensor, group) -> torch.Tensor:
    """(D, *shape) on every rank → this rank's row of their sum, (*shape)."""
    staged = _through_host(tensor, group)
    full = tensor.cpu() if staged else tensor.contiguous()
    out = torch.empty(full.shape[1:], dtype=full.dtype, device=full.device)
    dist.reduce_scatter_tensor(out.view(-1), full.view(-1), group=group)
    return out.to(tensor.device) if staged else out
