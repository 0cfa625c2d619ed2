"""Segment-table sharding (FSDP/ZeRO style) over a process group.

Counterpart of `humanrf_tpu/parallel/fsdp.py`. Each segment's four hash
tables `xyz`, `xyt`, `yzt`, `xzt`, of shape (L, F, T), are split on their
table axis T over the D ranks when D divides T (`TableSharding`, the rule of
the JAX `param_shardings`): rank r keeps the columns [r·T/D, (r+1)·T/D) of
each, and so do its Adam moments, which are built from the sharded
parameters (the JAX `opt_state_shardings`). Everything else (vectors, MLPs,
embeddings, proposal factors, tables D does not divide) is replicated and
its gradients are summed over the ranks as in data parallelism
(`mesh.all_reduce_grads`).

A step gathers every sharded segment's tables once (`gather_tables`: one
all-gather of the shards into the (4L, F, T) stacks the field's kernels
take, passed to the field queries as `tables`) and, in the backward,
reduce-scatters their gradient back to the shards (the sum over the ranks),
which is what XLA inserts around the JAX step's tables. `gather_columns` and
`scatter_columns` are the layout's one gather and its transpose; checkpoints
use the gather too. The optimizer's non-finite skip is agreed over the ranks,
since each rank holds only its shards' gradients.

The rays follow the JAX FSDP step, which is the single-device program:
every rank marches and compacts the WHOLE candidate batch as the
single-device step does, then takes its contiguous block of the `num_rays`
compacted slots with their global ids, and samples at budget / D. So the
step reproduces the single-device step wherever the sample budgets do not
bind (the regime of `tests/test_fsdp.py`, and of the paper's dense step,
where every valid ray fits); where they bind, each rank truncates its own
block.

`full_state` gives checkpoints, loads and renders the full tensors.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist

from humanrf_torch.models.decomposition4d import GRID_NAMES
from humanrf_torch.models.humanrf import HumanRFModel
from humanrf_torch.parallel.collectives import all_gather, reduce_scatter
from humanrf_torch.parallel.mesh import all_reduce_grads, shard_pipeline_config, sum_counts
from humanrf_torch.train.pipeline import (
    HostBatch,
    PipelineConfig,
    PoolArrays,
    build_rays,
    build_samples,
    compact_rays,
    training_loss,
)


def sharded_segments(model: HumanRFModel, num_ranks: int) -> List[int]:
    """The segments whose tables shard over `num_ranks`: those whose table
    size T it divides (the others stay replicated)."""
    return [s for s, cfg in enumerate(model.segment_grid_configs) if cfg.grid.table_size % num_ranks == 0]


class TableSharding:
    """Which segments of `model` have their tables sharded over `group`
    (`sharded_segments`), and this rank's block of them."""

    def __init__(self, model: HumanRFModel, group):
        self.group = group
        self.rank, self.size = dist.get_rank(group), dist.get_world_size(group)
        self.segments = sharded_segments(model, self.size)
        self.names = {f"segments.{s}.{name}" for s in self.segments for name in GRID_NAMES}

    def block(self, full: torch.Tensor) -> torch.Tensor:
        """This rank's columns of a full (..., T) tensor (a view)."""
        width = full.shape[-1] // self.size
        return full[..., self.rank * width : (self.rank + 1) * width]


def gather_columns(shards: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """Every rank's (..., w) shards → the full (..., D·w) tensors, rank r's
    columns at [r·w, (r+1)·w) (`TableSharding.block`): one all-gather."""
    if not shards:
        return []
    size = dist.get_world_size(group)
    gathered = all_gather(torch.cat([s.reshape(-1) for s in shards]), group)  # (D, n)
    fulls, offset = [], 0
    for s in shards:
        block = gathered[:, offset : offset + s.numel()].reshape(size, *s.shape)
        fulls.append(block.movedim(0, -2).reshape(*s.shape[:-1], size * s.shape[-1]))
        offset += s.numel()
    return fulls


def scatter_columns(fulls: Sequence[torch.Tensor], group) -> List[torch.Tensor]:
    """The transpose of `gather_columns`: every rank's full (..., D·w)
    tensors → this rank's columns of their sum over the ranks, (..., w): one
    reduce-scatter."""
    size = dist.get_world_size(group)
    shapes = [(*f.shape[:-1], f.shape[-1] // size) for f in fulls]
    pieces = [f.reshape(*shape[:-1], size, shape[-1]).movedim(-2, 0).reshape(size, -1)
              for f, shape in zip(fulls, shapes)]
    local = reduce_scatter(torch.cat(pieces, dim=1), group)  # (n,)
    shards, offset = [], 0
    for shape in shapes:
        n = math.prod(shape)
        shards.append(local[offset : offset + n].view(shape))
        offset += n
    return shards


@torch.no_grad()
def place_params(model: HumanRFModel, sharding: TableSharding) -> None:
    """Replace each sharded table of `model` (full, the same on every rank)
    by this rank's shard, in place. Build the optimizer after this, so that
    its moments have the shards' shapes."""
    for name, p in model.named_parameters():
        if name in sharding.names:
            p.data = sharding.block(p.data).clone()


class _GatherColumns(torch.autograd.Function):
    """`gather_columns` forward, `scatter_columns` (the sum over the ranks)
    backward."""

    @staticmethod
    def forward(ctx, group, *shards):
        ctx.group = group
        return tuple(gather_columns(shards, group))

    @staticmethod
    def backward(ctx, *grads):
        return (None, *scatter_columns(grads, ctx.group))


def gather_tables(model: HumanRFModel, sharding: TableSharding) -> Dict[int, torch.Tensor]:
    """Every sharded segment's (4L, F, T) table stack for one step, gathered
    from the ranks' shards in one all-gather → {segment: stack}, the
    `tables` of the field queries. Their gradients flow back to the shards
    through one reduce-scatter."""
    shards = [torch.cat([getattr(model.segments[s], name) for name in GRID_NAMES]) for s in sharding.segments]
    if not shards:
        return {}
    return dict(zip(sharding.segments, _GatherColumns.apply(sharding.group, *shards)))


@contextlib.contextmanager
def full_state(model: HumanRFModel, optimizer, sharding: TableSharding):
    """Every rank enters: the sharded tables (and, with an `optimizer`, their
    Adam moments) are gathered and put in place of the shards, full, for the
    body, which may read them (a checkpoint, a render) or overwrite them (a
    loaded checkpoint); on exit each rank takes its shards of the full
    tensors back."""
    params = dict(model.named_parameters())
    tables = [params[name] for name in sorted(sharding.names)]
    moments = []
    if optimizer is not None:
        index = {name: i for i, name in enumerate(optimizer.names)}
        moments = [(state, index[name]) for name in sorted(sharding.names) for state in (optimizer.mu, optimizer.nu)]
    with torch.no_grad():
        shards = [p.data for p in tables] + [state[i] for state, i in moments]
        fulls = gather_columns(shards, sharding.group)
        for p, full in zip(tables, fulls):
            p.data = full
        for (state, i), full in zip(moments, fulls[len(tables):]):
            state[i] = full
    try:
        yield
    finally:
        with torch.no_grad():
            for p, shard in zip(tables, shards):
                shard.copy_(sharding.block(p.data))
                p.data = shard
            for (state, i), shard in zip(moments, shards[len(tables):]):
                shard.copy_(sharding.block(state[i]))
                state[i] = shard


def make_fsdp_train_step(cfg: PipelineConfig, model: HumanRFModel, optimizer, width: int, height: int,
                         sharding: TableSharding):
    """Returns train_step(batch, pool, grids, aabb, rng) → (loss, aux) for
    this rank, with `batch` the GLOBAL candidate batch (the same on every
    rank). `model` is placed (`place_params`) and `optimizer` built from its
    sharded parameters; its non-finite skip is agreed over the group (an
    optimizer without one, like a plain SGD, ignores `group`)."""
    group = sharding.group
    shard_cfg = shard_pipeline_config(cfg, sharding.size)
    num_candidates = cfg.num_rays * cfg.candidate_rays_factor
    lo = sharding.rank * shard_cfg.num_rays
    replicated = [p for name, p in model.named_parameters() if name not in sharding.names]
    optimizer.group = group

    def step(batch: HostBatch, pool: PoolArrays, grids, aabb, rng: torch.Tensor):
        # The single-device program's rays: all candidates marched and
        # compacted, then this rank's block of the compacted slots.
        rays = build_rays(cfg, batch, pool, grids, aabb, width, height)
        ray_ids = torch.arange(num_candidates, device=batch.rgba.device)
        if cfg.candidate_rays_factor > 1:
            rays, batch, ray_ids = compact_rays(rays, batch, ray_ids, cfg.num_rays)
        hi = lo + shard_cfg.num_rays
        rays = type(rays)(*(f[lo:hi] for f in rays))
        batch = HostBatch(*(f[lo:hi] for f in batch))
        ray_ids = ray_ids[lo:hi]
        samples = None
        if cfg.sampling != "proposal":
            samples = build_samples(shard_cfg, rays, pool, grids, batch.buffer_idx)
        optimizer.zero_grad()
        tables = gather_tables(model, sharding)
        loss, aux = training_loss(shard_cfg, model, rays, batch.rgba, rng, pool, grids, batch.buffer_idx,
                                  ray_ids=ray_ids, samples=samples, group=group, tables=tables)
        # The stacks are roots too, with a zero gradient: every rank then runs
        # the reduce-scatter once, whichever segments its rays hit.
        stacks = list(tables.values())
        zeros = [torch.zeros((), device=s.device).expand_as(s) for s in stacks]
        torch.autograd.backward([loss, *stacks], [torch.ones_like(loss), *zeros])
        all_reduce_grads(replicated, group)
        aux = sum_counts(aux, group)
        optimizer.step()
        return loss.detach(), {k: v.detach() for k, v in aux.items()}

    return step
