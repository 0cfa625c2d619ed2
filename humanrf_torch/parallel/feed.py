"""Rank 0's training loader, broadcast to every rank.

Rank 0 alone owns the training `DataLoader` (its pool, replacer thread and
seeded draws); a multi-rank `Trainer` iterates a `Feed` instead, which
yields what the loader yields, `(HostBatch, PoolArrays, grids, info)`, on
every rank. Each step rank 0 broadcasts the GLOBAL batch in one int32
buffer (the rgba's float32 bits included) with a flag that says whether the
pool changed since the last step; only then the pool's metadata and the
device grid ring follow. The loader hands the pool out as a snapshot taken
under its `data_lock`, cached per pool version, and uploads grids only
inside its own `__next__`, so a new snapshot object is exactly a changed
pool and grid ring. With the same seed, every rank of a run then sees the
batches that a single process would draw.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from humanrf_torch.parallel.collectives import broadcast_, broadcast_object
from humanrf_torch.train.pipeline import HostBatch, PoolArrays

_POOL_FLOATS = (("inverse_krs", 9), ("camera_origins", 3))
_POOL_INTS = ("landscape", "frame_numbers", "camera_numbers", "grid_slots")


class Feed:
    """Iterate the training batches of rank 0's `loader` on every rank of
    `group` (the other ranks pass None). Every rank builds its feed at the
    same point of the run, and steps it in lockstep."""

    def __init__(self, loader, group, device: torch.device):
        self.loader, self.group, self.device = loader, group, device
        self.is_source = dist.get_rank(group) == 0
        meta = None
        if self.is_source:
            meta = {"num_rays": loader.batch_size, "num_pool": loader.buffer_size,
                    "grids": tuple(loader.device_grids.shape), "aabb": loader.aabb.tolist()}
        meta = broadcast_object(meta, group)
        self.num_rays, self.num_pool = meta["num_rays"], meta["num_pool"]
        self.device_aabb = torch.tensor(meta["aabb"], dtype=torch.float32, device=device)
        self.grids = loader.device_grids if self.is_source else torch.zeros(meta["grids"], dtype=torch.bool,
                                                                               device=device)
        self._pool = None
        self._iter = None

    @property
    def pair_load_index(self) -> int:
        """Images the loader has loaded (0 off rank 0)."""
        return self.loader.pair_load_index if self.is_source else 0

    def pause_replacing(self) -> None:
        if self.is_source:
            self.loader.pause_replacing()

    def continue_replacing(self) -> None:
        if self.is_source:
            self.loader.continue_replacing()

    def __iter__(self):
        if self.is_source:
            self._iter = iter(self.loader)
        return self

    def __next__(self):
        R = self.num_rays
        buffer = torch.empty(1 + 7 * R, dtype=torch.int32, device=self.device)
        if self.is_source:
            batch, pool, grids, info = next(self._iter)
            changed = pool is not self._pool
            buffer[0] = int(changed)
            buffer[1:] = torch.cat([batch.buffer_idx.int(), batch.pixel_idx.int(),
                                    batch.rgba.contiguous().view(torch.int32).reshape(-1), batch.ray_light_ok.int()])
        broadcast_(buffer, self.group)
        if self.is_source:
            if changed:
                broadcast_(self._pack_pool(pool), self.group)
                broadcast_(grids.view(torch.uint8), self.group)
                self._pool = pool
            return batch, pool, grids, info
        buffer_idx, pixel_idx, rgba, light_ok = torch.split(buffer[1:], [R, R, 4 * R, R])
        batch = HostBatch(buffer_idx, pixel_idx, rgba.view(torch.float32).reshape(R, 4), light_ok.bool())
        if bool(buffer[0]):
            packed = broadcast_(torch.empty(self.num_pool * 16, dtype=torch.int32, device=self.device), self.group)
            broadcast_(self.grids.view(torch.uint8), self.group)
            self._pool = self._unpack_pool(packed)
        return batch, self._pool, self.grids, None

    def _pack_pool(self, pool: PoolArrays) -> torch.Tensor:
        floats = [getattr(pool, name).contiguous().view(torch.int32).reshape(-1) for name, _ in _POOL_FLOATS]
        return torch.cat(floats + [getattr(pool, name).int() for name in _POOL_INTS])

    def _unpack_pool(self, packed: torch.Tensor) -> PoolArrays:
        B = self.num_pool
        parts = torch.split(packed, [B * n for _, n in _POOL_FLOATS] + [B] * len(_POOL_INTS))
        inverse_krs = parts[0].view(torch.float32).reshape(B, 3, 3)
        camera_origins = parts[1].view(torch.float32).reshape(B, 3)
        landscape, frame_numbers, camera_numbers, grid_slots = parts[2:]
        return PoolArrays(inverse_krs, camera_origins, landscape.bool(), frame_numbers, camera_numbers, grid_slots)
