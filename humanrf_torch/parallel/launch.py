"""Run a function on N ranks, one process each.

The JAX package drives its devices from one controller; the port runs one
process per rank (`parallel/mesh.py` says why). `launch` spawns the ranks
with the `spawn` start method (nothing is inherited: a worker imports what
it needs, so a parent that imported JAX passes none of it on), meets them
through a rendezvous file in a fresh temporary directory (no fixed port, so
concurrent launches cannot collide), and returns rank 0's result. A rank
that raises makes `launch` raise after the other ranks are stopped; a rank
that stops entering collectives fails the others after the group's timeout
(`mesh.DEFAULT_TIMEOUT`).
"""
from __future__ import annotations

import os
import tempfile
from pathlib import Path
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from humanrf_torch.ops.cuda_build import load_library
from humanrf_torch.parallel.mesh import make_group, rank_device


def _worker(rank: int, fn: Callable, args: tuple, num_ranks: int, device_type: str, allow_shared_device: bool,
            init_method: str, result_path: str, threads: int) -> None:
    torch.set_num_threads(threads)
    group, device = make_group(num_ranks, device_type, init_method, rank, allow_shared_device)
    result = fn(group, device, *args)
    if rank == 0:
        torch.save(result, result_path)
    dist.destroy_process_group()


def launch(fn: Callable, num_ranks: int, *args, device_type: str = "cuda", allow_shared_device: bool = False,
           threads: Optional[int] = None) -> Any:
    """`fn(group, device, *args)` on `num_ranks` spawned ranks → rank 0's
    return value (picklable; `fn` is a module-level function).

    `device_type` "cuda" gives rank r `cuda:r` over NCCL (`cuda:0` for every
    rank over gloo with `allow_shared_device`), "cpu" the CPU over gloo.
    Asking for more GPUs than are visible raises here, before any rank
    starts. The CUDA kernels are built once here, before the ranks load
    them. `threads` is each rank's intra-op thread count (default: this
    process's share of its threads)."""
    for rank in range(num_ranks):
        rank_device(rank, num_ranks, device_type, allow_shared_device)
    if device_type == "cuda":
        load_library("field_interp")
    threads = threads or max(1, torch.get_num_threads() // num_ranks)
    with tempfile.TemporaryDirectory(prefix="humanrf_ranks_") as tmp:
        init_method = Path(os.path.join(tmp, "rendezvous")).as_uri()
        result_path = os.path.join(tmp, "rank0_result.pt")
        mp.start_processes(
            _worker,
            args=(fn, args, num_ranks, device_type, allow_shared_device, init_method, result_path, threads),
            nprocs=num_ranks,
            join=True,
            start_method="spawn",
        )
        return torch.load(result_path, weights_only=False)
