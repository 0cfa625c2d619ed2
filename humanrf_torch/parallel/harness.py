"""The multi-rank training step on inputs saved to a file: what the parity
tests (`tests/test_torch_parallel.py`, `tests/test_torch_fsdp.py`) and
`chip_smoke.py` launch on every rank.

`save_inputs` writes one `.npz`: the model's configuration and state, the
pipeline settings, the optimizer, the steps' batches and keys, the pool, the
grids and the AABB. `run_steps(group, device, path, out_dir, mode)` (the
function `launch` runs) loads it on each rank and takes the steps with the
data-parallel step (`mode` "dp"), the FSDP step ("fsdp") or, with no group,
the single-device step ("single"), then writes `rank<r>.npz` into `out_dir`:
the losses and counts of every step, this rank's parameters (under FSDP its
shards, and the gathered full ones), the step-0 gradients, the sharded
state's bytes, the kernels' launches, the time per step and the peak device
memory. Inputs and results go through files, so a worker imports nothing
of its parent.
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from humanrf_torch.models.humanrf import HumanRFConfig, HumanRFModel
from humanrf_torch.ops import field_interp as fli
from humanrf_torch.parallel import fsdp
from humanrf_torch.parallel.mesh import make_sharded_train_step
from humanrf_torch.train.pipeline import HostBatch, PipelineConfig, PoolArrays, make_train_step
from humanrf_torch.train.trainer import make_optimizer


# Steps left out of `ms_per_step`: the first calls build the kernels' launch
# state and the allocator's pools.
WARM_STEPS = 2


class SGD:
    """p ← p − lr·g, with the port's optimizer interface (`zero_grad`,
    `step`): `optax.sgd`, which the JAX package's parallel tests compare
    with, since Adam's first update moves every parameter by ±lr whatever its
    gradient's size. A parameter without a gradient stays."""

    def __init__(self, named_params, lr: float):
        self.names, self.params = map(list, zip(*named_params))
        self.lr = lr
        self.group = None  # no non-finite skip to agree on

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params:
            if p.grad is not None:
                p.sub_(self.lr * p.grad)


def save_inputs(path: Path, model_config: HumanRFConfig, state: Dict[str, torch.Tensor], pipeline_config: PipelineConfig,
                optimizer: dict, batches: Sequence[HostBatch], keys: Sequence[torch.Tensor], pool: PoolArrays, grids,
                aabb, width: int, height: int) -> None:
    """Write the inputs of `run_steps`. `optimizer` is {"kind": "sgd", "lr":
    ...} or {"kind": "adamw", and `make_optimizer`'s arguments}; step i takes
    `batches[i]` (global batches) and `keys[i]`."""
    spec = {"model": dataclasses.asdict(model_config), "pipeline": dataclasses.asdict(pipeline_config),
            "optimizer": optimizer, "width": width, "height": height, "steps": len(batches)}
    arrays = {f"param/{k}": v.detach().cpu().numpy() for k, v in state.items()}
    for field in HostBatch._fields:
        arrays[f"batch/{field}"] = np.stack([getattr(b, field).cpu().numpy() for b in batches])
    for field in PoolArrays._fields:
        arrays[f"pool/{field}"] = getattr(pool, field).cpu().numpy()
    arrays.update(keys=np.stack([k.cpu().numpy() for k in keys]), grids=grids.cpu().numpy(), aabb=aabb.cpu().numpy())
    np.savez(path, spec=np.array(json.dumps(spec)), **arrays)


def _model_config(d: dict) -> HumanRFConfig:
    return HumanRFConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in d.items()})


def _cpu(named: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy().copy() for k, v in named.items()}


def run_steps(group, device: torch.device, path, out_dir, mode: str) -> dict:
    """Take the saved steps on this rank (see the module docstring) and write
    `out_dir/rank<r>.npz` → the same results as a dict. `ms_per_step` is the
    host time of the steps after the first WARM_STEPS, each step ended by a
    synchronise on the card."""
    data = np.load(path)
    spec = json.loads(str(data["spec"]))
    rank = dist.get_rank(group) if group is not None else 0
    model = HumanRFModel(_model_config(spec["model"]), device=device)
    model.load_state_dict({k[len("param/"):]: torch.tensor(data[k]) for k in data.files if k.startswith("param/")})
    cfg = PipelineConfig(**spec["pipeline"])
    sharding: Optional[fsdp.TableSharding] = None
    if mode == "fsdp":
        sharding = fsdp.TableSharding(model, group)
        fsdp.place_params(model, sharding)
    opt_spec = dict(spec["optimizer"])
    kind = opt_spec.pop("kind")
    named = list(model.named_parameters())
    optimizer = SGD(named, **opt_spec) if kind == "sgd" else make_optimizer(named, **opt_spec)
    width, height = spec["width"], spec["height"]
    if mode == "dp":
        step = make_sharded_train_step(cfg, model, optimizer, width, height, group)
    elif mode == "fsdp":
        step = fsdp.make_fsdp_train_step(cfg, model, optimizer, width, height, sharding)
    elif mode == "single":
        step = make_train_step(cfg, model, optimizer, width, height)
    else:
        raise ValueError(f"unknown mode {mode!r} (dp, fsdp or single)")

    pool = PoolArrays(*(torch.tensor(data[f"pool/{f}"], device=device) for f in PoolArrays._fields))
    grids, aabb = torch.tensor(data["grids"], device=device), torch.tensor(data["aabb"], device=device)
    batches = {f: torch.tensor(data[f"batch/{f}"], device=device) for f in HostBatch._fields}
    keys = torch.tensor(data["keys"], device=device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    losses: List[torch.Tensor] = []
    auxs: Dict[str, List[torch.Tensor]] = {}
    grads0 = {}
    fli.reset_launches()
    start = None
    for i in range(spec["steps"]):
        if i == WARM_STEPS:
            start = time.perf_counter()
        batch = HostBatch(*(batches[f][i] for f in HostBatch._fields))
        loss, aux = step(batch, pool, grids, aabb, keys[i])
        if cuda:
            torch.cuda.synchronize(device)
        if i == 0:
            grads0 = {n: p.grad for n, p in model.named_parameters() if p.grad is not None}
            grads0 = _cpu(grads0)
        losses.append(loss)
        for k, v in aux.items():
            auxs.setdefault(k, []).append(v)
    timed = spec["steps"] - WARM_STEPS
    seconds = time.perf_counter() - start if start is not None else float("nan")
    result = {
        "rank": rank,
        "losses": torch.stack(losses).cpu().numpy(),
        **{f"aux/{k}": torch.stack(v).cpu().numpy() for k, v in auxs.items()},
        **{f"param/{k}": v for k, v in _cpu(dict(model.named_parameters())).items()},
        **{f"grad0/{k}": v for k, v in grads0.items()},
        "launches": np.array([fli.launches["fwd"], fli.launches["bwd"]]),
        "ms_per_step": np.array(1e3 * seconds / timed if timed > 0 else float("nan")),
        "peak_bytes": np.array(torch.cuda.max_memory_allocated(device) if cuda else 0),
        # The data-parallel step all-reduces every gradient in one bucket.
        "bucket_bytes": np.array(sum(p.numel() * 4 for p in model.parameters()) if mode == "dp" else 0),
    }
    if kind == "adamw":
        result["skipped"] = np.array(int(optimizer.skipped))
    if sharding is not None:
        table_names = sorted(sharding.names)
        params = dict(model.named_parameters())
        result["shard_bytes"] = np.array(sum(params[n].numel() * 4 for n in table_names))
        if kind == "adamw":
            index = {n: i for i, n in enumerate(optimizer.names)}
            result["moment_bytes"] = np.array(sum((optimizer.mu[index[n]].numel() + optimizer.nu[index[n]].numel()) * 4
                                                  for n in table_names))
        with fsdp.full_state(model, None, sharding):
            result.update({f"full/{k}": v for k, v in _cpu(dict(model.named_parameters())).items()})
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / f"rank{rank}.npz", **result)
    return result


def run_jobs(group, device: torch.device, jobs: Sequence[tuple]) -> None:
    """`run_steps(group, device, *job)` for each (path, out_dir, mode) job in
    turn: several runs for the price of one launch."""
    for job in jobs:
        run_steps(group, device, *job)


def load_results(out_dir, num_ranks: int) -> List[dict]:
    """Every rank's `run_steps` results, rank 0 first."""
    return [dict(np.load(Path(out_dir) / f"rank{r}.npz")) for r in range(num_ranks)]
