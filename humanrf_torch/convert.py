"""The JAX package's parameter and optimizer trees ↔ the port's.

The JAX package keeps its parameters in a pytree of arrays (restored from a
checkpoint as numpy); `HumanRFModel` holds the same arrays, in the same
layouts, under matching names:

    segments[s].{xyz,xyt,yzt,xzt}  (L, F, T)    → segments.<s>.<name>
    segments[s].vectors            (4, D, R)    → segments.<s>.vectors
    sigma_net.w<i>, color_net.w<i> (din, dout)  → sigma_net.w<i>, color_net.w<i>
    proposal[s].factors            (4, res, rank) → proposal.<s>.factors
    camera_embeddings              (160, E)     → camera_embeddings

`model.load_state_dict(convert_params(params))` loads them; its strict
key check is what shows that every leaf was mapped. `export_params(model)` is
the inverse: the flax state dict, lists as dicts keyed "0", "1", ...

The optimizer state maps onto optax's `apply_if_finite(adamw | adam)` state
as flax serializes it (`opt_state_to_jax`, `load_opt_state`):

    notfinite_count, last_finite, total_notfinite      (int32, bool, int32)
    inner_state: {"0": {count, mu, nu},                 scale_by_adam
                  "1": {},                              add_decayed_weights (adamw only)
                  "1" | "2": {count}}                   scale_by_learning_rate
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch


def _as_list(node) -> list:
    """A pytree list, or the "0", "1", ... dict a flax state dict makes of it."""
    if isinstance(node, dict):
        return [node[str(i)] for i in range(len(node))]
    return list(node)


def convert_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """→ a `HumanRFModel` state dict of float32 CPU tensors (copies)."""
    flat: Dict[str, np.ndarray] = {}
    for s, seg in enumerate(_as_list(params["segments"])):
        for name, leaf in seg.items():
            flat[f"segments.{s}.{name}"] = leaf
    for net in ("sigma_net", "color_net"):
        for name, leaf in params[net].items():
            flat[f"{net}.{name}"] = leaf
    for s, prop in enumerate(_as_list(params.get("proposal", []))):
        flat[f"proposal.{s}.factors"] = prop["factors"]
    if "camera_embeddings" in params:
        flat["camera_embeddings"] = params["camera_embeddings"]
    return {k: torch.tensor(np.asarray(v, dtype=np.float32)) for k, v in flat.items()}


def _nest(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{"segments.0.xyz": leaf, ...} → {"segments": {"0": {"xyz": leaf}}, ...}."""
    tree: Dict[str, Any] = {}
    for name, leaf in flat.items():
        *path, last = name.split(".")
        node = tree
        for key in path:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def _to_numpy(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    return {k: v.detach().to("cpu", torch.float32).numpy().copy() for k, v in tensors.items()}


def export_params(model: torch.nn.Module) -> Dict[str, Any]:
    """→ the JAX params tree of float32 numpy arrays (copies), as the flax
    state dict: `convert_params`'s inverse."""
    return _nest(_to_numpy(dict(model.named_parameters())))


def _inner_keys(optimizer) -> List[str]:
    return ["0", "1", "2"] if optimizer.weight_decay else ["0", "1"]


def opt_state_to_jax(optimizer) -> Dict[str, Any]:
    """`train/trainer.py::AdamW` → the flax state dict of the JAX package's
    `make_optimizer` state (see the module docstring)."""
    count = np.asarray(int(optimizer.count), dtype=np.int32)
    adam = {
        "count": count,
        "mu": _nest(_to_numpy(dict(zip(optimizer.names, optimizer.mu)))),
        "nu": _nest(_to_numpy(dict(zip(optimizer.names, optimizer.nu)))),
    }
    keys = _inner_keys(optimizer)
    inner = {keys[0]: adam, keys[-1]: {"count": count.copy()}}
    if len(keys) == 3:
        inner["1"] = {}
    return {
        "notfinite_count": np.asarray(int(optimizer.notfinite_count), dtype=np.int32),
        "last_finite": np.asarray(bool(optimizer.last_finite), dtype=np.bool_),
        "total_notfinite": np.asarray(int(optimizer.skipped), dtype=np.int32),
        "inner_state": {k: inner[k] for k in keys},
    }


@torch.no_grad()
def load_opt_state(optimizer, tree: Dict[str, Any]) -> None:
    """Load a JAX optimizer-state tree (`load_checkpoint`'s second item)
    into `optimizer`, in place; `opt_state_to_jax`'s inverse. Raises when the
    tree is of the other optimizer kind (adam vs adamw) or misses a moment."""
    inner = tree["inner_state"]
    if sorted(inner) != _inner_keys(optimizer):
        raise ValueError(
            f"optimizer state has chained states {sorted(inner)}, expected {_inner_keys(optimizer)} "
            f"for weight decay {optimizer.weight_decay}"
        )
    adam = inner["0"]
    mu, nu = convert_params(adam["mu"]), convert_params(adam["nu"])
    missing = set(optimizer.names) ^ set(mu)
    if missing:
        raise ValueError(f"optimizer state does not match the parameters: {sorted(missing)}")
    for name, m, v in zip(optimizer.names, optimizer.mu, optimizer.nu):
        m.copy_(mu[name])
        v.copy_(nu[name])
    optimizer.count.fill_(int(adam["count"]))
    optimizer.skipped.fill_(int(tree["total_notfinite"]))
    optimizer.notfinite_count.fill_(int(tree["notfinite_count"]))
    optimizer.last_finite.fill_(bool(tree["last_finite"]))
