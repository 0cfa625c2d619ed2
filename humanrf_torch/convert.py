"""JAX params pytree → the port's parameters.

The JAX package keeps its parameters in a pytree of arrays (restored from a
checkpoint as numpy); `HumanRFModel` holds the same arrays, in the same
layouts, under matching names:

    segments[s].{xyz,xyt,yzt,xzt}  (L, F, T)    → segments.<s>.<name>
    segments[s].vectors            (4, D, R)    → segments.<s>.vectors
    sigma_net.w<i>, color_net.w<i> (din, dout)  → sigma_net.w<i>, color_net.w<i>
    proposal[s].factors            (4, res, rank) → proposal.<s>.factors
    camera_embeddings              (160, E)     → camera_embeddings

`model.load_state_dict(convert_params(params))` loads them; its strict
key check is what shows that every leaf was mapped.
"""
from __future__ import annotations

from typing import Any, Dict

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
