"""The MLPs' work, in bfloat16 operands with float32 accumulation.

A work log is read as queries: the lookup calls of every segment, then a
"sigma" entry (the density MLP ran), then a "color" entry when the colour
MLP ran too. A query's rows are the samples its lookups served, or, where
a "valid_samples" entry follows it (the proposal sampler's lattice), the
valid ones among them. Forward, a layer of din → dout costs 2·din·dout
operations a row; a query that took a gradient costs three times that
(the backward's products for the inputs and for the weights).
"""
from __future__ import annotations


def layer_dims(model: dict) -> tuple:
    """`model` holds the field's settings (`reference.humanrf.HumanRFConfig` as a dict)
    → (density MLP dims, colour MLP dims)."""
    hidden = model["n_neurons"]
    sigma = [model["n_levels"] * model["n_features_per_level"]] + [hidden] * model["n_hidden_layers_density"] \
        + [1 + model["geometry_feature_dim"]]
    color = [model["sh_degree"] ** 2 + model["geometry_feature_dim"] + model["camera_embedding_dim"]] \
        + [hidden] * model["n_hidden_layers_color"] + [3]
    return sigma, color


def queries(log) -> list:
    """The log's queries: [{"rows", "sigma", "color", "grad"}]."""
    out, served = [], 0
    for e in log:
        kind = e["kind"]
        if kind == "grid":
            served += e["n"]
        elif kind == "sigma":
            out.append({"rows": served, "sigma": True, "color": False, "grad": e["grad"]})
            served = 0
        elif kind == "color":
            out[-1]["color"] = True
        elif kind == "valid_samples":
            out[-1]["rows"] = e["n"]
    return out


def count(log, model: dict) -> int:
    """→ operations of the MLPs over the queries of `log`."""
    sigma, color = layer_dims(model)
    per_row = lambda dims: sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))  # noqa: E731
    ops = 0
    for q in queries(log):
        fwd = per_row(sigma) + (per_row(color) if q["color"] else 0)
        ops += q["rows"] * fwd * (3 if q["grad"] else 1)
    return ops


PRECISION = "bf16"
