"""A K-Planes training step's least time on the chip: its MLPs (bfloat16),
both directions of its plane queries and Adam (float32), counted from the
reference's work log of one step.

The log holds, in order, each proposal level's plane query ("planes") and
its MLP ("proposal"), then the field's plane query, its density ("sigma")
and colour ("color") MLPs, then "valid_samples", the field's samples of the
valid rays. The MLPs' rows are each query's samples of the valid rays (the
valid rays' share of its samples); a layer of din → dout costs 2·din·dout
operations a row forward, three times that with a gradient. The plane
regularisers' passes over the planes are left out.
"""
from __future__ import annotations

from hrfbench.counts import adamw, kplanes_bwd, kplanes_fwd
from hrfbench.counts.peaks import least_time_mixed


def _per_row(dims) -> int:
    return sum(2 * a * b for a, b in zip(dims[:-1], dims[1:]))


def mlp_ops(log, model: dict) -> int:
    """→ operations of the MLPs over the queries of `log`; `model` is the
    reference's `KPlanesConfig` as a dict."""
    hidden = model["n_neurons"]
    sigma = [len(model["multiscales"]) * model["feature_dim"]] + [hidden] * model["n_hidden_layers_density"] \
        + [1 + model["geometry_feature_dim"]]
    color = [model["sh_degree"] ** 2 + model["geometry_feature_dim"]] + [hidden] * model["n_hidden_layers_color"] + [3]
    proposal = [model["proposal_feature_dim"], model["proposal_n_neurons"], 1]
    planes = [e for e in log if e["kind"] == "planes"]
    valid = next(e["n"] for e in log if e["kind"] == "valid_samples")
    share = valid / planes[-1]["n"] if planes[-1]["n"] else 0.0
    ops = 0
    for e, q in zip((e for e in log if e["kind"] in ("proposal", "sigma")), planes):
        dims = [proposal] if e["kind"] == "proposal" else [sigma, color]
        ops += q["n"] * share * sum(_per_row(d) for d in dims) * (3 if e["grad"] else 1)
    return int(ops)


def count(log, model: dict, num_params: int) -> dict:
    """→ {"ops": {precision: operations}, "bytes", "least_s", "binds"}."""
    fwd_ops, fwd_bytes = kplanes_fwd.count(log)
    bwd_ops, bwd_bytes = kplanes_bwd.count(log)
    opt_ops, opt_bytes = adamw.count(num_params)
    ops = {"bf16": mlp_ops(log, model), "fp32": fwd_ops + bwd_ops + opt_ops}
    nbytes = fwd_bytes + bwd_bytes + opt_bytes
    least, binds = least_time_mixed(ops, nbytes)
    return {"ops": ops, "bytes": nbytes, "least_s": least, "binds": binds}
