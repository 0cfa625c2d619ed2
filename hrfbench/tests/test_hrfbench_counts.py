"""The work counts against hand counts at tiny shapes."""
import pytest
import torch

from hrfbench.counts import adamw, field_interp_bwd, field_interp_fwd, mlp, peaks, render_batch, train_step
from hrfbench.reference.fused_field import _log_call

MODEL = dict(n_levels=2, n_features_per_level=2, n_neurons=4, n_hidden_layers_density=1, geometry_feature_dim=3,
             sh_degree=2, camera_embedding_dim=1, n_hidden_layers_color=1)


def test_a_call_logs_its_served_samples_and_the_distinct_rows_they_touch():
    tables = torch.zeros((2, 3, 10), requires_grad=True)
    idx = torch.tensor([[[0, 1, 1], [1, 9, 12]], [[5, 5, 5], [5, 6, 7]]])  # (P=2, C=2, N=3); 12 is outside
    live = torch.tensor([True, False, True])
    log = []
    _log_call(log, "grid", idx, tables, live)
    # served samples 0 and 2: pair 0 rows {0, 1} (12 lies outside the table), pair 1 rows {5, 7}
    assert log == [{"kind": "grid", "n": 2, "P": 2, "C": 2, "F": 3, "T": 10, "rows": 4, "grad": True}]
    with torch.no_grad():
        _log_call(log, "vector", idx, tables, None)
    assert log[1]["n"] == 3 and log[1]["rows"] == 6 and log[1]["grad"] is False


def test_lookup_counts():
    call = {"kind": "grid", "n": 10, "P": 4, "C": 8, "F": 2, "T": 100, "rows": 30, "grad": True}
    ops, nbytes = field_interp_fwd.count([call, {"kind": "sigma", "grad": True}])
    assert ops == 2 * 10 * 4 * 8 * 2
    assert nbytes == 16 * 10 + 4 * 10 * 4 * 2 + 4 * 30 * 2
    assert field_interp_bwd.count([call]) == (ops, nbytes)
    assert field_interp_bwd.count([dict(call, grad=False)]) == (0, 0)


def test_mlp_counts_queries_and_their_valid_rows():
    sigma, color = mlp.layer_dims(MODEL)
    assert sigma == [4, 4, 4] and color == [4 + 3 + 1, 4, 3]
    grid = {"kind": "grid", "n": 5}
    log = [grid, grid, {"kind": "sigma", "grad": False},                      # a prune pass: 10 rows, density only
           grid, {"kind": "sigma", "grad": True}, {"kind": "color", "grad": True},  # a render pass: 5 rows
           {"kind": "valid_samples", "n": 2}]                                 # of which 2 valid
    per_sigma = 2 * (4 * 4 + 4 * 4)
    per_color = 2 * (8 * 4 + 4 * 3)
    assert mlp.count(log, MODEL) == 10 * per_sigma + 2 * (per_sigma + per_color) * 3


def test_step_and_render_least_times():
    log = [{"kind": "grid", "n": 10, "P": 4, "C": 8, "F": 2, "T": 100, "rows": 30, "grad": True},
           {"kind": "sigma", "grad": True}, {"kind": "color", "grad": True}]
    assert adamw.count(7) == (84, 196)
    w = train_step.count(log, MODEL, 7)
    fwd, bwd = field_interp_fwd.count(log), field_interp_bwd.count(log)
    assert w["ops"] == {"bf16": mlp.count(log, MODEL), "fp32": fwd[0] + bwd[0] + 84}
    assert w["bytes"] == fwd[1] + bwd[1] + 196 and w["binds"] == "bytes"
    assert w["least_s"] == pytest.approx(w["bytes"] / peaks.HBM_BYTES_PER_S)
    r = render_batch.count(log, MODEL)
    assert r["bytes"] == fwd[1] and r["ops"]["fp32"] == fwd[0]


def test_least_time_names_the_bound_that_binds():
    assert peaks.least_time(67e12, 1.0, "fp32") == (1.0, "ops")
    assert peaks.least_time(1.0, 3.35e12, "bf16") == (1.0, "bytes")
    assert peaks.least_time_mixed({"bf16": 989e12, "fp32": 67e12}, 0.0) == (2.0, "ops")
