"""The port's `field_interp` (humanrf_torch/ops/field_interp.py): the field's
lookups with their corner math, against the JAX package's corner functions
(humanrf_tpu/models/fused_field.py) followed by its oracle
`fused_interp_reference` (humanrf_tpu/ops/fused_interp.py), forward and
`jax.grad` backward.

On the CPU the wrapper runs the plain PyTorch versions; the CUDA kernels
(humanrf_torch/csrc/field_interp.cu) are checked against them by the
`cuda`-marked tests, on the card only.
"""
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanrf_torch.models.hash_encoding import HashGridConfig as THashGridConfig
from humanrf_torch.ops import field_interp as fli
from humanrf_tpu.models import fused_field as j_ff
from humanrf_tpu.ops.fused_interp import fused_interp_reference

torch.set_num_threads(2)

# Levels at resolutions 4, 8, 16, 32 against T = 2^13: three dense levels
# (no corner leaves the table), one hashed (tests/test_torch_field.py:33).
GRID = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=13, base_resolution=4, finest_resolution=32)
# Level 0 at res 8 against T = 2^9 < 8³ + 8² + 8: a dense level whose far
# corners leave the table (tests/test_torch_field.py:102).
OVERFLOW = dict(n_levels=2, n_features_per_level=2, log2_hashmap_size=9, base_resolution=8, finest_resolution=16)
# The r4 width: L8/F4 at T = 2^11, every level hashed.
R4 = dict(n_levels=8, n_features_per_level=4, log2_hashmap_size=11, base_resolution=16, finest_resolution=2048)
# The reference capacity: L16/F2 at T = 2^19; levels 0-3 dense, the rest hashed.
CAPACITY = dict(n_levels=16, n_features_per_level=2, log2_hashmap_size=19, base_resolution=32, finest_resolution=2048)


def _xyzt(n, seed=0, far=False):
    """Uniform samples in [0, 1]^4, the first 16 on the cube's corners and
    just outside it (clamped); with `far`, a quarter in the last cells."""
    x = np.random.default_rng(seed).uniform(0, 1, (n, 4)).astype(np.float32)
    x[:16] = np.array([[(c >> d) & 1 for d in range(4)] for c in range(16)], dtype=np.float32)
    x[8:12] += np.float32(0.25)
    x[12:16] -= np.float32(0.25)
    if far:
        x[16 : n // 4] = 0.95 + 0.05 * x[16 : n // 4]
    return x


def _tables(P, F, T, seed=1):
    return np.random.default_rng(seed).normal(size=(P, F, T)).astype(np.float32)


def _jax_grid_idx_w(xyzt, cfg: THashGridConfig):
    idx, w = [], []
    for _, axes in j_ff._GRID_AXES:
        i, ww = j_ff._grid_corner_idx_w(jnp.asarray(xyzt)[:, jnp.array(axes)], cfg.level_scales(),
                                        cfg.level_resolutions(), cfg.table_size)
        idx.append(i)
        w.append(ww)
    return np.asarray(jnp.concatenate(idx)), np.asarray(jnp.concatenate(w))


def _jax_vector_idx_w(xyzt, resolution):
    i, w = j_ff._vector_idx_w(jnp.clip(jnp.asarray(xyzt), 0.0, 1.0), resolution)
    return np.asarray(i), np.asarray(w)


def _jax_reference(tables, idx, w):
    """The oracle with out-of-table corners given no weight (the Pallas
    kernel's one-hot rows have no entry for them)."""
    T = tables.shape[-1]
    inside = (idx >= 0) & (idx < T)
    return lambda t: fused_interp_reference(t, jnp.asarray(np.clip(idx, 0, T - 1)), jnp.asarray(np.where(inside, w, 0)))


def _scaled_err(out, ref):
    return np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-9)


CASES = {
    "grid-dense-and-hashed": (GRID, False),
    "grid-dense-past-table": (OVERFLOW, True),
    "vector": (None, False),
}


def _case(name, n=1000):
    """→ (spec, tables, xyzt, JAX idx, JAX w) for one of CASES."""
    grid, far = CASES[name]
    xyzt = _xyzt(n, far=far)
    if grid is None:
        R = 128
        idx, w = _jax_vector_idx_w(xyzt, R)
        return fli.VECTOR_SPEC, _tables(4, 8, R), xyzt, idx, w
    cfg = THashGridConfig(**grid)
    idx, w = _jax_grid_idx_w(xyzt, cfg)
    return fli.grid_spec(cfg), _tables(4 * cfg.n_levels, cfg.n_features_per_level, cfg.table_size), xyzt, idx, w


@pytest.mark.parametrize("name", list(CASES))
def test_plain_forward_matches_jax_corners_and_oracle(name):
    """Indices exactly; weights the same fp32 products (1e-6 absolute on
    weights ≤ 1); the output 1e-6 of its scale (the oracle sums corners in
    another order)."""
    spec, tables, xyzt, j_idx, j_w = _case(name)
    t_idx, t_w = fli.corner_idx_w(torch.tensor(xyzt), spec, tables.shape[-1])
    np.testing.assert_array_equal(t_idx.numpy(), j_idx)
    np.testing.assert_allclose(t_w.numpy(), j_w, rtol=0, atol=1e-6)
    if name == "grid-dense-past-table":
        assert (j_idx >= tables.shape[-1]).any()
    if name == "grid-dense-and-hashed":
        dense = fli.grid_spec(THashGridConfig(**GRID)).levels()[2]
        assert any(dense) and not all(dense)
    ref = np.asarray(_jax_reference(tables, j_idx, j_w)(jnp.asarray(tables)))
    out = fli.field_interp_plain(torch.tensor(tables), torch.tensor(xyzt), spec).numpy()
    assert out.shape == ref.shape
    assert _scaled_err(out, ref) <= 1e-6


def test_vector_taps_clamp_at_both_ends():
    xyzt = np.array([[0, 0, 0, 0], [1, 1, 1, 1], [-1, 2, 0.5, 1e-4]], dtype=np.float32)
    idx, _ = fli.corner_idx_w(torch.tensor(xyzt), fli.VECTOR_SPEC, 64)
    j_idx, _ = _jax_vector_idx_w(xyzt, 64)
    np.testing.assert_array_equal(idx.numpy(), j_idx)
    assert idx[:, 0, 0].tolist() == [0, 0, 0, 0] and idx[:, 1, 1].tolist() == [63, 63, 63, 63]


@pytest.mark.parametrize("name", list(CASES))
def test_plain_backward_matches_jax_grad(name):
    """`field_interp_bwd_plain` against `jax.grad` of the oracle with respect
    to the tables: both scatter-add fp32 products in another order, 1e-6 of
    the scale."""
    spec, tables, xyzt, j_idx, j_w = _case(name)
    g = np.random.default_rng(2).normal(size=(tables.shape[0], tables.shape[1], xyzt.shape[0])).astype(np.float32)
    fn = _jax_reference(tables, j_idx, j_w)
    ref = np.asarray(jax.grad(lambda t: (fn(t) * jnp.asarray(g)).sum())(jnp.asarray(tables)))
    out = fli.field_interp_bwd_plain(torch.tensor(g), torch.tensor(xyzt), spec, tables.shape[-1]).numpy()
    assert out.shape == tables.shape
    assert _scaled_err(out, ref) <= 1e-6


def test_cpu_routes_to_plain_with_gradients_to_the_tables_only():
    spec, tables, xyzt, _, _ = _case("grid-dense-and-hashed", n=300)
    t = torch.tensor(tables, requires_grad=True)
    x = torch.tensor(xyzt, requires_grad=True)
    before = dict(fli.launches)
    out = fli.field_interp(t, x, spec)
    assert type(out.grad_fn).__name__ == "PlainFieldInterpBackward"
    # Only the (N, 4) coordinates are saved, no (P, C, N) corners.
    assert [tuple(s.shape) for s in out.grad_fn.saved_tensors] == [(300, 4)]
    g = torch.tensor(np.random.default_rng(3).normal(size=out.shape).astype(np.float32))
    out.backward(g)
    assert x.grad is None
    assert fli.launches == before
    torch.testing.assert_close(out, fli.field_interp_plain(t.detach(), x.detach(), spec), rtol=0, atol=0)
    ref = fli.field_interp_bwd_plain(g, x.detach(), spec, tables.shape[-1])
    torch.testing.assert_close(t.grad, ref, rtol=0, atol=0)


def test_cpu_tensors_never_touch_the_cuda_library():
    spec, tables, xyzt, _, _ = _case("vector", n=200)
    t = torch.tensor(tables, requires_grad=True)
    with mock.patch.object(fli, "load_library", side_effect=AssertionError("CUDA library loaded")):
        fli.field_interp(t, torch.tensor(xyzt), spec).sum().backward()
    assert t.grad is not None


@pytest.mark.parametrize("grid", [GRID, OVERFLOW, R4, CAPACITY], ids=["grid", "overflow", "r4", "capacity"])
def test_grid_spec_round_trips_the_levels(grid):
    """The struct holds each level's fp32 scale, resolution and dense flag as
    `HashGridConfig` gives them, and reads back the same."""
    cfg = THashGridConfig(**grid)
    spec = fli.grid_spec(cfg)
    assert (spec.mode, spec.n_levels) == (fli.MODE_GRID, cfg.n_levels)
    scales, resolutions, dense = spec.levels()
    np.testing.assert_array_equal(np.asarray(scales, dtype=np.float32), cfg.level_scales())
    assert resolutions == cfg.level_resolutions().tolist()
    assert dense == [int(r) ** 3 <= cfg.table_size for r in cfg.level_resolutions()]
    if grid is CAPACITY:
        assert dense == [True] * 4 + [False] * 12
    if grid is R4:
        assert not any(dense)
    # A copy through the C layout (as ctypes passes it by value) reads back the same.
    copy = fli.FieldSpec.from_buffer_copy(bytes(spec))
    assert copy.levels() == spec.levels()


@pytest.mark.parametrize(
    "bad",
    [
        lambda t, x: (t.double(), x),
        lambda t, x: (t, x.double()),
        lambda t, x: (t, x[:, :3]),
        lambda t, x: (t[:-1], x),
        lambda t, x: (t[0], x),
    ],
    ids=["f64-tables", "f64-xyzt", "xyzt-shape", "pairs", "rank"],
)
def test_wrapper_rejects_bad_inputs(bad):
    spec, tables, xyzt, _, _ = _case("grid-dense-and-hashed", n=100)
    with pytest.raises((TypeError, ValueError)):
        fli.field_interp(*bad(torch.tensor(tables), torch.tensor(xyzt)), spec)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# (grid config or None for the vectors, T or R, N): small and ragged N, a
# table size that is not a power of two (for the grid, its dense levels'
# corners then leave the table), the r4 width and T = 2^19.
CARD_CASES = {
    "grid-small-ragged": (GRID, 1 << 13, 1001),
    "grid-odd-T": (GRID, 3001, 4099),
    "grid-r4": (R4, 1 << 11, 65_539),
    "grid-capacity": (CAPACITY, 1 << 19, 32_768),
    "vector-small-ragged": (None, 128, 777),
    "vector-odd-R": (None, 1000, 4099),
    "vector-r4": (None, 2048, 65_536),
}


def _card_inputs(name, device):
    grid, T, N = CARD_CASES[name]
    if grid is None:
        spec, P, F = fli.VECTOR_SPEC, 4, 32
    else:
        cfg = THashGridConfig(**grid)
        spec, P, F = fli.grid_spec(cfg), 4 * cfg.n_levels, cfg.n_features_per_level
    tables = torch.tensor(_tables(P, F, T), device=device)
    xyzt = torch.tensor(_xyzt(N, far=True), device=device)
    g = torch.tensor(np.random.default_rng(2).normal(size=(P, F, N)).astype(np.float32), device=device)
    return spec, tables, xyzt, g


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_forward_kernel_matches_plain_on_card(cuda_device, name):
    """Both compute the corners with the same fp32 roundings and sum them in
    the same order without fma: equal up to 1e-5 of the scale (bit for bit in
    practice; one wrong corner would show far above that)."""
    spec, tables, xyzt, _ = _card_inputs(name, cuda_device)
    before = fli.launches["fwd"]
    out = fli.field_interp(tables, xyzt, spec)
    ref = fli.field_interp_plain(tables, xyzt, spec)
    torch.cuda.synchronize()
    assert fli.launches["fwd"] == before + 1
    assert float((out - ref).abs().max() / ref.abs().max()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_backward_kernel_matches_plain_on_card(cuda_device, name):
    """Against the plain version summed in fp64 (the same fp32 weights): the
    kernel's atomics add in a run-dependent order, and an entry sums up to a
    few thousand terms here; its fp32 sums, taken in runs, blocks and then the
    table, stay within 1e-5 of the scale."""
    spec, tables, xyzt, g = _card_inputs(name, cuda_device)
    before = fli.launches["bwd"]
    t = tables.clone().requires_grad_()
    fli.field_interp(t, xyzt, spec).backward(g)
    ref = fli.field_interp_bwd_plain(g.double(), xyzt, spec, tables.shape[-1])
    torch.cuda.synchronize()
    assert fli.launches["bwd"] == before + 1
    assert float((t.grad.double() - ref).abs().max() / ref.abs().max()) < 1e-5
