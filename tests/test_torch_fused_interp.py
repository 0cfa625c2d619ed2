"""The port's (idx, w) lookup in plain PyTorch (humanrf_torch/ops/
fused_interp.py), forward and backward, against the JAX package's oracle
and Pallas kernel (humanrf_tpu/ops/fused_interp.py).

On the card, the `cuda`-marked tests hold the kernels that replace the
Pallas pair, the field query's (humanrf_torch/csrc/field_interp.cu), to
their plain version at the Pallas kernels' shapes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanrf_torch.models.hash_encoding import HashGridConfig
from humanrf_torch.ops import field_interp as fli
from humanrf_torch.ops import fused_interp as fi
from humanrf_tpu.ops.fused_interp import fused_interp as pallas_fused_interp
from humanrf_tpu.ops.fused_interp import fused_interp_reference

torch.set_num_threads(2)


def _inputs(P=3, F=4, T=256, C=8, N=700, seed=0, outside=False):
    """Random tables and corners; the corner weights of a sample sum to 1.
    With `outside`, about a tenth of the indices lie outside [0, T)."""
    rng = np.random.default_rng(seed)
    tables = rng.normal(size=(P, F, T)).astype(np.float32)
    idx = rng.integers(-T // 10 if outside else 0, T + T // 10 if outside else T, (P, C, N)).astype(np.int32)
    w = rng.uniform(0, 1, (P, C, N)).astype(np.float32)
    return tables, idx, w / w.sum(axis=1, keepdims=True)


def _scaled_err(out, ref):
    return np.max(np.abs(out - ref)) / (np.max(np.abs(ref)) + 1e-9)


@pytest.mark.parametrize("shape", [(3, 4, 256, 8, 700), (4, 32, 128, 2, 300)], ids=["grids", "vectors"])
def test_plain_matches_jax_oracle(shape):
    """Both are fp32 gather + weighted sum; they differ only in summation
    order, so 1e-6 of the output scale."""
    P, F, T, C, N = shape
    tables, idx, w = _inputs(P, F, T, C, N)
    ref = np.asarray(fused_interp_reference(jnp.asarray(tables), jnp.asarray(idx), jnp.asarray(w)))
    out = fi.fused_interp_plain(torch.tensor(tables), torch.tensor(idx), torch.tensor(w)).numpy()
    assert out.shape == (P, F, N)
    assert _scaled_err(out, ref) <= 1e-6


def test_corners_outside_the_table_contribute_nothing():
    """Exactly the oracle on the same samples with those corners' weights
    zeroed (and their indices clamped, which the oracle needs)."""
    tables, idx, w = _inputs(outside=True)
    inside = (idx >= 0) & (idx < tables.shape[-1])
    assert not inside.all()
    ref = np.asarray(fused_interp_reference(
        jnp.asarray(tables), jnp.asarray(np.clip(idx, 0, tables.shape[-1] - 1)), jnp.asarray(np.where(inside, w, 0))
    ))
    out = fi.fused_interp_plain(torch.tensor(tables), torch.tensor(idx), torch.tensor(w)).numpy()
    assert _scaled_err(out, ref) <= 1e-6


@pytest.mark.parametrize("outside", [False, True], ids=["inside", "outside"])
def test_plain_matches_pallas_kernel_interpreted(outside):
    """The Pallas kernel rounds tables and one-hot rows to bf16 for the MXU
    (fp32 accumulation), so it agrees to bf16 precision: 2e-2 of the scale,
    the bound tests/test_fused_interp.py holds it to. Its one-hot rows have
    no entry for an index outside [0, T)."""
    tables, idx, w = _inputs(outside=outside)
    ref = np.asarray(pallas_fused_interp(jnp.asarray(tables), jnp.asarray(idx), jnp.asarray(w), "twolevel", 128, True))
    out = fi.fused_interp_plain(torch.tensor(tables), torch.tensor(idx), torch.tensor(w)).numpy()
    assert _scaled_err(out, ref) < 2e-2


def _cotangent(P, F, N, seed=1):
    return np.random.default_rng(seed).normal(size=(P, F, N)).astype(np.float32)


def _jax_table_grad(fn, tables, idx, w, g):
    return np.asarray(jax.grad(lambda t: (fn(t, jnp.asarray(idx), jnp.asarray(w)) * jnp.asarray(g)).sum())(jnp.asarray(tables)))


@pytest.mark.parametrize("shape", [(3, 4, 256, 8, 700), (4, 32, 128, 2, 300)], ids=["grids", "vectors"])
def test_plain_backward_matches_jax_oracle_gradient(shape):
    """`fused_interp_bwd_plain` against `jax.grad` of `fused_interp_reference`:
    both scatter-add fp32 products, in another order, so 1e-6 of the scale."""
    P, F, T, C, N = shape
    tables, idx, w = _inputs(P, F, T, C, N)
    g = _cotangent(P, F, N)
    ref = _jax_table_grad(fused_interp_reference, tables, idx, w, g)
    out = fi.fused_interp_bwd_plain(torch.tensor(g), torch.tensor(idx), torch.tensor(w), T).numpy()
    assert out.shape == (P, F, T)
    assert _scaled_err(out, ref) <= 1e-6


@pytest.mark.parametrize("outside", [False, True], ids=["inside", "outside"])
def test_plain_backward_matches_pallas_backward_interpreted(outside):
    """The Pallas backward contracts bf16 cotangents with bf16 one-hot rows
    (fp32 accumulation): 2e-2 of the scale, tests/test_fused_interp.py's
    bound. An index outside [0, T) has no one-hot entry there and gets no
    gradient here."""
    tables, idx, w = _inputs(outside=outside)
    g = _cotangent(*tables.shape[:2], idx.shape[-1])
    ref = _jax_table_grad(lambda t, i, ww: pallas_fused_interp(t, i, ww, "twolevel", 128, True), tables, idx, w, g)
    out = fi.fused_interp_bwd_plain(torch.tensor(g), torch.tensor(idx), torch.tensor(w), tables.shape[-1]).numpy()
    assert _scaled_err(out, ref) < 2e-2


def test_corners_outside_the_table_get_no_gradient():
    """Exactly the in-table corners' scatter: the same samples with the
    out-of-table corners' weights zeroed give the same gradient, bit for bit."""
    tables, idx, w = _inputs(outside=True)
    T = tables.shape[-1]
    inside = (idx >= 0) & (idx < T)
    g = torch.tensor(_cotangent(*tables.shape[:2], idx.shape[-1]))
    out = fi.fused_interp_bwd_plain(g, torch.tensor(idx), torch.tensor(w), T)
    ref = fi.fused_interp_bwd_plain(g, torch.tensor(np.clip(idx, 0, T - 1)), torch.tensor(np.where(inside, w, 0)), T)
    assert torch.equal(out, ref)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# The Pallas kernels' shapes as field queries of one segment, (grid, R, N):
# the r4 grids (P = 32 pairs, F = 4, T = 2048), 32 features a vector (the
# vectors' P = 4, D = 32, R = 2048: L16/F2), the reference capacity
# (P = 64, T = 2^19) and a ragged case whose dense level's far corners leave
# the table (T = 2^9 < 8³ + 8² + 8) with R = 100.
CARD_QUERIES = {
    "grids": (dict(n_levels=8, n_features_per_level=4, log2_hashmap_size=11, base_resolution=32,
                   finest_resolution=2048), 2048, 262_144),
    "vectors": (dict(n_levels=16, n_features_per_level=2, log2_hashmap_size=11, base_resolution=32,
                     finest_resolution=2048), 2048, 262_144),
    "capacity": (dict(n_levels=16, n_features_per_level=2, log2_hashmap_size=19, base_resolution=32,
                      finest_resolution=2048), 2048, 65_536),
    "ragged-outside": (dict(n_levels=2, n_features_per_level=2, log2_hashmap_size=9, base_resolution=8,
                            finest_resolution=16), 100, 1000),
}


def _card_query(name, device):
    """One segment's random tables, uniform samples (with a quarter of them
    in the last cells in the ragged case) and a cotangent."""
    grid, R, N = CARD_QUERIES[name]
    cfg = HashGridConfig(**grid)
    L, F, T = cfg.n_levels, cfg.n_features_per_level, cfg.table_size
    rng = np.random.default_rng(0)
    grids = tuple(torch.tensor(rng.normal(size=(L, F, T)).astype(np.float32), device=device) for _ in range(4))
    vectors = torch.tensor(rng.normal(size=(4, L * F, R)).astype(np.float32), device=device)
    xyzt = rng.uniform(0, 1, (N, 4)).astype(np.float32)
    if name == "ragged-outside":
        xyzt[: N // 4] = 0.95 + 0.05 * xyzt[: N // 4]
    g = torch.tensor(rng.normal(size=(N, L * F)).astype(np.float32), device=device)
    return [fli.SegmentField(grids, vectors, fli.grid_spec(cfg))], torch.tensor(xyzt, device=device), g


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_QUERIES))
def test_kernel_matches_plain_on_card(cuda_device, name):
    """The field query's forward kernel, one launch, against its plain
    version: the same corners and the same fp32 roundings summed in the
    same order without fma, so bit for bit."""
    fields, xyzt, _ = _card_query(name, cuda_device)
    before = fli.launches["fwd"]
    out = fli.field_query(fields, xyzt)
    ref = fli.field_query_plain(fields, xyzt)
    torch.cuda.synchronize()
    assert fli.launches["fwd"] == before + 1
    assert torch.equal(out, ref) and ref.abs().max() > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_QUERIES))
def test_backward_kernel_matches_plain_on_card(cuda_device, name):
    """The field query's backward kernel, one launch, against its plain
    version summed in fp64: the kernel's fp32 atomics add in a run-dependent
    order, and an entry sums up to ~N·8/T terms (~1,000 at these shapes);
    every table's and vector's gradient within 1e-5 of its scale."""
    fields, xyzt, g = _card_query(name, cuda_device)
    tensors = [t.clone().requires_grad_() for t in fli._flat(fields)]
    before = fli.launches["bwd"]
    fli.field_query(fli._unflat([(f.spec, len(f.grids)) for f in fields], tensors), xyzt).backward(g)
    refs = fli.field_query_bwd_plain(fields, xyzt, g.double())
    torch.cuda.synchronize()
    assert fli.launches["bwd"] == before + 1
    for t, r in zip(tensors, refs):
        assert float((t.grad.double() - r).abs().max() / r.abs().max()) < 1e-5
