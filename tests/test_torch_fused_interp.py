"""The port's `fused_interp` (humanrf_torch/ops/fused_interp.py), forward and
backward, against the JAX package's oracle and Pallas kernel
(humanrf_tpu/ops/fused_interp.py).

On the CPU the wrapper runs the plain PyTorch versions; the CUDA kernels are
checked against them by the `cuda`-marked tests, on the card only.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def test_wrapper_takes_plain_version_on_cpu_without_launching():
    tables, idx, w = (torch.tensor(a) for a in _inputs())
    before = dict(fi.launches)
    out = fi.fused_interp(tables.requires_grad_(), idx, w)
    out.sum().backward()
    assert fi.launches == before
    torch.testing.assert_close(out, fi.fused_interp_plain(tables, idx, w), rtol=0, atol=0)
    g = torch.ones_like(out)
    torch.testing.assert_close(tables.grad, fi.fused_interp_bwd_plain(g, idx, w, tables.shape[-1]), rtol=0, atol=0)


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


def test_autograd_through_the_function_on_cpu():
    """Gradients reach the tables through `fused_interp` (the plain
    `autograd.Function` on the CPU) and match autograd of the plain forward;
    idx and w get none. gradcheck in float64 is not possible (the op is
    float32 only), so the comparison is against torch's own gather backward:
    both are fp32 scatter-adds, 1e-6 of the scale."""
    tables, idx, w = _inputs()
    t1 = torch.tensor(tables, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    g = torch.tensor(_cotangent(*tables.shape[:2], idx.shape[-1]))
    (fi.fused_interp(t1, torch.tensor(idx), wt) * g).sum().backward()
    t2 = torch.tensor(tables, requires_grad=True)
    (fi.fused_interp_plain(t2, torch.tensor(idx), torch.tensor(w)) * g).sum().backward()
    assert wt.grad is None
    assert _scaled_err(t1.grad.numpy(), t2.grad.numpy()) <= 1e-6


@pytest.mark.parametrize(
    "bad",
    [
        lambda t, i, w: (t.double(), i, w),
        lambda t, i, w: (t, i.long(), w),
        lambda t, i, w: (t, i, w[:, :, :-1]),
        lambda t, i, w: (t[:-1], i, w),
        lambda t, i, w: (t[0], i, w),
    ],
    ids=["f64-tables", "i64-idx", "w-shape", "pairs", "rank"],
)
def test_wrapper_rejects_bad_inputs(bad):
    args = bad(*(torch.tensor(a) for a in _inputs()))
    with pytest.raises((TypeError, ValueError)):
        fi.fused_interp(*args)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape",
    [(32, 4, 2048, 8, 262_144, False), (4, 32, 2048, 2, 262_144, False), (64, 2, 1 << 19, 8, 65_536, False),
     (3, 4, 100, 8, 1000, True)],
    ids=["grids", "vectors", "capacity", "ragged-outside"],
)
def test_kernel_matches_plain_on_card(cuda_device, shape):
    """Kernel and plain version are both fp32 and sum corners in the same
    order (the kernel with fma): 1e-5 of the output scale."""
    P, F, T, C, N, outside = shape
    tables, idx, w = (torch.tensor(a, device=cuda_device) for a in _inputs(P, F, T, C, N, outside=outside))
    before = fi.launches["fwd"]
    out = fi.fused_interp(tables, idx, w)
    ref = fi.fused_interp_plain(tables, idx, w)
    torch.cuda.synchronize()
    assert fi.launches["fwd"] == before + 1
    assert float((out - ref).abs().max() / ref.abs().max()) < 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize(
    "shape",
    [(32, 4, 2048, 8, 262_144, False), (4, 32, 2048, 2, 262_144, False), (64, 2, 1 << 19, 8, 65_536, False),
     (3, 4, 100, 8, 1000, True)],
    ids=["grids", "vectors", "capacity", "ragged-outside"],
)
def test_backward_kernel_matches_plain_on_card(cuda_device, shape):
    """Both are fp32 sums whose order differs (atomics add in a run-dependent
    order; the plain scatter_add too). An entry of dtab sums ~N·C/T terms
    (≤ 1,024 at these shapes); reordering such a sum moves it by about
    eps·√n of its terms' size, ~2e-6 relative, so 1e-5 of the scale bounds it.
    The grid and vector shapes take the shared-memory slab, T = 2^19 the
    global-atomic path."""
    P, F, T, C, N, outside = shape
    _, idx, w = (torch.tensor(a, device=cuda_device) for a in _inputs(P, F, T, C, N, outside=outside))
    g = torch.tensor(_cotangent(P, F, N), device=cuda_device)
    before = fi.launches["bwd"]
    tables = torch.zeros((P, F, T), device=cuda_device, requires_grad=True)
    fi.fused_interp(tables, idx, w).backward(g)
    ref = fi.fused_interp_bwd_plain(g, idx, w, T)
    torch.cuda.synchronize()
    assert fi.launches["bwd"] == before + 1
    assert float((tables.grad - ref).abs().max() / ref.abs().max()) < 1e-5
