"""K-Planes (hybrid) on the port, JAX-free: the plane query against the
benchmark's plain reference (`hrfbench/reference/kplanes.py`, which imports
nothing of the port) and against `F.grid_sample`, the regularisers against
hand-computed values, three train steps against the reference's, the
two-level proposal path with the level argument bit-equal to what it was,
the opt-in in-place gradient rule, and a tiny CLI run (train, save, resume,
render).

The card's cases carry `cuda` and skip here: the kernels against the plain
path (forward bit for bit, backward against the fp64 plain sum), their
launch counts, `torch.autograd.grad` through both field kernels, and the
backward adding into `.grad` inside a captured graph; the regularisers'
kernels against the plain formulas in fp64 and their backward's plain
mirror, in place and fresh, eager and captured. On the card:
`python3 -m pytest -q -m cuda --noconftest tests/test_torch_kplanes.py`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from humanrf_torch.ops import field_interp as fli
from humanrf_torch.ops import kplanes as K
from humanrf_torch.utils import profiling

# The tiny field of the CPU tests: M 4, spatial 8 texels at scale 1, time 5, 2 scales.
TINY = dict(channels=4, resolution=8, time_resolution=5, multiscales=(1, 2))


def _planes(channels, resolution, time_resolution, multiscales, seed=0, device="cpu", requires_grad=False):
    """Spatial planes U[0.1, 0.5], time planes 1 + U[-0.1, 0.1] (perturbed,
    so that a fault in the time axis shows in every value)."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for s in multiscales:
        res = (resolution * s,) * 3 + (time_resolution,)
        for p in range(6):
            u = torch.rand(K.plane_shape(res, p, channels), generator=gen)
            t = (1.0 + 0.2 * (u - 0.5)) if p in K.TIME_PLANES else 0.1 + 0.4 * u
            out.append(t.to(device).requires_grad_(requires_grad))
    return out


def _border_coords(n, time_resolution, resolution, seed=1, device="cpu"):
    """Coordinates in [-1, 1]^4 with some on cell borders of every scale's
    axes, at ±1 and just outside (the border clamp)."""
    rng = np.random.default_rng(seed)
    q = rng.uniform(-1, 1, (n, 4)).astype(np.float32)
    k = n // 4
    cells = rng.integers(0, resolution + 1, (k, 3))
    q[:k, :3] = (2.0 * cells / resolution - 1.0).astype(np.float32)
    q[:k, 3] = (2.0 * rng.integers(0, time_resolution, k) / (time_resolution - 1) - 1.0).astype(np.float32)
    q[k:2 * k] = rng.choice(np.array([-1.0, 1.0, -1.02, 1.02], dtype=np.float32), (k, 4))
    return torch.tensor(q, device=device)


# ------------------------------------------------------------ the query


def test_plain_query_is_grid_sample():
    """Each scale's features are the product over the six planes of
    `F.grid_sample` (bilinear, align_corners=True, border) of the plane."""
    planes = _planes(**TINY)
    q = _border_coords(200, TINY["time_resolution"], TINY["resolution"])
    out = K.plane_query(planes, q)
    m = TINY["channels"]
    for s in range(2):
        f = None
        for p, (i, j) in enumerate(K.PLANES):
            grid = planes[6 * s + p].permute(2, 0, 1)[None]
            v = F.grid_sample(grid, q[:, [i, j]][None, None], mode="bilinear", align_corners=True,
                              padding_mode="border")[0, :, 0].T
            f = v if f is None else f * v
        torch.testing.assert_close(out[:, s * m:(s + 1) * m], f, rtol=1e-6, atol=1e-7)


def test_plain_backward_is_autograd():
    """`plane_query_bwd_plain` in fp64 against autograd through the plain query."""
    planes = _planes(**TINY, requires_grad=True)
    q = _border_coords(150, TINY["time_resolution"], TINY["resolution"], seed=2)
    g = torch.randn(150, 8, generator=torch.Generator().manual_seed(3))
    n_valid = torch.tensor([120], dtype=torch.int32)
    seg = torch.tensor(np.where(np.arange(150) % 7 == 0, -1, 0).astype(np.int32))
    K.plane_query(planes, q, n_valid, seg).backward(g)
    ref = K.plane_query_bwd_plain([t.detach() for t in planes], q, g.double(), n_valid, seg)
    for t, r in zip(planes, ref):
        torch.testing.assert_close(t.grad.double(), r, rtol=1e-5, atol=1e-6)


def test_skipped_samples_read_zero_and_add_nothing():
    planes = _planes(**TINY, requires_grad=True)
    q = _border_coords(64, TINY["time_resolution"], TINY["resolution"], seed=4)
    seg = torch.tensor(np.where(np.arange(64) < 32, 0, -1).astype(np.int32))
    out = K.plane_query(planes, q, torch.tensor([16], dtype=torch.int32), seg)
    assert out[:16].abs().min() > 0 and not out[16:].any()
    out.sum().backward()
    alone = _planes(**TINY, requires_grad=True)
    K.plane_query(alone, q[:16]).sum().backward()
    for a, b in zip(planes, alone):
        torch.testing.assert_close(a.grad, b.grad, rtol=1e-6, atol=1e-7)


def test_query_checks_its_inputs():
    planes = _planes(**TINY)
    q = torch.zeros(4, 4)
    with pytest.raises(ValueError):
        K.plane_query(planes[:5], q)
    with pytest.raises(ValueError):
        K.plane_query([planes[2]] + planes[1:], q)
    with pytest.raises(TypeError):
        K.plane_query(planes, q, torch.tensor([2]))


# --------------------------------------------------- the in-place rule


def test_in_place_gradients_are_opt_in():
    """A table or plane with a `.grad` takes its gradient in place only
    inside `grads_in_place()`, which the train step opens around its
    `loss.backward()`; outside it, every caller gets a fresh buffer."""
    plane = torch.nn.Parameter(torch.ones(3, 4, 8))
    plane.grad = torch.zeros_like(plane)
    assert not fli.grad_in_place(plane)
    with fli.grads_in_place():
        assert fli.grad_in_place(plane)
        with fli.grads_in_place():
            assert fli.grad_in_place(plane)
        assert fli.grad_in_place(plane)
    assert not fli.grad_in_place(plane)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


# The kernels' instances at sizes of the configuration's: the main field
# (M 32, scales 1, 2, 4, 8 of 64 texels, time 25) and a proposal (M 8, 128).
CARD_CASES = {
    "field": dict(channels=32, resolution=64, time_resolution=25, multiscales=(1, 2, 4, 8)),
    "proposal": dict(channels=8, resolution=128, time_resolution=25, multiscales=(1,)),
    "one-scale-32": dict(channels=32, resolution=32, time_resolution=25, multiscales=(1,)),
    "four-scales-8": dict(channels=8, resolution=16, time_resolution=25, multiscales=(1, 2, 4, 8)),
}


def _ray_coords(n_rays, k, seed, device):
    """Samples along rays, k consecutive per ray, in the frames' rows of t."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-1, 1, (n_rays, 1, 3))
    d = rng.normal(size=(n_rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    s = np.sort(rng.uniform(0, 1.5, (n_rays, k)), axis=1)[..., None]
    xyz = np.clip(o + d * s, -1.05, 1.05)
    t = np.repeat(rng.choice(np.linspace(-1, 1, 50), (n_rays, 1, 1)), k, axis=1)
    return torch.tensor(np.concatenate([xyz, t], -1).reshape(-1, 4).astype(np.float32), device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
def test_kernels_equal_the_plain_query_on_card(cuda_device, case):
    """Forward: the kernel's features equal `plane_query_plain`'s bit for
    bit, on cell borders, at ±1, on skipped samples. Backward: each plane's
    gradient within 1e-5 of its scale of the plain backward summed in fp64
    (fp32 atomics in a run-dependent order). One launch each way."""
    spec = CARD_CASES[case]
    planes = _planes(**spec, seed=5, device=cuda_device, requires_grad=True)
    n = 65_536
    q = torch.cat([_ray_coords(n // 64 // 2, 64, 6, cuda_device),
                   _border_coords(n // 2, spec["time_resolution"], spec["resolution"], 7, cuda_device)])
    n_valid = torch.tensor([n - 1000], dtype=torch.int32, device=cuda_device)
    seg = torch.tensor(np.where(np.arange(n) % 11 == 3, -1, 0).astype(np.int32), device=cuda_device)
    K.reset_launches()
    out = K.plane_query(planes, q, n_valid, seg)
    plain = K.plane_query_plain([t.detach() for t in planes], q, n_valid, seg)
    assert torch.equal(out, plain)
    g = torch.randn(out.shape, generator=torch.Generator(device=cuda_device).manual_seed(8), device=cuda_device)
    out.backward(g)
    ref = K.plane_query_bwd_plain([t.detach() for t in planes], q, g.double(), n_valid, seg)
    torch.cuda.synchronize()
    assert K.launches == {"fwd": 1, "bwd": 1, "reg_fwd": 0, "reg_bwd": 0}
    for i, (t, r) in enumerate(zip(planes, ref)):
        assert float((t.grad.double() - r).abs().max() / r.abs().max()) < 1e-5, i


@pytest.mark.cuda
def test_autograd_grad_through_both_kernels_is_the_plain_gradient_on_card(cuda_device):
    """`torch.autograd.grad` over a plane or a hash table whose `.grad` is
    there returns the gradient (the plain path's, within 1e-5 of scale) and
    leaves `.grad` as it was: outside `grads_in_place()` nothing goes in place."""
    planes = _planes(**CARD_CASES["proposal"], seed=9, device=cuda_device, requires_grad=True)
    for t in planes:
        t.grad = torch.full_like(t, 7.0)
    q = _ray_coords(256, 64, 10, cuda_device)
    out = K.plane_query(planes, q)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, planes, g)
    ref = K.plane_query_bwd_plain([t.detach() for t in planes], q, g.double())
    for t, a, r in zip(planes, got, ref):
        assert float((a.double() - r).abs().max() / r.abs().max()) < 1e-5
        assert bool((t.grad == 7.0).all())

    from humanrf_torch.models.hash_encoding import HashGridConfig

    cfg = HashGridConfig(n_levels=8, n_features_per_level=4, log2_hashmap_size=13, base_resolution=32,
                         finest_resolution=2048)
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    shapes = [(8, 4, cfg.table_size)] * 4 + [(4, 32, 2048)]
    leaves = [(torch.rand(s, generator=gen, device=cuda_device) - 0.5).requires_grad_() for s in shapes]
    for t in leaves:
        t.grad = torch.full_like(t, 7.0)
    fields = fli._unflat([(fli.grid_spec(cfg), 4)], leaves)
    xyzt = torch.rand((16_384, 4), generator=gen, device=cuda_device)
    out = fli.field_query(fields, xyzt)
    g = torch.randn_like(out)
    got = torch.autograd.grad(out, leaves, g)
    ref = fli.field_query_bwd_plain(fli._unflat([(fli.grid_spec(cfg), 4)], [t.detach() for t in leaves]), xyzt,
                                    g.double())
    for t, a, r in zip(leaves, got, ref):
        assert float((a.double() - r).abs().max() / r.abs().max()) < 1e-5
        assert bool((t.grad == 7.0).all())


@pytest.mark.cuda
def test_captured_backward_adds_into_grad_on_card(cuda_device, monkeypatch):
    """Captured as a CUDA graph inside `grads_in_place()` with every `.grad`
    there, the backward adds into them (`field.grads_fresh` 0) and a replay
    leaves each `.grad` at what it held plus the gradient; the replay adds
    the capture's launches to the counts."""
    from humanrf_torch.train.graphs import GraphedStep

    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    planes = _planes(**CARD_CASES["field"], seed=12, device=cuda_device, requires_grad=True)
    q = _ray_coords(512, 48, 13, cuda_device)
    g = torch.randn((q.shape[0], 128), generator=torch.Generator(device=cuda_device).manual_seed(14),
                    device=cuda_device)
    ref = K.plane_query_bwd_plain([t.detach() for t in planes], q, g.double())

    def body(q, g):
        with fli.grads_in_place():
            K.plane_query(planes, q).backward(g)
        return q.sum()

    step = GraphedStep("a plane query", body)
    step(q, g)  # the eager body (fresh buffers become .grad), then the capture, which runs nothing
    counters = profiling.snapshot()["counters"]
    assert counters["field.grads_fresh"] == 0
    assert counters["field.grads_in_place"] == sum(t.numel() for t in planes)
    held = [t.grad.clone() for t in planes]
    K.reset_launches()
    step(q, g)
    torch.cuda.synchronize()
    assert K.launches == {"fwd": 1, "bwd": 1, "reg_fwd": 0, "reg_bwd": 0}
    for t, h, r in zip(planes, held, ref):
        assert float(((t.grad - h).double() - r).abs().max() / r.abs().max()) < 1e-5


# ------------------------------------------------------ the regularisers

# Plane fields as the regularisers take them: per field its per-axis sizes
# (x, y, z, t) per scale, its channels and its (tv, smoothness, l1) weights.
REG_CASES = {
    # The cell's: the field (M 32, 64·s spatial for s in 1, 2, 4, 8, time 25)
    # and two proposals (M 8 at 128 and 256), the configuration's weights.
    "cell": [([(64 * s,) * 3 + (25,) for s in (1, 2, 4, 8)], 32, (1e-4, 0.1, 1e-4)),
             ([(128,) * 3 + (25,)], 8, (1e-4, 1e-3, 1e-4)), ([(256,) * 3 + (25,)], 8, (1e-4, 1e-3, 1e-4))],
    # Small odd shapes: axes of 2 and 3 texels, time resolution 3, M 4 and 8.
    "odd": [([(2, 3, 5, 3), (3, 2, 2, 4)], 4, (2.0, 3.0, 5.0)), ([(3, 3, 2, 3)], 8, (7.0, 11.0, 13.0))],
    # The CPU tests' field: M 4, 8 texels at scales 1 and 2, time 5; a proposal.
    "tiny": [([(8,) * 3 + (5,), (16,) * 3 + (5,)], 4, (2.0, 3.0, 5.0)), ([(8,) * 3 + (5,)], 8, (7.0, 11.0, 13.0))],
}


def _reg_fields(case, seed, device="cpu", ones=0.0):
    """`REG_CASES[case]` → (fields, weights): spatial planes U[0.1, 0.5],
    time planes 1 + U[-0.1, 0.1] with a share `ones` of their entries set to
    exactly 1.0, leaves that require a gradient."""
    gen = torch.Generator().manual_seed(seed)
    fields, weights = [], []
    for scales, m, w in REG_CASES[case]:
        planes = []
        for res in scales:
            for p in range(6):
                u = torch.rand(K.plane_shape(res, p, m), generator=gen)
                if p in K.TIME_PLANES:
                    t = 1.0 + 0.2 * (u - 0.5)
                    t[torch.rand(t.shape, generator=gen) < ones] = 1.0
                else:
                    t = 0.1 + 0.4 * u
                planes.append(t.to(device).requires_grad_())
        fields.append(planes)
        weights.append(w)
    return fields, weights


def _plain_regularization(fields, weights, dtype=None):
    """The weighted plain formulas (`models/kplanes.py::plane_regularizers`),
    differentiable; in `dtype` where given."""
    from humanrf_torch.models.kplanes import plane_regularizers

    total = 0.0
    for planes, w in zip(fields, weights):
        terms = plane_regularizers([t if dtype is None else t.to(dtype) for t in planes])
        total = total + sum(wk * term for wk, term in zip(w, terms))
    return total


@pytest.mark.parametrize("case", ["odd", "tiny"])
def test_plain_regularizer_backward_is_autograd(case):
    """`plane_reg_bwd_plain` (the backward kernel's arithmetic) against
    autograd through the plain formulas in fp64, each plane within 1e-5 of
    its gradient's scale; time-plane entries at exactly 1.0 take sign 0 for
    the L1 term, as autograd's `abs` gives them."""
    fields, weights = _reg_fields(case, seed=41, ones=0.3)
    planes = [t for f in fields for t in f]
    grad = torch.tensor(0.75)
    expect = torch.autograd.grad(_plain_regularization(fields, weights, torch.float64) * grad.double(), planes)
    got = K.plane_reg_bwd_plain(fields, weights, grad)
    for i, (a, b) in enumerate(zip(got, expect)):
        assert a.dtype == torch.float32 and a.shape == b.shape
        assert float((a.double() - b).abs().max() / b.abs().max()) < 1e-5, i
    # With every time entry at 1.0 the time planes' gradients are exactly 0.
    with torch.no_grad():
        for f in fields:
            for p in K.TIME_PLANES:
                for s in range(len(f) // 6):
                    f[6 * s + p].fill_(1.0)
    got = K.plane_reg_bwd_plain(fields, weights, grad)
    for f_start, f in zip(np.cumsum([0] + [len(f) for f in fields]), fields):
        for i in range(len(f)):
            if i % 6 in K.TIME_PLANES:
                assert not got[f_start + i].any()


def test_reg_terms_weigh_the_plain_formulas():
    """The kernels' per-plane weights (`reg_terms`) over the squared row and
    column differences (spatial), the squared second differences along t
    and |1 − P| (time) sum to the weighted plain formulas, in fp64; the
    kernels' table lays each plane's blocks after the previous plane's."""
    fields, weights = _reg_fields("odd", seed=43, ones=0.2)
    planes = [t.detach().double() for f in fields for t in f]
    total = 0.0
    for t, (kind, w0, w1) in zip(planes, K.reg_terms(fields, weights)):
        if kind == K.SPATIAL:
            total += w0 * float(((t[1:] - t[:-1]) ** 2).sum()) + w1 * float(((t[:, 1:] - t[:, :-1]) ** 2).sum())
        else:
            total += w0 * float((((t[2:] - t[1:-1]) - (t[1:-1] - t[:-2])) ** 2).sum())
            total += w1 * float((1.0 - t).abs().sum())
    assert total == pytest.approx(float(_plain_regularization(fields, weights, torch.float64).detach()), rel=1e-12)
    flat = [t for f in fields for t in f]
    table = K._reg_struct(flat, K.reg_terms(fields, weights))
    blocks = [-(-(t.shape[1] * t.shape[2] // 4 * -(-t.shape[0] // K.REG_STRIP)) // K.REG_THREADS) for t in flat]
    assert [table.p[i].block0 for i in range(len(flat))] == list(np.cumsum([0] + blocks[:-1]))
    assert table.n_blocks == sum(blocks) and table.n_planes == len(flat)


def test_regularization_checks_its_planes():
    """The wrapper raises before any launch on a plane that is not float32,
    not contiguous, too small for its terms, or not six a scale, on a
    missing weight, and on CPU planes (the model takes the plain formulas there)."""
    fields, weights = _reg_fields("odd", seed=45)
    fields = [[t.detach() for t in f] for f in fields]
    with pytest.raises(TypeError):
        K.plane_regularization([[fields[0][0].double()] + fields[0][1:], fields[1]], weights)
    wide = torch.zeros(fields[0][0].shape[1], fields[0][0].shape[0], fields[0][0].shape[2]).transpose(0, 1)
    with pytest.raises(TypeError):
        K.plane_regularization([[wide] + fields[0][1:], fields[1]], weights)
    with pytest.raises(ValueError):
        K.plane_regularization([fields[0][:5], fields[1]], weights)
    with pytest.raises(ValueError):
        K.plane_regularization(fields, weights[:1])
    short = [t[:2] if i % 6 in K.TIME_PLANES else t for i, t in enumerate(fields[1])]
    with pytest.raises(ValueError):
        K.plane_regularization([fields[0], short], weights)
    odd_m = [t[..., :3].contiguous() for t in fields[1]]
    with pytest.raises(ValueError):
        K.plane_regularization([fields[0], odd_m], weights)
    with pytest.raises(ValueError):
        K.plane_regularization(fields, weights)


def _reg_check(fields, weights, grads):
    """Each plane's kernel gradient equals the plain mirror's bit for bit
    and lies within 1e-6 of its scale of autograd's through the formulas in fp64."""
    g = torch.ones((), device=grads[0].device)
    mirror = K.plane_reg_bwd_plain(fields, weights, g)
    planes = [t for f in fields for t in f]
    fp64 = torch.autograd.grad(_plain_regularization(fields, weights, torch.float64), planes)
    for i, (a, m, r) in enumerate(zip(grads, mirror, fp64)):
        assert torch.equal(a, m), i
        assert float((a.double() - r).abs().max() / r.abs().max()) < 1e-6, i


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(REG_CASES))
def test_regularizer_kernels_equal_the_plain_formulas_on_card(cuda_device, case):
    """Forward: the scalar within 1e-6 relative of the plain formulas summed
    in fp64, bit-equal between two launches (no float atomics). Backward,
    outside `grads_in_place()` (fresh buffers): each plane's gradient as
    `_reg_check` asks. Two launches forward, one backward; the gauge
    `kplanes.reg_entries` holds the planes' entries."""
    fields, weights = _reg_fields(case, seed=47, device=cuda_device, ones=0.1)
    planes = [t for f in fields for t in f]
    K.reset_launches()
    out = K.plane_regularization(fields, weights)
    again = K.plane_regularization(fields, weights)
    expect = float(_plain_regularization(fields, weights, torch.float64).detach())
    assert abs(float(out) - expect) / abs(expect) < 1e-6
    assert torch.equal(out, again)
    grads = torch.autograd.grad(out, planes)
    torch.cuda.synchronize()
    assert K.launches == {"fwd": 0, "bwd": 0, "reg_fwd": 4, "reg_bwd": 1}
    assert profiling.snapshot()["counters"]["kplanes.reg_entries"] == sum(t.numel() for t in planes)
    _reg_check(fields, weights, grads)


@pytest.mark.cuda
def test_time_planes_at_one_take_no_regularizer_gradient_on_card(cuda_device):
    """Time planes at exactly 1.0 (the source's initialisation): their
    smoothness and L1 read 0 and their gradients are exactly 0 (sign 0)."""
    fields, weights = _reg_fields("cell", seed=49, device=cuda_device, ones=1.0)
    planes = [t for f in fields for t in f]
    out = K.plane_regularization(fields, weights)
    spatial = [[t for i, t in enumerate(f) if i % 6 in K.SPATIAL_PLANES] for f in fields]
    from humanrf_torch.models.kplanes import plane_tv

    expect = sum(w[0] * sum(float(plane_tv(t.double())) for t in f) for f, w in zip(spatial, weights))
    assert abs(float(out) - expect) / expect < 1e-6
    grads = torch.autograd.grad(out, planes)
    for f_start, f in zip(np.cumsum([0] + [len(f) for f in fields]), fields):
        for i in range(len(f)):
            assert bool(grads[f_start + i].any()) == (i % 6 in K.SPATIAL_PLANES)


@pytest.mark.cuda
def test_regularizer_backward_in_place_eager_and_captured_on_card(cuda_device, monkeypatch):
    """`torch.autograd.grad` returns fresh gradients and leaves each `.grad`
    as it was; inside `grads_in_place()` the backward adds into each
    `.grad` (held + the plain mirror's gradient, bit for bit); captured as a
    CUDA graph, a replay gives the eager scalar and adds the same again,
    with the capture's 2 + 1 launches."""
    from humanrf_torch.train.graphs import GraphedStep

    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    fields, weights = _reg_fields("cell", seed=51, device=cuda_device, ones=0.1)
    planes = [t for f in fields for t in f]
    cotangent = torch.tensor(0.5, device=cuda_device)
    mirror = K.plane_reg_bwd_plain(fields, weights, cotangent)
    for t in planes:
        t.grad = torch.full_like(t, 7.0)
    fresh = torch.autograd.grad(K.plane_regularization(fields, weights), planes, cotangent)
    for t, a, m in zip(planes, fresh, mirror):
        assert torch.equal(a, m) and bool((t.grad == 7.0).all())

    def body(c):
        with fli.grads_in_place():
            out = K.plane_regularization(fields, weights)
            out.backward(c)
        return out.detach()  # holds no graph, whose leaves' nodes would sync with this call's stream

    eager = body(cotangent).clone()
    for t, m in zip(planes, mirror):
        assert torch.equal(t.grad, torch.full_like(t, 7.0) + m)
    step = GraphedStep("the regularisers", body)
    step(cotangent)  # the eager body again, then the capture, which runs nothing
    held = [t.grad.clone() for t in planes]
    K.reset_launches()
    out = step(cotangent)
    torch.cuda.synchronize()
    assert K.launches == {"fwd": 0, "bwd": 0, "reg_fwd": 2, "reg_bwd": 1}
    assert torch.equal(out, eager)
    for t, h, m in zip(planes, held, mirror):
        assert torch.equal(t.grad, h + m)


# ----------------------------------------------- against the reference, CPU


@pytest.fixture(scope="module")
def tiny_cache(tmp_path_factory):
    """The benchmark's scene cache in a temporary directory for this module."""
    from hrfbench import harness

    mp = pytest.MonkeyPatch()
    mp.setattr(harness, "CACHE_DIR", tmp_path_factory.mktemp("hrfbench-cache"))
    yield
    mp.undo()


def test_query_matches_the_reference():
    """The port's plane query against the reference's explicit bilinear
    gathers (`hrfbench/reference/kplanes.py`), on cell borders and at ±1:
    forward within 1e-6 relative (the two sum a plane's taps in different
    orders, a few ulps apart, and six planes multiply), each plane's
    gradient within 1e-5 of its largest entry (the same fp32 terms summed by
    autograd's scatter in another order)."""
    from hrfbench.reference import kplanes as ref

    planes = _planes(**TINY, seed=21, requires_grad=True)
    twins = [t.detach().clone().requires_grad_() for t in planes]
    q = _border_coords(300, TINY["time_resolution"], TINY["resolution"], seed=22)
    out = K.plane_query(planes, q)
    feats = []
    for s in range(2):
        f = None
        for p, (i, j) in enumerate(K.PLANES):
            v = ref.bilinear(twins[6 * s + p], q[:, i], q[:, j])
            f = v if f is None else f * v
        feats.append(f)
    expect = torch.cat(feats, dim=1)
    assert float(((out - expect).abs() / expect.abs()).max().detach()) < 1e-6
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(23))
    out.backward(g)
    expect.backward(g)
    for a, b in zip(planes, twins):
        assert float((a.grad - b.grad).abs().max() / b.grad.abs().max()) < 1e-5


def test_regularizers_against_hand_computed_values():
    """Plane TV, time smoothness and the time planes' L1 of two tiny scales
    and two proposals, from loops over the entries, each plane's term a mean
    summed over the planes, and their weighted sum in `regularization()`."""
    from humanrf_torch.models.kplanes import KPlanesConfig, KPlanesModel

    cfg = KPlanesConfig(sorted_frame_numbers=(0, 1, 2, 3), feature_dim=2, resolution=3, time_resolution=4,
                        multiscales=(1, 2), proposal_feature_dim=2, proposal_resolutions=(3, 4), plane_tv_weight=2.0,
                        time_smoothness_weight=3.0, l1_time_planes_weight=5.0, proposal_plane_tv_weight=7.0,
                        proposal_time_smoothness_weight=11.0, proposal_l1_time_planes_weight=13.0)
    model = KPlanesModel(cfg)
    gen = torch.Generator().manual_seed(31)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=gen))

    def by_hand(field):
        tv = smooth = l1 = 0.0
        for scale in field.scales:
            a, b, c = one_scale(scale)
            tv, smooth, l1 = tv + a, smooth + b, l1 + c
        return tv, smooth, l1

    def one_scale(scale):
        tv = smooth = l1 = 0.0
        for name in ("xy", "xz", "yz"):
            a = scale[name].detach().double().numpy()
            h, w, m = a.shape
            rows = sum((a[r + 1, c, k] - a[r, c, k]) ** 2 for r in range(h - 1) for c in range(w) for k in range(m))
            cols = sum((a[r, c + 1, k] - a[r, c, k]) ** 2 for r in range(h) for c in range(w - 1) for k in range(m))
            tv += 2 * (rows / ((h - 1) * w * m) + cols / (h * (w - 1) * m))
        for name in ("xt", "yt", "zt"):
            a = scale[name].detach().double().numpy()
            h, w, m = a.shape
            sq = [(a[r + 2, c, k] - 2 * a[r + 1, c, k] + a[r, c, k]) ** 2
                  for r in range(h - 2) for c in range(w) for k in range(m)]
            smooth += sum(sq) / len(sq)
            l1 += np.abs(1 - a).mean()
        return tv, smooth, l1

    tv, smooth, l1 = by_hand(model.field)
    ptv, psmooth, pl1 = (sum(x) for x in zip(*(by_hand(p.field) for p in model.proposals)))
    total = 2 * tv + 3 * smooth + 5 * l1 + 7 * ptv + 11 * psmooth + 13 * pl1
    with torch.no_grad():
        for a, b in zip(model.field.regularizers(), (tv, smooth, l1)):
            assert float(a) == pytest.approx(b, rel=1e-5)
        assert float(model.regularization()) == pytest.approx(total, rel=1e-5)


def test_three_train_steps_match_the_reference(tiny_cache):
    """The port's training loop at a tiny size, through its normal path (the
    benchmark's driver: flags, `run.build_model`, the loader, `Trainer`, the
    eager step on the CPU), against the reference's three steps from the same
    weights: the loss within 1e-6 relative, step 1's gradient within 2e-5
    of each leaf's norm (the plain query's scatter-adds and autograd's sum
    the same fp32 terms in other orders), the median leaf's change within
    1e-6 (Adam's normalised step keeps the rounding of the gradient)."""
    from hrfbench.drivers import train_loop_kplanes
    from hrfbench.tests import hrfbench_tiny
    from hrfbench.tests.test_hrfbench_kplanes import _context, tiny_conf

    torch.manual_seed(0)
    record = train_loop_kplanes.run(_context(tiny_conf(), seed=2**31 + 2021))
    numbers = record["numbers"]
    assert numbers["feed_mismatches"] == 0
    assert numbers["loss_gap"] < 1e-6 and numbers["grad_gap"] < 2e-5 and numbers["median_update_gap"] < 1e-6, numbers
    assert record["attempted"] > 0 and record["failed"] == 0
    assert hrfbench_tiny.SCENE["num_frames"] == 4


@pytest.mark.parametrize("config,mid", [("r4-proposal", 0), ("r4-proposal", 8), ("paper-dense", 0)],
                         ids=["cp-one-level", "cp-two-level", "dense"])
def test_the_pipeline_is_bit_equal_to_before(config, mid, tiny_cache, tmp_path):
    """The port's train step, which now asks `proposal_density` for each
    level's field, gates the photometric loss and adds a model's
    regularisation where it has one, against the benchmark's frozen copy of
    the step before those changes (`hrfbench/reference/pipeline.py`), both
    over the same HumanRF model and inputs at a tiny size: losses,
    gradients and parameters bit for bit over two steps, for the CP proposal
    at one and two levels and the dense sampler."""
    import copy

    from hrfbench.drivers import train_loop
    from hrfbench.reference import pipeline as frozen
    from hrfbench.tests import hrfbench_tiny
    from humanrf_torch.train.pipeline import make_train_step
    from humanrf_torch.train.trainer import make_optimizer
    from humanrf_torch.utils.rngs import make_key

    conf = hrfbench_tiny.train_conf(config)
    if mid:
        hrfbench_tiny._set(conf["flags"], "--tpu.proposal_mid_samples_per_ray", str(mid))
    trainer, loader = train_loop.build(hrfbench_tiny.context(conf, "train_loop", seed=77), tmp_path)
    try:
        model, pcfg = trainer.model, trainer.pcfg
        twin = copy.deepcopy(model)
        twin.work_log = None  # the frozen step's hook for the reference's work counts
        width, height = trainer.resolution
        opt = lambda m: make_optimizer(m.named_parameters(), lr=1e-2, lr_decay=0.5, max_steps=1000,  # noqa: E731
                                       weight_decay=0.03)
        step = make_train_step(pcfg, model, opt(model), width, height, graph=False)
        fields = {k: v for k, v in dataclasses.asdict(pcfg).items() if k != "photometric"}
        before = frozen.make_train_step(frozen.PipelineConfig(**fields), twin, opt(twin), width, height)
        it = iter(loader)
        for i in range(2):
            batch, pool, grids, _ = next(it)
            key = make_key(1000 + i)
            loss, _ = step(batch, pool, grids, loader.device_aabb, key)
            loss_before, _ = before(batch, pool, grids, loader.device_aabb, key)
            assert torch.equal(loss, loss_before), i
            for (name, a), b in zip(model.named_parameters(), twin.parameters()):
                assert torch.equal(a.grad, b.grad) and torch.equal(a, b), (i, name)
    finally:
        loader.shutdown()


def test_tiny_cli_trains_saves_resumes_and_renders(tmp_path):
    """`python -m humanrf_torch.run --model.representation kplanes` at a tiny
    size: trains through `Trainer`, validates, saves, resumes from the
    latest checkpoint at its step, and renders the evaluation frames."""
    from humanrf_torch.core.synthetic import SyntheticSceneConfig, generate_synthetic_dataset
    from humanrf_torch.run import main

    generate_synthetic_dataset(tmp_path, SyntheticSceneConfig(num_cameras=6, width=40, height=40, num_frames=2,
                                                              grid_resolution=32))
    ws = tmp_path / "ws"
    flags = ["--config", "example_synthetic", "--dataset.path", str(tmp_path), "--workspace", str(ws),
             "--device", "cpu", "--dataset.deterministic_loader", "true", "--training.rays_initial_batch_size", "128",
             "--validation.every_n_steps", "10", "--training.save_checkpoint_every_n_steps", "10",
             "--model.representation", "kplanes", "--model.temporal_partitioning", "none", "--tpu.sampling",
             "proposal", "--tpu.proposal_samples_per_ray", "16", "--tpu.proposal_mid_samples_per_ray", "8",
             "--tpu.render_samples_per_ray", "16", "--model.kplanes_feature_dim", "4", "--model.kplanes_resolution",
             "8", "--model.kplanes_time_resolution", "5", "--model.kplanes_multiscales", "1", "2",
             "--model.kplanes_proposal_feature_dim", "4", "--model.kplanes_proposal_resolutions", "8", "16",
             "--training.photometric", "mse", "--training.bce_loss_weight", "0"]
    first = main([*flags, "--training.max_steps", "20", "--evaluate", "false"])
    assert first["train"]["end_step"] == 21  # the loop runs to max_steps + 1, as the JAX CLI does
    assert (ws / "checkpoints" / "step_00000020.ckpt").exists() and (ws / "checkpoints" / "best.ckpt").exists()
    assert 'representation: "kplanes"' in (ws / "config.yaml").read_text()
    resumed = main([*flags, "--training.max_steps", "25", "--training.checkpoint", "latest", "--evaluate", "true",
                    "--evaluation.frame_numbers", "0"])
    assert (resumed["train"]["start_step"], resumed["train"]["end_step"]) == (20, 26)
    assert resumed["averages"]["PSNR"] > 10
    assert len(list((ws / "results" / "test_frames").glob("*.png"))) == 1
    with pytest.raises(ValueError):
        main([*flags, "--tpu.proposal_mid_samples_per_ray", "0", "--training.max_steps", "1"])


def test_the_model_reports_its_planes_and_served_samples(monkeypatch):
    """The gauge `field.plane_params` at build, and the device counters
    `kplanes.field_samples` / `kplanes.proposal_samples` from the
    differentiated queries only (a render's take no gradient)."""
    from humanrf_torch.models.kplanes import KPlanesConfig, KPlanesModel

    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    cfg = KPlanesConfig(sorted_frame_numbers=(0, 1, 2), feature_dim=4, resolution=8, time_resolution=5,
                        multiscales=(1, 2), proposal_feature_dim=4, proposal_resolutions=(8, 16))
    model = KPlanesModel(cfg)
    model.init_parameters(torch.Generator().manual_seed(1))
    planes = sum(t.numel() for f in (model.field, *(p.field for p in model.proposals)) for t in f.planes())
    assert profiling.snapshot()["counters"]["field.plane_params"] == planes
    x, frames = torch.rand(50, 3) - 0.5, torch.tensor([0, 1, 2] * 16 + [0, 1])
    model.proposal_density(x, frames, 1).sum().backward()
    model(x, torch.randn(50, 3), frames, n_valid=torch.tensor([30], dtype=torch.int32))[0].sum().backward()
    with torch.no_grad():
        model.proposal_density(x, frames, 0)
        model(x, torch.randn(50, 3), frames)
    counters = profiling.snapshot()["counters"]
    assert (counters["kplanes.proposal_samples"], counters["kplanes.field_samples"]) == (50, 30)
