"""The port's `field_interp` (humanrf_torch/ops/field_interp.py): the field's
lookups with their corner math, against the JAX package's corner functions
(humanrf_tpu/models/fused_field.py) followed by its oracle
`fused_interp_reference` (humanrf_tpu/ops/fused_interp.py), forward and
`jax.grad` backward.

`field_interp` is plain PyTorch on every device; the field query built on it
has CUDA kernels (humanrf_torch/csrc/field_interp.cu), which the
`cuda`-marked tests hold to its plain version, on the card only.
"""
from pathlib import Path
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


@pytest.mark.parametrize("fn", ["field_interp", "field_query"])
def test_cpu_tensors_never_touch_the_cuda_library(fn):
    spec, tables, xyzt, _, _ = _case("vector", n=200)
    t = torch.tensor(tables, requires_grad=True)
    with mock.patch.object(fli, "load_library", side_effect=AssertionError("CUDA library loaded")):
        if fn == "field_interp":
            fli.field_interp(t, torch.tensor(xyzt), spec).sum().backward()
        else:
            cfg = THashGridConfig(**GRID)
            grids = tuple(torch.tensor(_tables(cfg.n_levels, 2, cfg.table_size, seed=2 + g), requires_grad=True)
                          for g in range(4))
            field = fli.SegmentField(grids, t, fli.grid_spec(cfg))
            fli.field_query([field], torch.tensor(xyzt)).sum().backward()
            assert all(g.grad is not None for g in grids)
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
    # A copy through its bytes reads back the same.
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


# (grid config, T, R, N) of a one-segment field query: small and ragged N, a
# table size that is not a power of two (its dense levels' corners then
# leave the table), the r4 width and T = 2^19; the grid cases at small R,
# the vector cases with a ragged or non-power-of-two R and at the r4 width.
CARD_CASES = {
    "grid-small-ragged": (GRID, 1 << 13, 128, 1001),
    "grid-odd-T": (GRID, 3001, 128, 4099),
    "grid-r4": (R4, 1 << 11, 2048, 65_539),
    "grid-capacity": (CAPACITY, 1 << 19, 2048, 32_768),
    "vector-small-ragged": (GRID, 1 << 13, 128, 777),
    "vector-odd-R": (GRID, 1 << 13, 1000, 4099),
    "vector-r4": (R4, 1 << 11, 2048, 65_536),
}


def _card_inputs(name, device):
    """→ (the fields, xyzt, the features' cotangent) of one of CARD_CASES."""
    grid, T, R, N = CARD_CASES[name]
    cfg = THashGridConfig(**grid)
    L, F = cfg.n_levels, cfg.n_features_per_level
    grids = tuple(torch.tensor(_tables(L, F, T, seed=1 + g), device=device) for g in range(4))
    vectors = torch.tensor(_tables(4, L * F, R, seed=5), device=device)
    xyzt = torch.tensor(_xyzt(N, far=True), device=device)
    g = torch.tensor(np.random.default_rng(2).normal(size=(N, L * F)).astype(np.float32), device=device)
    return [fli.SegmentField(grids, vectors, fli.grid_spec(cfg))], xyzt, g


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_forward_kernel_matches_plain_on_card(cuda_device, name):
    """The field query's forward kernel, one launch, against its plain
    version: both compute the corners with the same fp32 roundings and sum
    them in the same order without fma, so bit for bit."""
    fields, xyzt, _ = _card_inputs(name, cuda_device)
    before = fli.launches["fwd"]
    out = fli.field_query(fields, xyzt)
    ref = fli.field_query_plain(fields, xyzt)
    torch.cuda.synchronize()
    assert fli.launches["fwd"] == before + 1
    assert torch.equal(out, ref) and ref.abs().max() > 0.1


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CARD_CASES))
def test_backward_kernel_matches_plain_on_card(cuda_device, name):
    """The field query's backward kernel, one launch, against its plain
    version summed in fp64 (the same fp32 weights and lookups): the
    kernel's atomics add in a run-dependent order, and an entry sums up to a
    few thousand terms here; its fp32 sums stay within 1e-5 of the scale of
    every table's and vector's gradient."""
    fields, xyzt, g = _card_inputs(name, cuda_device)
    tensors = [t.clone().requires_grad_() for t in fli._flat(fields)]
    before = fli.launches["bwd"]
    fli.field_query(fli._unflat([(f.spec, len(f.grids)) for f in fields], tensors), xyzt).backward(g)
    refs = fli.field_query_bwd_plain(fields, xyzt, g.double())
    torch.cuda.synchronize()
    assert fli.launches["bwd"] == before + 1
    for t, r in zip(tensors, refs):
        assert float((t.grad.double() - r).abs().max() / r.abs().max()) < 1e-5


# ------------------------------------------------------- the field query

# The main path's two fields, each over two 25-frame segments with R = 2048
# vectors: the paper's dense L16/F2 (T = 2^17 a segment; levels 0-3 dense)
# and the r4 L8/F4 (T = 2^11; every level hashed). N is the dense render
# budget and the r4 step's fine samples.
QUERY_FIELDS = {
    "dense": (dict(n_levels=16, n_features_per_level=2, log2_hashmap_size=17, base_resolution=32,
                   finest_resolution=2048), 640_000),
    "r4": (dict(n_levels=8, n_features_per_level=4, log2_hashmap_size=11, base_resolution=32,
                finest_resolution=2048), 131_072),
}


def _query_inputs(name, device):
    """Two segments' fields (tables ±1 so that no product underflows), N
    samples on rays of 64 consecutive samples 4e-4 apart (runs share their
    coarse corners, as the samplers' are), a segment id per ray (-1 on one
    ray in eight: a frame of no segment) and `n_valid` at 70% of N."""
    grid, n = QUERY_FIELDS[name]
    cfg = THashGridConfig(**grid)
    rng = np.random.default_rng(5)
    L, F, T, R = cfg.n_levels, cfg.n_features_per_level, cfg.table_size, 2048
    fields = [fli.SegmentField(tuple(torch.tensor(rng.uniform(-1, 1, (L, F, T)).astype(np.float32), device=device)
                                     for _ in range(4)),
                               torch.tensor(rng.uniform(-1, 1, (4, L * F, R)).astype(np.float32), device=device),
                               fli.grid_spec(cfg)) for _ in range(2)]
    rays = n // 64
    origin = rng.uniform(0.1, 0.9, (rays, 1, 4))
    direction = rng.normal(size=(rays, 1, 4)) * np.array([1, 1, 1, 0])
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    xyzt = (origin + direction * 4e-4 * np.arange(64)[None, :, None]).reshape(n, 4).astype(np.float32)
    seg = np.repeat(rng.integers(0, 2, rays), 64).astype(np.int32)
    seg[np.repeat(rng.uniform(size=rays) < 0.125, 64)] = -1
    grad = torch.tensor(rng.normal(size=(n, L * F)).astype(np.float32), device=device)
    return (fields, torch.tensor(xyzt, device=device), torch.tensor([int(0.7 * n)], dtype=torch.int32, device=device),
            torch.tensor(seg, device=device), grad)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(QUERY_FIELDS))
def test_query_kernels_match_plain_on_card(cuda_device, name):
    """The field query's forward kernel against its plain version,
    `field_query_plain` (per segment the plain per-pair lookups, then
    PyTorch's segment sum and composition): bit for bit, and one launch,
    whose allocations stay under twice its (N, L·F) output (no (4, L·F, N)
    lookup). Its backward, one launch beside its forward's, against the
    plain version summed in fp64: every table's and vector's gradient within
    1e-5 of its scale (atomics add in a run-dependent order)."""
    fields, xyzt, n_valid, seg, grad = _query_inputs(name, cuda_device)
    before = dict(fli.launches)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda_device)
    torch.cuda.reset_peak_memory_stats(cuda_device)
    out = fli.field_query(fields, xyzt, n_valid, seg)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated(cuda_device) - base < 2 * out.numel() * 4
    assert fli.launches == dict(before, fwd=before["fwd"] + 1)
    ref = fli.field_query_plain(fields, xyzt, n_valid, seg)
    assert torch.equal(out, ref) and torch.equal(out.view(torch.int32), ref.view(torch.int32))
    live = torch.arange(xyzt.shape[0], device=cuda_device) < n_valid
    assert ref[live & (seg >= 0)].abs().max() > 0.1 and not out[~live | (seg < 0)].any()

    tensors = [t.clone().requires_grad_() for t in fli._flat(fields)]
    layout = [(f.spec, len(f.grids)) for f in fields]
    before = dict(fli.launches)
    fli.field_query(fli._unflat(layout, tensors), xyzt, n_valid, seg).backward(grad)
    torch.cuda.synchronize()
    assert fli.launches == dict(before, fwd=before["fwd"] + 1, bwd=before["bwd"] + 1)
    refs = fli.field_query_bwd_plain(fields, xyzt, grad.double(), n_valid, seg)
    for t, r in zip(tensors, refs):
        assert float((t.grad.double() - r).abs().max() / r.abs().max()) < 1e-5


@pytest.mark.cuda
def test_query_kernels_take_167_segments_on_card(cuda_device):
    """1000 frames cut at the ladder's smallest size: 167 segments of the
    paper's L16/F2 levels, their tables of 2^9..2^12 entries in turn, over
    N = 32,768 samples on rays of 64 (a segment per ray, -1 on one ray in
    eight): the forward kernel equals its plain version (`field_query_plain`)
    bit for bit, and the backward holds to the plain version in fp64 within
    1e-5 of each gradient's scale, as at two segments."""
    rng = np.random.default_rng(167)
    fields = []
    for s in range(167):
        cfg = THashGridConfig(n_levels=16, n_features_per_level=2, log2_hashmap_size=9 + s % 4, base_resolution=32,
                              finest_resolution=2048)
        fields.append(fli.SegmentField(
            tuple(torch.tensor(rng.uniform(-1, 1, (16, 2, cfg.table_size)).astype(np.float32), device=cuda_device)
                  for _ in range(4)),
            torch.tensor(rng.uniform(-1, 1, (4, 32, 2048)).astype(np.float32), device=cuda_device), fli.grid_spec(cfg)))
    n = 32_768
    rays = n // 64
    origin = rng.uniform(0.1, 0.9, (rays, 1, 4))
    direction = rng.normal(size=(rays, 1, 4)) * np.array([1, 1, 1, 0])
    direction /= np.linalg.norm(direction, axis=-1, keepdims=True)
    xyzt = torch.tensor((origin + direction * 4e-4 * np.arange(64)[None, :, None]).reshape(n, 4).astype(np.float32),
                        device=cuda_device)
    seg = np.repeat(rng.integers(0, 167, rays), 64).astype(np.int32)
    seg[np.repeat(rng.uniform(size=rays) < 0.125, 64)] = -1
    seg = torch.tensor(seg, device=cuda_device)
    n_valid = torch.tensor([int(0.9 * n)], dtype=torch.int32, device=cuda_device)
    out = fli.field_query(fields, xyzt, n_valid, seg)
    ref = fli.field_query_plain(fields, xyzt, n_valid, seg)
    torch.cuda.synchronize()
    assert torch.equal(out, ref) and ref.abs().max() > 0.1
    tensors = [t.clone().requires_grad_() for t in fli._flat(fields)]
    grad = torch.tensor(rng.normal(size=(n, 32)).astype(np.float32), device=cuda_device)
    fli.field_query(fli._unflat([(f.spec, len(f.grids)) for f in fields], tensors), xyzt, n_valid, seg).backward(grad)
    refs = fli.field_query_bwd_plain(fields, xyzt, grad.double(), n_valid, seg)
    torch.cuda.synchronize()
    served = set(seg[:int(n_valid)].tolist()) - {-1}
    assert len(served) > 100
    for i, (t, r) in enumerate(zip(tensors, refs)):
        if i // 5 in served:
            assert float((t.grad.double() - r).abs().max() / r.abs().max()) < 1e-5, i
        else:
            assert not t.grad.any() and not r.any(), i


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["dense", "proposal"])
def test_graphed_step_launches_one_query_kernel_each_way_on_card(cuda_device, sampling):
    """A two-segment model at the main path's widths (dense: the paper's
    L16/F2, log2 T 19; proposal: r4's L8/F4, log2 T 13) trained through its
    captured step on the baked pool: every step, the eager first one and the
    replays, launches one forward kernel per field query, the dense step's
    prune and render passes and the proposal step's render pass, and one
    backward for the render pass."""
    from humanrf_torch.models.humanrf import HumanRFConfig, HumanRFModel
    from humanrf_torch.train.pipeline import PipelineConfig, make_train_step
    from humanrf_torch.train.trainer import make_optimizer, sample_batch
    from humanrf_torch.utils.rngs import fold_in, make_key
    from humanrf_torch.view_inputs import load_train_inputs

    inputs = load_train_inputs(Path(__file__).resolve().parent.parent / "runs_evidence" / "r4_full_schedule_748"
                               / "torch_train_inputs.npz", cuda_device)
    width = dict(n_levels=16, n_features_per_level=2, log2_hashmap_size=19) if sampling == "dense" else dict(
        n_levels=8, n_features_per_level=4, log2_hashmap_size=13, proposal_rank=32)
    model = HumanRFModel(HumanRFConfig(sorted_frame_numbers=tuple(range(50)), segment_sizes=(25, 25),
                                       camera_embedding_dim=2, **width))
    model.init_parameters(torch.Generator().manual_seed(0))
    model = model.to(cuda_device)
    extra = (dict(samples_per_ray=1024, candidate_budget=160_000, sample_budget=80_000) if sampling == "dense"
             else dict(proposal_samples_per_ray=32, render_samples_per_ray=16))
    cfg = PipelineConfig(sampling=sampling, num_rays=1024, candidate_rays_factor=2, **extra)
    optimizer = make_optimizer(model.named_parameters(), 1e-2, 0.5, 50_001, 0.03)
    step = make_train_step(cfg, model, optimizer, inputs.width, inputs.height, graph=True)
    generator = torch.Generator(cuda_device).manual_seed(1)
    expected = {"fwd": 2 if sampling == "dense" else 1, "bwd": 1}
    for i in range(4):
        before = dict(fli.launches)
        loss, _ = step(sample_batch(cfg, inputs.pixel_rgba, generator), inputs.pool, inputs.grids, inputs.aabb,
                       fold_in(make_key(0, cuda_device), torch.tensor(i, device=cuda_device)))
        assert {d: fli.launches[d] - before[d] for d in before} == expected, i
        assert torch.isfinite(loss)
