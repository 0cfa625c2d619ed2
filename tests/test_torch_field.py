"""The port's field (humanrf_torch/models) against the JAX package's
(humanrf_tpu/models): corner indices and weights, the 4D decomposition, SH,
the MLPs, truncated_exp and the proposal field. Inputs come from numpy seeds
and go to both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanrf_torch.models import fused_field as t_ff
from humanrf_torch.models.activation import truncated_exp as t_truncated_exp
from humanrf_torch.models.decomposition4d import Decomposition4DConfig as TDecompConfig
from humanrf_torch.models.hash_encoding import HashGridConfig as THashGridConfig
from humanrf_torch.models.mlp import apply_mlp as t_apply_mlp
from humanrf_torch.models.proposal import ProposalFieldConfig as TProposalConfig
from humanrf_torch.models.proposal import apply_proposal_field as t_apply_proposal
from humanrf_torch.models.sh import sh_encode as t_sh_encode
from humanrf_tpu.models import fused_field as j_ff
from humanrf_tpu.models.activation import truncated_exp as j_truncated_exp
from humanrf_tpu.models.decomposition4d import Decomposition4DConfig, apply_decomposition4d, init_decomposition4d
from humanrf_tpu.models.hash_encoding import HashGridConfig
from humanrf_tpu.models.mlp import apply_mlp as j_apply_mlp
from humanrf_tpu.models.mlp import init_mlp
from humanrf_tpu.models.proposal import ProposalFieldConfig, apply_proposal_field, init_proposal_field
from humanrf_tpu.models.sh import sh_encode as j_sh_encode

torch.set_num_threads(2)

# Levels at resolutions 4, 8, 16, 32 against T = 2^13: the first three index
# densely (res³ + res² + res < T, so no corner leaves the table; the JAX gather
# backend would read NaN there), the last one hashes.
GRID = dict(n_levels=4, n_features_per_level=2, log2_hashmap_size=13, base_resolution=4, finest_resolution=32)


def _np(x):
    return np.asarray(x)


def _points(n, d, seed=0):
    return np.random.default_rng(seed).uniform(0, 1, (n, d)).astype(np.float32)


def test_grid_corner_idx_w_matches_jax_on_dense_and_hashed_levels():
    cfg = THashGridConfig(**GRID)
    res = cfg.level_resolutions()
    dense = res**3 <= cfg.table_size
    assert dense.any() and not dense.all()
    assert all(r**3 + r**2 + r < cfg.table_size for r in res[dense])
    pts = _points(1000, 3)
    # Points on the cube's faces and corners reach the last cell of a level.
    pts[:8] = np.array([[(c >> d) & 1 for d in range(3)] for c in range(8)], dtype=np.float32)
    ji, jw = j_ff._grid_corner_idx_w(jnp.asarray(pts), cfg.level_scales(), res, cfg.table_size)
    ti, tw = t_ff._grid_corner_idx_w(torch.tensor(pts), cfg.level_scales(), res, cfg.table_size)
    # The hash is uint32 arithmetic and must agree bit for bit; the weights are
    # the same fp32 products in the same order (1e-6 absolute, weights ≤ 1).
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    np.testing.assert_allclose(tw.numpy(), _np(jw), rtol=0, atol=1e-6)


def test_vector_idx_w_matches_jax():
    coords = _points(1000, 4, seed=1)
    coords[:2] = [[0, 0, 0, 0], [1, 1, 1, 1]]  # both clamped ends
    ji, jw = j_ff._vector_idx_w(jnp.asarray(coords), 128)
    ti, tw = t_ff._vector_idx_w(torch.tensor(coords), 128)
    np.testing.assert_array_equal(ti.numpy(), _np(ji))
    np.testing.assert_allclose(tw.numpy(), _np(jw), rtol=0, atol=1e-6)


def _decomposition_params(grid, vectors_res, seed=0):
    """JAX-initialized params, with the hash tables scaled up from their
    ±1e-4 init so the comparison is not against near-zero features."""
    cfg = Decomposition4DConfig(grid=grid, vectors_finest_resolution=vectors_res)
    params = init_decomposition4d(jax.random.PRNGKey(seed), cfg)
    params = {k: np.asarray(v) * (1e4 if k != "vectors" else 1.0) for k, v in params.items()}
    return params


# The benchmark's cells' grids at one segment's table size (BENCHMARK.json):
# paper-dense's L16/F2 at T = 2^17, r4-proposal's L8/F4 at T = 2^11 and
# paper-1000f's L16/F2 at T = 2^18, each at vector resolution 2048.
CELL_GRIDS = {
    "paper-dense": (dict(n_levels=16, n_features_per_level=2, log2_hashmap_size=17, base_resolution=32,
                         finest_resolution=2048), 2048),
    "r4-proposal": (dict(n_levels=8, n_features_per_level=4, log2_hashmap_size=11, base_resolution=32,
                         finest_resolution=2048), 2048),
    "paper-1000f": (dict(n_levels=16, n_features_per_level=2, log2_hashmap_size=18, base_resolution=32,
                         finest_resolution=2048), 2048),
}


@pytest.mark.parametrize("name", ["grid", *CELL_GRIDS])
def test_decomposition_matches_jax_gather_backend(name):
    """Gather backend: fp32 lookups, the vectors lerped as v0 + f·(v1 − v0)
    where the port weights both taps; 1e-5 absolute on O(1) features. At
    every configuration here no dense level's corner leaves the table (the
    gather backend would read NaN there)."""
    spec, vectors_res, n = (GRID, 128, 512) if name == "grid" else (*CELL_GRIDS[name], 256)
    grid = HashGridConfig(**spec)
    res = grid.level_resolutions()
    assert all(r**3 + r**2 + r < grid.table_size for r in res[res**3 <= grid.table_size])
    params = _decomposition_params(grid, vectors_res)
    xyz, times = _points(n, 3, seed=2), _points(n, 1, seed=3)
    ref = _np(apply_decomposition4d(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(xyz), jnp.asarray(times),
        Decomposition4DConfig(grid=grid, vectors_finest_resolution=vectors_res, backend="gather"),
    ))
    out = t_ff.apply_decomposition4d_fused(
        {k: torch.tensor(v) for k, v in params.items()}, torch.tensor(xyz), torch.tensor(times),
        TDecompConfig(grid=THashGridConfig(**spec), vectors_finest_resolution=vectors_res),
    ).numpy()
    assert np.abs(ref).max() > 0.1
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_decomposition_dense_corner_past_table_matches_jax_fused_backend():
    """A dense level whose far corners index past the table (res = 8,
    T = 2^9 < 8³ + 8² + 8): the Pallas kernel's one-hot rows give such a
    corner no weight, and so does the port. The kernel is bf16 on the MXU:
    3e-2 of the scale, the bound tests/test_fused_interp.py holds it to."""
    spec = dict(n_levels=2, n_features_per_level=2, log2_hashmap_size=9, base_resolution=8, finest_resolution=16)
    grid = HashGridConfig(**spec)
    assert 8**3 <= grid.table_size < 8**3 + 8**2 + 8 and grid.level_resolutions()[0] == 8
    params = _decomposition_params(grid, 128, seed=1)
    xyz, times = _points(384, 3, seed=4), _points(384, 1, seed=5)
    xyz[:64] = 0.95 + 0.05 * xyz[:64]  # the far cells, where corners overflow
    ref = _np(apply_decomposition4d(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(xyz), jnp.asarray(times),
        Decomposition4DConfig(grid=grid, vectors_finest_resolution=128, backend="fused",
                              fused_tile_n=128, fused_interpret=True),
    ))
    out = t_ff.apply_decomposition4d_fused(
        {k: torch.tensor(v) for k, v in params.items()}, torch.tensor(xyz), torch.tensor(times),
        TDecompConfig(grid=THashGridConfig(**spec), vectors_finest_resolution=128),
    ).numpy()
    assert np.max(np.abs(out - ref)) / np.max(np.abs(ref)) < 3e-2


def test_sh_encode_matches_jax():
    """The same fp32 polynomials; 1e-6 absolute on values ≤ ~1."""
    d = np.random.default_rng(6).normal(size=(500, 3)).astype(np.float32)
    dirs01 = (d / np.linalg.norm(d, axis=-1, keepdims=True) + 1.0) * 0.5
    for degree in (1, 2, 3, 4):
        ref = _np(j_sh_encode(jnp.asarray(dirs01), degree))
        out = t_sh_encode(torch.tensor(dirs01), degree).numpy()
        np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("activation", [None, "sigmoid"])
def test_apply_mlp_matches_jax(activation):
    """bf16 inputs, weights and per-layer outputs with fp32 accumulation on
    both sides; the accumulation order differs, which a bf16 rounding can
    amplify to one bf16 step: 1e-2 relative to the output scale."""
    params = {k: np.asarray(v) for k, v in init_mlp(jax.random.PRNGKey(0), 32, 16, 64, 2).items()}
    x = np.random.default_rng(7).normal(size=(300, 32)).astype(np.float32)
    ref = _np(j_apply_mlp({k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x), activation))
    out = t_apply_mlp({k: torch.tensor(v) for k, v in params.items()}, torch.tensor(x), activation)
    assert out.dtype == torch.float32
    assert np.max(np.abs(out.numpy() - ref)) <= 1e-2 * np.max(np.abs(ref))


def test_truncated_exp_matches_jax():
    """exp(min(x, 16)) in fp32 on both sides."""
    x = np.linspace(-30, 40, 1001).astype(np.float32)
    np.testing.assert_allclose(t_truncated_exp(torch.tensor(x)).numpy(), _np(j_truncated_exp(jnp.asarray(x))), rtol=1e-6)


def test_proposal_field_matches_jax():
    """The port's by-index lerp rounds weights and factors to bf16 and sums in
    fp32, as the JAX one-hot bf16 product does; only the fp32 reduction over
    the rank differs: 1e-5 relative."""
    cfg = ProposalFieldConfig(resolution=32, rank=8)
    params = {"factors": np.asarray(init_proposal_field(jax.random.PRNGKey(1), cfg)["factors"])}
    coords = _points(600, 4, seed=8)
    coords[:2] = [[0, 0, 0, 0], [1, 1, 1, 1]]  # both taps clamp to one index
    ref = _np(apply_proposal_field({"factors": jnp.asarray(params["factors"])}, jnp.asarray(coords), cfg))
    out = t_apply_proposal(
        {"factors": torch.tensor(params["factors"])}, torch.tensor(coords), TProposalConfig(resolution=32, rank=8)
    ).numpy()
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=0)


# ------------------------------------------------------- the field query

from humanrf_torch.ops import field_interp as fli  # noqa: E402

# Two adaptive segments: T = 2^9 (its dense level's far corners leave the
# table) and T = 2^11, both over the same levels.
_QUERY_GRIDS = (dict(n_levels=3, n_features_per_level=2, log2_hashmap_size=9, base_resolution=8, finest_resolution=64),
                dict(n_levels=3, n_features_per_level=2, log2_hashmap_size=11, base_resolution=8, finest_resolution=64))


def _query_fields(segments, seed=0):
    """`segments` fields, their grids alternating between `_QUERY_GRIDS`."""
    rng = np.random.default_rng(seed)
    fields = []
    for grid in (_QUERY_GRIDS[s % 2] for s in range(segments)):
        cfg = THashGridConfig(**grid)
        L, F, T = cfg.n_levels, cfg.n_features_per_level, cfg.table_size
        grids = tuple(torch.tensor(rng.normal(size=(L, F, T)).astype(np.float32)) for _ in range(4))
        fields.append(fli.SegmentField(grids, torch.tensor(rng.normal(size=(4, L * F, 64)).astype(np.float32)),
                                       fli.grid_spec(cfg)))
    return fields


def _query_skips(n, segments, skips, seed=1):
    """`n_valid` at 70% of n and/or a segment id per sample, with -1 (a
    frame of no segment) among them."""
    rng = np.random.default_rng(seed)
    xyzt = torch.tensor(rng.uniform(-0.05, 1.05, (n, 4)).astype(np.float32))
    n_valid = torch.tensor([int(0.7 * n)], dtype=torch.int32) if "n_valid" in skips else None
    seg = torch.tensor(rng.integers(-1, segments, n).astype(np.int32)) if "seg" in skips else None
    return xyzt, n_valid, seg


def _present_query(fields, xyzt, n_valid, seg):
    """The model's query before the field query kernels: per segment its
    grids concatenated, a grid and a vector `field_interp` call, the sum
    over segments, then f_xyz⊙v_t + f_xyt⊙v_z + f_yzt⊙v_x + f_xzt⊙v_y."""
    grid = vectors = None
    for s, field in enumerate(fields):
        f = fli.field_interp(torch.cat(field.grids), xyzt, field.spec, n_valid, seg, s).reshape(4, -1, xyzt.shape[0])
        v = fli.field_interp(field.vectors, xyzt, fli.VECTOR_SPEC, n_valid, seg, s)
        grid, vectors = (f, v) if grid is None else (grid + f, vectors + v)
    out = grid[0] * vectors[3]
    for g, p in ((1, 2), (2, 0), (3, 1)):
        out = out + grid[g] * vectors[p]
    return out.T


def _with_grad(fields):
    """The fields' tables as fresh leaves, and the fields over them."""
    leaves = [t.clone().requires_grad_() for t in fli._flat(fields)]
    return leaves, fli._unflat([(f.spec, len(f.grids)) for f in fields], leaves)


# The last: paper-1000f's 20 segments (BENCHMARK.json).
_QUERY_CASES = [(1, ("n_valid",)), (1, ("seg",)), (2, ("seg",)), (2, ("n_valid", "seg")), (20, ("n_valid", "seg"))]
_QUERY_IDS = ["1-n_valid", "1-seg", "2-seg", "2-both", "20-both"]


@pytest.mark.parametrize("segments,skips", _QUERY_CASES, ids=_QUERY_IDS)
def test_field_query_equals_the_present_composition(segments, skips):
    """`field_query` on CPU tensors (its plain version) against the model's
    query as it was: the features bit for bit, a sample past `n_valid` or of
    no segment exactly 0, and every table's and vector's gradient bit for
    bit."""
    fields = _query_fields(segments)
    xyzt, n_valid, seg = _query_skips(600, segments, skips)
    leaves, query_fields = _with_grad(fields)
    out = fli.field_query(query_fields, xyzt, n_valid, seg)
    ref_leaves, ref_fields = _with_grad(fields)
    ref = _present_query(ref_fields, xyzt, n_valid, seg)
    assert torch.equal(out, ref) and torch.equal(out.view(torch.int32), ref.view(torch.int32))
    dead = torch.zeros(600, dtype=torch.bool)
    if n_valid is not None:
        dead |= torch.arange(600) >= n_valid
    if seg is not None:
        dead |= seg < 0
    assert dead.any() and not out[dead].any() and out[~dead].abs().min() > 0
    grad = torch.tensor(np.random.default_rng(2).normal(size=out.shape).astype(np.float32))
    out.backward(grad)
    ref.backward(grad)
    for a, b in zip(leaves, ref_leaves):
        assert a.grad.abs().max() > 0 and torch.equal(a.grad, b.grad)


@pytest.mark.parametrize("segments", [1, 2])
def test_field_query_takes_a_gathered_stack(segments):
    """The FSDP step's form: a segment's grids as one (4L, F, T) stack give
    the features of its four tables bit for bit, and the stack's gradient is
    the four tables' gradients stacked."""
    fields = _query_fields(segments, seed=3)
    xyzt, n_valid, seg = _query_skips(500, segments, ("n_valid", "seg"), seed=4)
    stacked = [fli.SegmentField((torch.cat(f.grids),), f.vectors, f.spec) for f in fields]
    leaves, query_fields = _with_grad(fields)
    stack_leaves, stack_fields = _with_grad(stacked)
    out = fli.field_query(query_fields, xyzt, n_valid, seg)
    out_stacked = fli.field_query(stack_fields, xyzt, n_valid, seg)
    assert torch.equal(out, out_stacked)
    grad = torch.tensor(np.random.default_rng(5).normal(size=out.shape).astype(np.float32))
    out.backward(grad)
    out_stacked.backward(grad)
    for s in range(segments):
        tables, stack = leaves[5 * s:5 * s + 4], stack_leaves[2 * s]
        assert torch.equal(stack.grad, torch.cat([t.grad for t in tables]))
        assert torch.equal(stack_leaves[2 * s + 1].grad, leaves[5 * s + 4].grad)


@pytest.mark.parametrize("segments,skips", _QUERY_CASES, ids=_QUERY_IDS)
def test_field_query_bwd_plain_equals_autograd(segments, skips):
    """The backward's plain version (the cards' reference, there summed in
    fp64) in fp32 equals autograd through the plain query bit for bit, and
    in fp64 within 1e-6 of the scale."""
    fields = _query_fields(segments, seed=6)
    xyzt, n_valid, seg = _query_skips(400, segments, skips, seed=7)
    leaves, query_fields = _with_grad(fields)
    out = fli.field_query(query_fields, xyzt, n_valid, seg)
    grad = torch.tensor(np.random.default_rng(8).normal(size=out.shape).astype(np.float32))
    out.backward(grad)
    plain = fli.field_query_bwd_plain(fields, xyzt, grad, n_valid, seg)
    plain64 = fli.field_query_bwd_plain(fields, xyzt, grad.double(), n_valid, seg)
    for leaf, a, b in zip(leaves, plain, plain64):
        assert torch.equal(leaf.grad, a)
        assert float((b - a.double()).abs().max() / b.abs().max()) < 1e-6


def test_model_features_route_each_sample_to_its_segment():
    """`HumanRFModel.features` over two segments: each sample's features are
    its own segment's, as a one-segment query of that segment's tables
    gives them, and a frame of no segment reads zeros; with the FSDP form's
    gathered stacks the same bit for bit."""
    from humanrf_torch.models.humanrf import HumanRFConfig, HumanRFModel

    model = HumanRFModel(HumanRFConfig(sorted_frame_numbers=(0, 1, 2, 3), segment_sizes=(2, 2), n_levels=2,
                                       log2_hashmap_size=12, coarsest_resolution=4, finest_resolution=64))
    model.init_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for segment in model.segments:
            for name in ("xyz", "xyt", "yzt", "xzt"):
                getattr(segment, name).mul_(3e3)
    model.frame_to_segment[3] = -1  # frame 3 belongs to no segment
    rng = np.random.default_rng(9)
    positions = torch.tensor(rng.uniform(-0.5, 0.5, (300, 3)).astype(np.float32))
    frames = torch.tensor(rng.integers(0, 4, 300))
    out = model.features(positions, frames)
    stacks = {s: torch.cat([getattr(segment, name) for name in ("xyz", "xyt", "yzt", "xzt")])
              for s, segment in enumerate(model.segments)}
    assert torch.equal(model.features(positions, frames, stacks), out)
    times = model.frame_to_local_time[frames][:, None]
    xyzt = torch.cat([positions + 0.5, times], dim=-1)
    for s, segment in enumerate(model.segments):
        mine = model.frame_to_segment[frames] == s
        alone = fli.field_query([segment.field()], xyzt[mine])
        assert mine.any() and torch.equal(out[mine], alone)
    assert not out[frames == 3].any()


def _many_fields(segments, seed):
    """`segments` fields over the same 2 levels, their tables of 2^6, 2^7
    or 2^8 entries in turn (the ladder's uneven segments)."""
    rng = np.random.default_rng(seed)
    fields = []
    for s in range(segments):
        cfg = THashGridConfig(n_levels=2, n_features_per_level=2, log2_hashmap_size=6 + s % 3, base_resolution=4,
                              finest_resolution=16)
        grids = tuple(torch.tensor(rng.uniform(-1, 1, (2, 2, cfg.table_size)).astype(np.float32)) for _ in range(4))
        fields.append(fli.SegmentField(grids, torch.tensor(rng.uniform(-1, 1, (4, 4, 8)).astype(np.float32)),
                                       fli.grid_spec(cfg)))
    return fields


def test_field_query_takes_167_segments():
    """The query over 167 segments (1000 frames cut at the ladder's
    smallest, 6 frames): each sample's features are a one-segment query of
    its own segment's tables, bit for bit; a sample of no segment or past
    `n_valid` reads zeros; each segment's tables take a gradient from its
    own samples alone. One more segment than the kernels hold raises."""
    fields = _many_fields(167, seed=10)
    rng = np.random.default_rng(11)
    n = 3000
    xyzt = torch.tensor(rng.uniform(0, 1, (n, 4)).astype(np.float32))
    seg = torch.tensor(rng.integers(-1, 167, n).astype(np.int32))
    n_valid = torch.tensor([int(0.8 * n)], dtype=torch.int32)
    leaves, query_fields = _with_grad(fields)
    out = fli.field_query(query_fields, xyzt, n_valid, seg)
    live = torch.arange(n) < n_valid
    assert not out[~live | (seg < 0)].any()
    out.backward(torch.ones_like(out))
    for s in (0, 1, 2, 83, 166):
        mine = live & (seg == s)
        assert mine.any() and torch.equal(out[mine], fli.field_query([fields[s]], xyzt[mine]))
        assert all(t.grad.abs().max() > 0 for t in leaves[5 * s:5 * s + 5])
    empty = set(range(167)) - set(seg[live].tolist())
    for s in empty:
        assert not any(t.grad.any() for t in leaves[5 * s:5 * s + 5])
    assert fli.MAX_SEGMENTS == 256
    with pytest.raises(ValueError, match="segments"):
        fli.field_query(_many_fields(257, seed=12), xyzt, n_valid, seg)


@pytest.mark.parametrize("bad", ["two-segments-no-seg", "levels-differ", "vectors-shape", "vectors-resolution",
                                 "three-grids", "f64"])
def test_field_query_rejects_bad_fields(bad):
    fields = _query_fields(2)
    xyzt, _, seg = _query_skips(50, 2, ("seg",))
    if bad == "two-segments-no-seg":
        seg = None
    elif bad == "levels-differ":
        cfg = THashGridConfig(**dict(_QUERY_GRIDS[1], finest_resolution=128))
        fields[1] = fields[1]._replace(spec=fli.grid_spec(cfg))
    elif bad == "vectors-shape":
        fields[1] = fields[1]._replace(vectors=fields[1].vectors[:, :-1])
    elif bad == "vectors-resolution":
        fields[1] = fields[1]._replace(vectors=fields[1].vectors[:, :, :-1])
    elif bad == "three-grids":
        fields[0] = fields[0]._replace(grids=fields[0].grids[:3])
    else:
        fields[0] = fields[0]._replace(vectors=fields[0].vectors.double())
    with pytest.raises((TypeError, ValueError)):
        fli.field_query(fields, xyzt, seg=seg)


# ------------------------------------- the backward's gradient buffers

from humanrf_torch.utils import profiling  # noqa: E402


def _grad_case(case):
    """→ (a table as the field query's backward receives it, whether its
    gradient goes straight into its own `.grad`)."""
    table = torch.nn.Parameter(torch.zeros(2, 3, 4))
    if case == "grad":  # the train step's: zeroed in place before the forward
        table.grad = torch.zeros_like(table)
    elif case == "bucket-view":  # the data-parallel step's: a view into the summed bucket
        table.grad = torch.zeros(5 + table.numel() + 7)[5:5 + table.numel()].view_as(table)
    elif case == "non-contiguous":
        table.grad = torch.zeros(4, 3, 2).permute(2, 1, 0)
    elif case == "float64":
        table.grad = torch.zeros_like(table)
        table.grad.data = table.grad.data.double()
    elif case == "stack":  # the FSDP step's gathered stack: no leaf
        table.grad = torch.zeros_like(table)
        return torch.cat([table, table]), False
    elif case == "detached":  # chip_smoke's tables: no gradient asked for
        return table.detach(), False
    return table, case in ("grad", "bucket-view")


@pytest.mark.parametrize("case", ["grad", "bucket-view", "no-grad", "non-contiguous", "float64", "stack", "detached"])
def test_grad_in_place_decides_from_the_tensor(case, monkeypatch):
    """The rule that sends a table's gradient straight into its `.grad`: a
    leaf that requires a gradient, with a dense, contiguous float32 `.grad`
    of its shape on its device, which is the buffer then; anything else
    takes a fresh zeroed buffer. The gauges count the entries of each kind
    (here beside a vector with no `.grad`, always fresh). The rule holds
    only inside `grads_in_place()`: outside it every table is fresh."""
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    table, in_place = _grad_case(case)
    assert not fli.grad_in_place(table)
    with fli.grads_in_place():
        assert fli.grad_in_place(table) == in_place
        vector = torch.nn.Parameter(torch.ones(5))
        buffers, flags = fli._grad_buffers([table, vector])
    assert not fli.grad_in_place(table)
    assert flags == [in_place, False]
    if in_place:
        assert buffers[0] is table.grad
    else:
        assert buffers[0].shape == table.shape and buffers[0].is_contiguous() and not buffers[0].any()
    assert buffers[1].shape == (5,) and not buffers[1].any()
    assert profiling.snapshot()["counters"] == {"field.grads_in_place": table.numel() if in_place else 0,
                                                "field.grads_fresh": 5 + (0 if in_place else table.numel())}


def _plain_launches(monkeypatch):
    """The kernels' launches stood in by their plain versions, on CPU
    tensors: the forward writes `field_query_plain`'s features, the backward
    adds `field_query_bwd_plain`'s gradients into the buffers it is given."""
    def run(name, fields, xyzt, second, n_valid, seg, grads=None):
        if name == "field_query_fwd":
            second.copy_(fli.field_query_plain(fields, xyzt, n_valid, seg))
        else:
            for buffer, g in zip(grads, fli.field_query_bwd_plain(fields, xyzt, second, n_valid, seg)):
                buffer.add_(g)

    monkeypatch.setattr(fli, "_run_query", run)


@pytest.mark.parametrize("form", ["tables", "stacks"])
def test_query_backward_adds_into_each_tables_grad(form, monkeypatch):
    """`FieldQueryKernel`'s gradients over two backward calls, its launches
    stood in by the plain versions: the first (no `.grad` yet) returns fresh
    buffers, which autograd keeps; the second adds into each `.grad` and
    returns None, so autograd adds nothing more. Each `.grad` ends bit for
    bit where autograd through the plain query puts it. In the FSDP form the
    gathered stacks are no leaves and take fresh buffers on every call, the
    vectors' gradients go in place; the gauges count each kind. The calls
    run inside `grads_in_place()`, as the train step's backward does."""
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    _plain_launches(monkeypatch)
    fields = _query_fields(2, seed=13)
    xyzt, n_valid, seg = _query_skips(300, 2, ("n_valid", "seg"), seed=14)
    layout = [(f.spec, len(f.grids)) for f in fields]

    def query(leaves, kernel):
        fs = fli._unflat(layout, leaves)
        if form == "stacks":
            fs = [f._replace(grids=(torch.cat(f.grids),)) for f in fs]
        if kernel:
            return fli.FieldQueryKernel.apply(tuple((f.spec, len(f.grids)) for f in fs), xyzt, n_valid, seg,
                                              *fli._flat(fs))
        return fli.field_query_plain(fs, xyzt, n_valid, seg)

    leaves, _ = _with_grad(fields)
    ref_leaves, _ = _with_grad(fields)
    vectors = sum(f.vectors.numel() for f in fields)
    total = sum(t.numel() for t in leaves)
    rng = np.random.default_rng(15)
    for call in range(2):
        grad = torch.tensor(rng.normal(size=(300, fields[0].vectors.shape[1])).astype(np.float32))
        with fli.grads_in_place():
            query(leaves, kernel=True).backward(grad)
        query(ref_leaves, kernel=False).backward(grad)
        in_place = 0 if call == 0 else total if form == "tables" else vectors
        assert profiling.snapshot()["counters"] == {"field.grads_in_place": in_place,
                                                    "field.grads_fresh": total - in_place}
        for a, b in zip(leaves, ref_leaves):
            assert a.grad.abs().max() > 0 and torch.equal(a.grad, b.grad)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_query_backward_adds_into_grad_under_a_graph_on_card(cuda_device, monkeypatch):
    """Three segments of the paper's L16/F2 levels (T = 2^17), samples of
    segments 0 and 2 alone (and of none). An eager query and backward with
    no `.grad` yet take fresh buffers (`field.grads_in_place` 0) and give
    the plain version's gradient, summed in fp64, within 1e-5 of each
    gradient's scale (fp32 atomics, in a run-dependent order). Captured as a
    CUDA graph with every `.grad` there, inside `grads_in_place()` as the
    train step's backward runs, the backward adds into them
    (`field.grads_fresh` 0) and the capture takes no table-sized buffer; a
    replay leaves each reached table's and vector's `.grad` at what it held
    plus that gradient, within the same bound, and segment 1's bit for bit
    as it was."""
    monkeypatch.setattr(profiling, "RECORDER", profiling.Recorder())
    rng = np.random.default_rng(20)
    cfg = THashGridConfig(n_levels=16, n_features_per_level=2, log2_hashmap_size=17, base_resolution=32,
                          finest_resolution=2048)
    L, F, T, n = cfg.n_levels, cfg.n_features_per_level, cfg.table_size, 65_536

    def uniform(shape):
        return torch.tensor(rng.uniform(-1, 1, shape).astype(np.float32), device=cuda_device)

    shapes = [(L, F, T)] * 4 + [(4, L * F, 2048)]
    leaves = [uniform(shape).requires_grad_() for _ in range(3) for shape in shapes]
    layout = [(fli.grid_spec(cfg), 4)] * 3
    fields = fli._unflat(layout, leaves)
    xyzt = torch.tensor(rng.uniform(0, 1, (n, 4)).astype(np.float32), device=cuda_device)
    seg = torch.tensor(rng.choice([0, 2, -1], n, p=[0.45, 0.45, 0.1]).astype(np.int32), device=cuda_device)
    n_valid = torch.tensor([int(0.9 * n)], dtype=torch.int32, device=cuda_device)
    grad = uniform((n, L * F))
    refs = fli.field_query_bwd_plain(fli._unflat(layout, [t.detach() for t in leaves]), xyzt, grad.double(),
                                     n_valid, seg)
    total = sum(t.numel() for t in leaves)

    def scaled_err(got, r):
        return float((got - r).abs().max() / r.abs().max())

    fli.field_query(fields, xyzt, n_valid, seg).backward(grad)
    torch.cuda.synchronize()
    assert profiling.snapshot()["counters"] == {"field.grads_in_place": 0, "field.grads_fresh": total}
    for i, (t, r) in enumerate(zip(leaves, refs)):
        if i // 5 == 1:
            assert not t.grad.any() and not r.any(), i
        else:
            assert scaled_err(t.grad.double(), r) < 1e-5, i

    held = [uniform(t.shape) * (0.5 * float(r.abs().max()) if r.any() else 1.0) for t, r in zip(leaves, refs)]
    graph = torch.cuda.CUDAGraph()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved = torch.cuda.memory_reserved(cuda_device)
    with torch.cuda.graph(graph), fli.grads_in_place():
        fli.field_query(fields, xyzt, n_valid, seg).backward(grad)
    torch.cuda.synchronize()
    assert profiling.snapshot()["counters"] == {"field.grads_in_place": total, "field.grads_fresh": 0}
    table_bytes = 4 * total
    assert torch.cuda.memory_reserved(cuda_device) - reserved < table_bytes // 4
    with torch.no_grad():
        for t, h in zip(leaves, held):
            t.grad.copy_(h)
    graph.replay()
    torch.cuda.synchronize()
    for i, (t, h, r) in enumerate(zip(leaves, held, refs)):
        if i // 5 == 1:
            assert torch.equal(t.grad.view(torch.int32), h.view(torch.int32)), i
        else:
            assert scaled_err(t.grad.double() - h.double(), r) < 1e-5, i
