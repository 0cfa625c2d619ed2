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


def test_decomposition_matches_jax_gather_backend():
    """Gather backend: fp32 lookups, the vectors lerped as v0 + f·(v1 − v0)
    where the port weights both taps; 1e-5 absolute on O(1) features."""
    grid = HashGridConfig(**GRID)
    params = _decomposition_params(grid, 128)
    xyz, times = _points(512, 3, seed=2), _points(512, 1, seed=3)
    ref = _np(apply_decomposition4d(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(xyz), jnp.asarray(times),
        Decomposition4DConfig(grid=grid, vectors_finest_resolution=128, backend="gather"),
    ))
    out = t_ff.apply_decomposition4d_fused(
        {k: torch.tensor(v) for k, v in params.items()}, torch.tensor(xyz), torch.tensor(times),
        TDecompConfig(grid=THashGridConfig(**GRID), vectors_finest_resolution=128),
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
