"""The port's training step (humanrf_torch/train, ops/resample, utils/rngs,
models) against the JAX package's: the leaf functions with their hand-written
gradients, the identity-keyed noise (bit for bit), the optimizer with its
non-finite skip, and `make_train_step` as a whole on a small two-segment
model and on the trained r4 checkpoint. Inputs come from numpy seeds and go to
both packages; both packages get the same key."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanrf_torch.convert import convert_params
from humanrf_torch.models.activation import truncated_exp as t_truncated_exp
from humanrf_torch.models.humanrf import HumanRFConfig as THumanRFConfig
from humanrf_torch.models.humanrf import HumanRFModel as THumanRFModel
from humanrf_torch.ops import resample as t_resample
from humanrf_torch.train import losses as t_losses
from humanrf_torch.train import pipeline as t_pipeline
from humanrf_torch.train import trainer as t_trainer
from humanrf_torch.train.checkpoint import load_checkpoint as t_load_checkpoint
from humanrf_torch.utils import rngs as t_rngs
from humanrf_torch.view_inputs import load_train_inputs, load_view_inputs
from humanrf_tpu.models.activation import truncated_exp as j_truncated_exp
from humanrf_tpu.models.humanrf import HumanRFConfig, HumanRFModel
from humanrf_tpu.ops import resample as j_resample
from humanrf_tpu.train import losses as j_losses
from humanrf_tpu.train import pipeline as j_pipeline
from humanrf_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint
from humanrf_tpu.train.trainer import make_optimizer as j_make_optimizer
from humanrf_tpu.utils import rngs as j_rngs

torch.set_num_threads(2)

RUN_DIR = Path(__file__).resolve().parent.parent / "runs_evidence" / "r4_full_schedule_748"


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


@pytest.fixture(scope="module")
def train_inputs():
    return load_train_inputs(RUN_DIR / "torch_train_inputs.npz", "cpu")


# ------------------------------------------------------------------ leaves


def test_truncated_exp_value_and_gradient_match_jax():
    """Forward clamp at +16, backward clamp to [-15, 15], on x ∈ [-20, 20]:
    the same fp32 exp on both sides, 1e-6 relative."""
    x = np.linspace(-20.0, 20.0, 4001, dtype=np.float32)
    g = np.random.default_rng(0).normal(size=x.shape).astype(np.float32)
    jval, jvjp = jax.vjp(j_truncated_exp, jnp.asarray(x))
    tx = torch.tensor(x, requires_grad=True)
    tval = t_truncated_exp(tx)
    tval.backward(torch.tensor(g))
    np.testing.assert_allclose(_np(tval), _np(jval), rtol=1e-6)
    np.testing.assert_allclose(_np(tx.grad), _np(jvjp(jnp.asarray(g))[0]), rtol=1e-6)
    # Above 16 autograd of the forward would give 0; the clamped backward does not.
    assert (tx.grad[x > 16].abs() > 0).all()


def test_bce_loss_value_and_gradient_match_jax():
    """Including p = 1 with t = 0 (gradient ≈ 1e10, the load-bearing
    restoring force), p = 0 with t = 1, and p outside [0, 1] (gradient 0).
    Same fp32 logs and quotients: 1e-6 relative."""
    rng = np.random.default_rng(1)
    p = np.concatenate([rng.uniform(0, 1, 200), [1.0, 0.0, 1.0, 0.0, -0.1, 1.2, 0.5]]).astype(np.float32)
    t = np.concatenate([rng.uniform(0, 1, 200), [0.0, 1.0, 1.0, 0.0, 0.5, 0.5, 0.5]]).astype(np.float32)
    jval, jvjp = jax.vjp(lambda q: j_losses.bce_loss(q, jnp.asarray(t)), jnp.asarray(p))
    tp = torch.tensor(p, requires_grad=True)
    tval = t_losses.bce_loss(tp, torch.tensor(t))
    tval.sum().backward()
    jgrad = _np(jvjp(jnp.ones_like(jval))[0])
    np.testing.assert_allclose(_np(tval), _np(jval), rtol=1e-6)
    np.testing.assert_allclose(_np(tp.grad), jgrad, rtol=1e-6)
    assert tp.grad[200] == pytest.approx(1e10, rel=1e-3)   # p = 1, t = 0
    assert tp.grad[201] == pytest.approx(-1e10, rel=1e-3)  # p = 0, t = 1
    assert tp.grad[204] == 0 and tp.grad[205] == 0         # outside [0, 1]


def test_huber_and_masked_mean_match_jax():
    """Elementwise Huber on both branches, then the masked mean over (R, 3)
    rows; fp32 sums of 300 terms in another order: 1e-6 relative."""
    rng = np.random.default_rng(2)
    pred = rng.uniform(0, 1, (100, 3)).astype(np.float32)
    target = (pred + rng.normal(scale=0.02, size=pred.shape)).astype(np.float32)
    mask = rng.random(100) > 0.3
    jh = j_losses.huber_loss(jnp.asarray(pred), jnp.asarray(target), 0.01)
    th = t_losses.huber_loss(torch.tensor(pred), torch.tensor(target), 0.01)
    np.testing.assert_allclose(_np(th), _np(jh), rtol=1e-6, atol=1e-12)
    jm = j_losses.masked_mean(jh, jnp.asarray(mask))
    tm = t_losses.masked_mean(th, torch.tensor(mask))
    assert _rel(tm, jm) <= 1e-6
    assert float(t_losses.masked_mean(th, torch.zeros(100, dtype=torch.bool))) == 0.0


# ------------------------------------------------------------------- noise


@pytest.mark.parametrize("num", [1, 2, 3])
def test_uniform_per_id_is_bit_equal_to_jax(num):
    """The installed JAX has jax_threefry_partitionable on; the port must
    give the same bits, so the comparison is exact."""
    ids = np.random.default_rng(3).integers(0, 2**24, 5000).astype(np.int32)
    key = jax.random.PRNGKey(2024)
    jax_u = _np(j_rngs.uniform_per_id(key, jnp.asarray(ids), num=num))
    port_u = _np(t_rngs.uniform_per_id(t_rngs.make_key(2024), torch.tensor(ids), num=num))
    assert port_u.dtype == np.float32 and port_u.shape == jax_u.shape
    np.testing.assert_array_equal(port_u, jax_u)


def test_fold_in_and_split_are_bit_equal_to_jax():
    assert jax.config.jax_threefry_partitionable
    key = jax.random.PRNGKey(7)
    tkey = t_rngs.make_key(7)
    np.testing.assert_array_equal(_np(tkey), _np(key))
    for data in (0, 1, 12345, 2**31 - 1):
        np.testing.assert_array_equal(_np(t_rngs.fold_in(tkey, torch.tensor(data))), _np(jax.random.fold_in(key, data)))
    for num in (2, 3, 5):
        np.testing.assert_array_equal(_np(t_rngs.split(tkey, num)), _np(jax.random.split(key, num)))
    # A key derived from a key, as the step derives its sub-keys.
    sub = jax.random.split(jax.random.fold_in(key, 3))[1]
    np.testing.assert_array_equal(_np(t_rngs.split(t_rngs.fold_in(tkey, torch.tensor(3)))[1]), _np(sub))


# ---------------------------------------------------------------- resample


def test_stratified_bins_and_sample_intervals_with_offsets_match_jax():
    """The training draw (offsets u) on both sides: fp32 arithmetic on t in
    [2, 4], 1e-5 absolute (one rounding of a cumulative sum's order)."""
    rng = np.random.default_rng(4)
    R, K, S = 200, 16, 8
    tmin = rng.uniform(2.0, 3.0, R).astype(np.float32)
    tmax = (tmin + rng.uniform(0.0, 1.0, R)).astype(np.float32)
    u_c = rng.random((R, K)).astype(np.float32)
    u_f = rng.random((R, S + 1)).astype(np.float32)
    w = rng.exponential(1.0, (R, K)).astype(np.float32) * (rng.random((R, K)) > 0.3)

    jt, jdt, jedges = j_resample.stratified_bins(jnp.asarray(tmin), jnp.asarray(tmax), K, jnp.asarray(u_c))
    tt, tdt, tedges = t_resample.stratified_bins(torch.tensor(tmin), torch.tensor(tmax), K, torch.tensor(u_c))
    for a, b in ((tt, jt), (tdt, jdt), (tedges, jedges)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-5)

    jcdf = j_resample.weights_to_cdf(jnp.asarray(w), 0.05)
    tcdf = t_resample.weights_to_cdf(torch.tensor(w), 0.05)
    jout = j_resample.sample_intervals(jedges, jcdf, S, jnp.asarray(u_f), return_edges=True)
    tout = t_resample.sample_intervals(tedges, tcdf, S, torch.tensor(u_f), return_edges=True)
    for a, b in zip(tout, jout):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-5)


def test_histogram_outer_mass_cases():
    """The JAX package's hand-checked cases (tests/test_proposal.py): whole
    range, one bin, straddling bins, past the end, outside."""
    edges = torch.tensor([[0.0, 1.0, 2.0, 3.0]])
    weights = torch.tensor([[0.2, 0.5, 0.3]])
    t0 = torch.tensor([[0.0, 1.0, 0.5, 2.5, 3.5]])
    t1 = torch.tensor([[3.0, 2.0, 1.5, 3.5, 4.0]])
    mass = _np(t_resample.histogram_outer_mass(edges, weights, t0, t1))[0]
    np.testing.assert_allclose(mass, [1.0, 0.5, 0.35, 0.15, 0.0], rtol=1e-5, atol=1e-6)


def _distillation_inputs(seed=5, R=64, K=16, S=8):
    rng = np.random.default_rng(seed)
    tmin = rng.uniform(2.0, 3.0, R).astype(np.float32)
    span = rng.uniform(0.1, 1.0, R).astype(np.float32)
    edges = (tmin[:, None] + span[:, None] * np.linspace(0, 1, K + 1, dtype=np.float32)[None, :]).astype(np.float32)
    w_prop = (rng.exponential(0.1, (R, K)) * (rng.random((R, K)) > 0.4)).astype(np.float32)
    t_edges = np.sort(rng.uniform(tmin[:, None] - 0.05, (tmin + span + 0.05)[:, None], (R, S + 1)), axis=1).astype(np.float32)
    w_fine = rng.exponential(0.1, (R, S)).astype(np.float32)
    return edges, w_prop, t_edges[:, :-1], t_edges[:, 1:], w_fine


def test_histogram_outer_mass_matches_jax():
    edges, w_prop, t0, t1, _ = _distillation_inputs()
    jm = j_resample.histogram_outer_mass(*(jnp.asarray(a) for a in (edges, w_prop, t0, t1)))
    tm = t_resample.histogram_outer_mass(*(torch.tensor(a) for a in (edges, w_prop, t0, t1)))
    np.testing.assert_allclose(_np(tm), _np(jm), rtol=0, atol=1e-6)


def test_proposal_distillation_value_and_gradient_match_jax():
    """Per-ray loss and its gradient into the proposal weights (none into
    the fine weights): fp32 cumulative sums in another order, 1e-5 of the
    scale."""
    edges, w_prop, t0, t1, w_fine = _distillation_inputs()

    def jloss(wp, wf):
        return j_resample.proposal_distillation_per_ray(jnp.asarray(edges), wp, jnp.asarray(t0), jnp.asarray(t1), wf)

    jval = jloss(jnp.asarray(w_prop), jnp.asarray(w_fine))
    jgp, jgf = jax.grad(lambda wp, wf: jloss(wp, wf).sum(), argnums=(0, 1))(jnp.asarray(w_prop), jnp.asarray(w_fine))
    twp = torch.tensor(w_prop, requires_grad=True)
    twf = torch.tensor(w_fine, requires_grad=True)
    tval = t_resample.proposal_distillation_per_ray(torch.tensor(edges), twp, torch.tensor(t0), torch.tensor(t1), twf)
    tval.sum().backward()
    assert float(tval.detach().sum()) > 0
    np.testing.assert_allclose(_np(tval), _np(jval), rtol=0, atol=1e-5 * float(np.abs(_np(jval)).max()))
    np.testing.assert_allclose(_np(twp.grad), _np(jgp), rtol=0, atol=1e-5 * float(np.abs(_np(jgp)).max()))
    assert twf.grad is None and not np.any(_np(jgf))


# --------------------------------------------------------------- compaction


def test_compact_rays_matches_jax():
    """Valid rays first in their order, then invalid ones; the batch and the
    ray ids travel with their rays."""
    rng = np.random.default_rng(6)
    n, out = 40, 24
    fields = [rng.normal(size=(n, 3)), rng.normal(size=(n, 3)), rng.random(n), rng.random(n) + 1,
              rng.random(n) > 0.5, rng.integers(0, 5, n), rng.integers(0, 5, n)]
    fields = [f.astype(np.float32) if f.dtype == np.float64 else f.astype(np.int32) if f.dtype != bool else f for f in fields]
    batch = [rng.integers(0, 4, n).astype(np.int32), rng.integers(0, 99, n).astype(np.int32),
             rng.random((n, 4)).astype(np.float32), rng.random(n) > 0.1]
    ids = np.arange(n, dtype=np.int32)
    jr, jb, ji = j_pipeline.compact_rays(
        j_pipeline.RayData(*map(jnp.asarray, fields)), j_pipeline.HostBatch(*map(jnp.asarray, batch)), jnp.asarray(ids), out
    )
    tr, tb, ti = t_pipeline.compact_rays(
        t_pipeline.RayData(*map(torch.tensor, fields)), t_pipeline.HostBatch(*map(torch.tensor, batch)), torch.tensor(ids), out
    )
    for a, b in zip((*tr, *tb, ti), (*jr, *jb, ji)):
        np.testing.assert_array_equal(_np(a), _np(b))


# ---------------------------------------------------------------- optimizer


def test_optimizer_matches_optax_with_a_nonfinite_step():
    """Three applied updates and one NaN step in between, fed the same
    gradients: the port's AdamW against `make_optimizer(1e-2, 0.5, 50_001,
    0.03)` within 1e-6 relative (fp32 moments and powers, maybe an ulp apart).
    The NaN step leaves parameters, moments and count as they were, on both
    sides, and counts one skip."""
    import optax

    rng = np.random.default_rng(7)
    shapes = {"a": (5, 3), "b": (7,)}
    params = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.normal(scale=0.1, size=s).astype(np.float32) for k, s in shapes.items()} for _ in range(4)]
    grads[2]["b"][3] = np.nan

    jopt = j_make_optimizer(1e-2, 0.5, 50_001, weight_decay=0.03)
    jparams = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jparams)
    tparams = {k: torch.nn.Parameter(torch.tensor(v)) for k, v in params.items()}
    topt = t_trainer.make_optimizer(tparams.items(), 1e-2, 0.5, 50_001, weight_decay=0.03)

    for i, g in enumerate(grads):
        updates, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        before = {k: p.detach().clone() for k, p in tparams.items()}
        mu_before = [m.clone() for m in topt.mu]
        for k, p in tparams.items():
            p.grad = torch.tensor(g[k])
        topt.step()
        for k in shapes:
            np.testing.assert_allclose(_np(tparams[k]), _np(jparams[k]), rtol=1e-6, atol=1e-7)
        adam = jstate.inner_state[0]
        for k, m, v in zip(tparams, topt.mu, topt.nu):
            np.testing.assert_allclose(_np(m), _np(adam.mu[k]), rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(_np(v), _np(adam.nu[k]), rtol=1e-6, atol=1e-12)
        assert int(topt.count) == int(adam.count)
        assert int(topt.skipped) == int(jstate.total_notfinite)
        if i == 2:
            for k, p in tparams.items():
                assert torch.equal(p.detach(), before[k])
            assert all(torch.equal(m, mb) for m, mb in zip(topt.mu, mu_before))
    assert int(topt.count) == 3 and int(topt.skipped) == 1


# ------------------------------------------------------------ model init


def test_init_parameters_draws_the_jax_distributions():
    """Not the JAX package's numbers (another generator), its distributions:
    ±1e-4 uniform tables, 0.1-normal vectors, He-normal MLPs, unit-normal
    camera embeddings, 0.3-normal proposal factors."""
    model = THumanRFModel(THumanRFConfig(**_SMALL))
    model.init_parameters(torch.Generator().manual_seed(0))
    p = dict(model.named_parameters())
    table = p["segments.0.xyz"]
    assert float(table.abs().max()) <= 1e-4 and float(table.std()) == pytest.approx(1e-4 / 3**0.5, rel=0.1)
    assert float(p["segments.1.vectors"].std()) == pytest.approx(0.1, rel=0.05)
    assert float(p["color_net.w1"].std()) == pytest.approx((2 / 16) ** 0.5, rel=0.1)
    assert float(p["camera_embeddings"].std()) == pytest.approx(1.0, rel=0.1)
    assert float(p["proposal.1.factors"].std()) == pytest.approx(0.3, rel=0.1)
    again = THumanRFModel(THumanRFConfig(**_SMALL))
    again.init_parameters(torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


# ------------------------------------------------------------ the whole step

# Two 25-frame segments at the r4 scene's frames; L2/F2 grids at T = 2^9 per
# segment (level resolutions 4, dense, and 32, hashed: no corner leaves the
# table, where the JAX gather backend would read NaN); narrow MLPs; rank 8.
# Density scale 10 instead of 100: at 100 a fresh model is opaque on every
# ray, and BCE on an opaque ray is log(1 − p), which fp32 resolves only to
# 6e-8 near p = 1 — one ulp of p moves a ray's term between −log(1e-10) and
# −log(6e-8), far past any relative bound on the loss.
_SMALL = dict(
    sorted_frame_numbers=tuple(range(50)), segment_sizes=(25, 25), density_scale=10.0, n_levels=2, n_features_per_level=2,
    log2_hashmap_size=11, coarsest_resolution=4, finest_resolution=32, geometry_feature_dim=3,
    n_neurons=16, n_hidden_layers_density=1, n_hidden_layers_color=1, sh_degree=2,
    camera_embedding_dim=2, proposal_rank=8, proposal_resolution=16,
)
_SMALL_PCFG = dict(
    num_rays=128, candidate_rays_factor=2, proposal_samples_per_ray=16, render_samples_per_ray=8,
    proposal_uniform_bonus=0.05, march_grid_factor=2, bce_loss_weight=1e-3, huber_delta=0.01,
    proposal_loss_weight=1.0,
)


def _batch(train_inputs, num, seed, on_actor):
    """`num` candidate pixels over the whole pool: `on_actor` of them inside
    the images' masks (so that rays hit the hull), the rest uniform."""
    rng = np.random.default_rng(seed)
    rgba = _np(train_inputs.pixel_rgba)
    b_act = rng.integers(0, rgba.shape[0], on_actor)
    p_act = np.array([rng.choice(np.nonzero(rgba[b, :, 3])[0]) for b in b_act])
    buffer_idx = np.concatenate([b_act, rng.integers(0, rgba.shape[0], num - on_actor)]).astype(np.int32)
    pixel_idx = np.concatenate([p_act, rng.integers(0, rgba.shape[1], num - on_actor)]).astype(np.int32)
    order = rng.permutation(num)
    buffer_idx, pixel_idx = buffer_idx[order], pixel_idx[order]
    return buffer_idx, pixel_idx, rgba[buffer_idx, pixel_idx].astype(np.float32) / 255.0


def _both_batches(train_inputs, buffer_idx, pixel_idx, rgba):
    n = len(buffer_idx)
    jbatch = j_pipeline.HostBatch(jnp.asarray(buffer_idx), jnp.asarray(pixel_idx), jnp.asarray(rgba), jnp.ones(n, bool))
    tbatch = t_pipeline.HostBatch(torch.tensor(buffer_idx), torch.tensor(pixel_idx), torch.tensor(rgba), torch.ones(n, dtype=torch.bool))
    jpool = j_pipeline.PoolArrays(*(jnp.asarray(_np(a)) for a in train_inputs.pool))
    return jbatch, tbatch, jpool


def _jax_loss_fn(cfg, model, width, height):
    """The JAX step's loss as a function of (params, rng, batch, pool,
    grids, aabb): `make_train_step`'s own body up to `value_and_grad`. The
    arrays are arguments, not constants, so XLA does not fold the grids."""

    def loss_fn(params, rng, batch, pool, grids, aabb):
        rays = j_pipeline.build_rays(cfg, batch, pool, grids, aabb, width, height)
        ray_ids = jnp.arange(cfg.num_rays * cfg.candidate_rays_factor, dtype=jnp.int32)
        rays, b, ray_ids = j_pipeline.compact_rays(rays, batch, ray_ids, cfg.num_rays)
        return j_pipeline.training_loss(
            cfg, model, params, rays, None, b.rgba, rng, ray_ids=ray_ids, pool=pool, grids=grids, buffer_idx=b.buffer_idx
        )

    return loss_fn


def _cosine(a, b):
    return float(np.dot(a.ravel(), b.ravel()) / (np.linalg.norm(a) * np.linalg.norm(b)))


def test_train_step_matches_jax_on_a_two_segment_model(train_inputs):
    """The JAX `fp32 gather` field against the port's plain path, same
    params (JAX's init, converted), same batch, same key.

    - Step-1 loss and aux within 1e-5 relative: the forward differs only in
      fp32 summation order and in the bf16 MLP's accumulation.
    - Gradients per leaf at cosine ≥ 0.999 and max error ≤ 2e-2 of the
      leaf's largest entry: the two frameworks round the MLP's backward to
      bf16 at different points. Both segments' leaves get gradients (the
      routing carries them back to their own segment).
    - The losses of three consecutive steps (AdamW, eps = 1e-15) within 1e-3
      relative. Adam's first update moves every parameter with a non-zero
      gradient by ±lr whatever the gradient's size, so post-step parameters
      are compared only in the optimizer's own test.
    """
    jmodel = HumanRFModel(HumanRFConfig(**_SMALL, field_backend="gather"))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel = THumanRFModel(THumanRFConfig(**_SMALL))
    tmodel.load_state_dict(convert_params(jax.tree_util.tree_map(np.asarray, jparams)))

    jcfg = j_pipeline.PipelineConfig(sampling="proposal", **_SMALL_PCFG)
    tcfg = t_pipeline.PipelineConfig(**_SMALL_PCFG)
    buffer_idx, pixel_idx, rgba = _batch(train_inputs, 256, seed=8, on_actor=110)
    jbatch, tbatch, jpool = _both_batches(train_inputs, buffer_idx, pixel_idx, rgba)
    grids, aabb, w, h = train_inputs.grids, train_inputs.aabb, train_inputs.width, train_inputs.height
    jgrids, jaabb = jnp.asarray(_np(grids)), jnp.asarray(_np(aabb))

    loss_fn = _jax_loss_fn(jcfg, jmodel, w, h)
    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        jparams, jax.random.PRNGKey(5), jbatch, jpool, jgrids, jaabb
    )

    topt = t_trainer.make_optimizer(tmodel.named_parameters(), 1e-2, 0.5, 50_001, weight_decay=0.03)
    tstep = t_pipeline.make_train_step(tcfg, tmodel, topt, w, h)
    tloss, taux = tstep(tbatch, train_inputs.pool, grids, aabb, t_rngs.make_key(5))

    assert 0 < int(taux["num_rays_supervised"]) < tcfg.num_rays
    assert _rel(tloss, jloss) <= 1e-5
    for k, v in jaux.items():
        assert _rel(taux[k], v) <= 1e-5, k
    jflat = convert_params(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in tmodel.named_parameters():
        tg, jg = _np(p.grad), _np(jflat[name])
        assert np.abs(jg).max() > 0, name
        assert _cosine(tg, jg) >= 0.999, name
        assert np.abs(tg - jg).max() <= 2e-2 * np.abs(jg).max(), name

    # Three consecutive steps, step i keyed by fold_in(key, i).
    jopt = j_make_optimizer(1e-2, 0.5, 50_001, weight_decay=0.03)
    jstep = j_pipeline.make_train_step(jcfg, jmodel, jopt, w, h)
    jstate = jopt.init(jparams)
    tmodel.load_state_dict(convert_params(jax.tree_util.tree_map(np.asarray, jparams)))
    topt = t_trainer.make_optimizer(tmodel.named_parameters(), 1e-2, 0.5, 50_001, weight_decay=0.03)
    tstep = t_pipeline.make_train_step(tcfg, tmodel, topt, w, h)
    key, tkey = jax.random.PRNGKey(11), t_rngs.make_key(11)
    for i in range(3):
        jparams, jstate, jl, _ = jstep(jparams, jstate, jbatch, jpool, jgrids, jaabb, jax.random.fold_in(key, i))
        tl, _ = tstep(tbatch, train_inputs.pool, grids, aabb, t_rngs.fold_in(tkey, torch.tensor(i)))
        assert _rel(tl, jl) <= 1e-3, i
    assert int(topt.count) == 3 and int(topt.skipped) == 0


def test_training_render_with_a_second_proposal_level_matches_jax(train_inputs):
    """`proposal_render` in training mode with a mid level (its own keyed
    offsets, two distillation terms): color, accumulated alpha and the
    per-ray distillation loss of both packages, same key, 1e-5 absolute
    (values ≤ 1, fp32 sums in another order)."""
    jmodel = HumanRFModel(HumanRFConfig(**_SMALL, field_backend="gather"))
    jparams = jmodel.init_params(jax.random.PRNGKey(1))
    tmodel = THumanRFModel(THumanRFConfig(**_SMALL))
    tmodel.load_state_dict(convert_params(jax.tree_util.tree_map(np.asarray, jparams)))
    pcfg = dict(_SMALL_PCFG, candidate_rays_factor=1, proposal_mid_samples_per_ray=8)
    jcfg = j_pipeline.PipelineConfig(sampling="proposal", **pcfg)
    tcfg = t_pipeline.PipelineConfig(**pcfg)
    buffer_idx, pixel_idx, rgba = _batch(train_inputs, 128, seed=10, on_actor=80)
    jbatch, tbatch, jpool = _both_batches(train_inputs, buffer_idx, pixel_idx, rgba)
    grids, aabb, w, h = train_inputs.grids, train_inputs.aabb, train_inputs.width, train_inputs.height
    background = np.random.default_rng(11).random((128, 3)).astype(np.float32)

    def jrender(params, rng, batch, pool, grids, aabb, bg):
        rays = j_pipeline.build_rays(jcfg, batch, pool, grids, aabb, w, h)
        return j_pipeline.proposal_render(
            jcfg, jmodel, params, rays, pool, grids, batch.buffer_idx, rng, is_training=True, background_rgb=bg
        )

    jout, jaux = jax.jit(jrender)(
        jparams, jax.random.PRNGKey(4), jbatch, jpool, jnp.asarray(_np(grids)), jnp.asarray(_np(aabb)), jnp.asarray(background)
    )
    rays = t_pipeline.build_rays(tcfg, tbatch, train_inputs.pool, grids, aabb, w, h)
    with torch.no_grad():
        tout, taux = t_pipeline.proposal_render(
            tcfg, tmodel, rays, train_inputs.pool, grids, tbatch.buffer_idx, torch.tensor(background), t_rngs.make_key(4)
        )
    assert 0 < int(rays.valid.sum()) < 128
    np.testing.assert_allclose(_np(tout.color), _np(jout.color), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tout.weights_sum), _np(jout.weights_sum), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(taux["proposal_loss_per_ray"]), _np(jaux["proposal_loss_per_ray"]), rtol=0, atol=1e-5)
    assert float(taux["proposal_loss_per_ray"].sum()) > 0


def test_train_step_loss_matches_jax_on_the_trained_checkpoint(train_inputs):
    """best.ckpt's real weights at the r4 widths, a 64-ray batch from the
    training pool: the port's step-1 loss against the JAX step's within 1e-4
    relative (fp32 gather field on the JAX side, same key)."""
    view = load_view_inputs(RUN_DIR / "torch_view_inputs.npz", "cpu")
    mc = view.model_config
    jmodel = HumanRFModel(HumanRFConfig(**{**mc.__dict__, "field_backend": "gather"}))
    jparams, _, _, _, _ = j_load_checkpoint(RUN_DIR / "best.ckpt", jmodel.init_params(jax.random.PRNGKey(0)), None)
    params, _, _, _, _ = t_load_checkpoint(RUN_DIR / "best.ckpt")
    tmodel = THumanRFModel(mc)
    tmodel.load_state_dict(convert_params(params))

    pcfg = dict(_SMALL_PCFG, num_rays=64, proposal_samples_per_ray=32, render_samples_per_ray=16)
    jcfg = j_pipeline.PipelineConfig(sampling="proposal", **pcfg)
    tcfg = t_pipeline.PipelineConfig(**pcfg)
    buffer_idx, pixel_idx, rgba = _batch(train_inputs, 128, seed=9, on_actor=60)
    jbatch, tbatch, jpool = _both_batches(train_inputs, buffer_idx, pixel_idx, rgba)
    grids, aabb, w, h = train_inputs.grids, train_inputs.aabb, train_inputs.width, train_inputs.height

    jloss, jaux = jax.jit(_jax_loss_fn(jcfg, jmodel, w, h))(
        jparams, jax.random.PRNGKey(3), jbatch, jpool, jnp.asarray(_np(grids)), jnp.asarray(_np(aabb))
    )
    topt = t_trainer.make_optimizer(tmodel.named_parameters(), 1e-2, 0.5, 50_001, weight_decay=0.03)
    tloss, taux = t_pipeline.make_train_step(tcfg, tmodel, topt, w, h)(
        tbatch, train_inputs.pool, grids, aabb, t_rngs.make_key(3)
    )
    assert int(taux["num_rays_supervised"]) == int(jaux["num_rays_supervised"]) > 32
    assert _rel(tloss, jloss) <= 1e-4


def test_sample_batch_draws_pool_pixels_with_their_rgba(train_inputs):
    cfg = t_pipeline.PipelineConfig(num_rays=500, candidate_rays_factor=2)
    batch = t_trainer.sample_batch(cfg, train_inputs.pixel_rgba, torch.Generator().manual_seed(0))
    assert batch.buffer_idx.shape == (1000,) and batch.buffer_idx.dtype == torch.int32
    assert set(batch.buffer_idx.tolist()) == set(range(16))  # 1,000 draws over 16 entries
    assert int(batch.pixel_idx.max()) < train_inputs.width * train_inputs.height
    expected = train_inputs.pixel_rgba[batch.buffer_idx.long(), batch.pixel_idx.long()].float() / 255
    assert torch.equal(batch.rgba, expected) and bool(batch.ray_light_ok.all())
    again = t_trainer.sample_batch(cfg, train_inputs.pixel_rgba, torch.Generator().manual_seed(0))
    assert torch.equal(again.pixel_idx, batch.pixel_idx)
