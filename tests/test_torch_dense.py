"""The port's dense sampler against the JAX package's: the lattice, the
occupancy filter and both compactions (exactly), the flat-buffer scans and
sums (within fp32 tolerances), the identity-keyed jitter (bit for bit),
`prune_and_render`, the dense `make_train_step` and `make_render_fn`, the
render budgets, and the CLI with `example_synthetic`'s own dense sampler.
Inputs come from numpy seeds and go to both packages; the JAX field is the
fp32 `gather` backend, the port's the kernels' plain versions."""
import dataclasses
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

import humanrf_tpu.train.trainer as j_trainer
from humanrf_torch.convert import convert_params
from humanrf_torch.core.synthetic import SyntheticSceneConfig as TSceneConfig
from humanrf_torch.core.synthetic import generate_synthetic_dataset as t_generate
from humanrf_torch.models.humanrf import HumanRFConfig as THumanRFConfig
from humanrf_torch.models.humanrf import HumanRFModel as THumanRFModel
from humanrf_torch.ops import render as t_render
from humanrf_torch.ops import sampling as t_sampling
from humanrf_torch.run import main as t_main
from humanrf_torch.train import pipeline as t_pipeline
from humanrf_torch.train import trainer as t_trainer
from humanrf_torch.train.checkpoint import load_checkpoint as t_load_checkpoint
from humanrf_torch.utils import rngs as t_rngs
from humanrf_torch.view_inputs import load_dense_inputs, load_train_inputs, load_view_inputs
from humanrf_tpu.models.humanrf import HumanRFConfig, HumanRFModel
from humanrf_tpu.ops import render as j_render
from humanrf_tpu.ops import sampling as j_sampling
from humanrf_tpu.train import pipeline as j_pipeline
from humanrf_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint

torch.set_num_threads(2)

RUN_DIR = Path(__file__).resolve().parent.parent / "runs_evidence" / "r4_full_schedule_748"
STEP = 4e-4


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _cosine(a, b):
    return float(np.dot(a.ravel(), b.ravel()) / (np.linalg.norm(a) * np.linalg.norm(b)))


def _assert_sets_equal(tset, jset):
    for name in t_sampling.SampleSet._fields:
        np.testing.assert_array_equal(_np(getattr(tset, name)), _np(getattr(jset, name)), err_msg=name)


# ------------------------------------------------------------ the sampler

# (rays, lattice, budget, share of invalid rays): the budget overflows mid-ray;
# it holds every sample with an empty tail; no ray is valid.
_SAMPLER_CASES = {
    "overflow": (64, 96, 1500, 0.2),
    "empty_tail": (64, 96, 8192, 0.2),
    "all_invalid": (64, 96, 1500, 1.0),
}


def _sampler_inputs(rays, lattice, invalid_share, seed=0):
    rng = np.random.default_rng(seed)
    origins = rng.uniform(-0.5, 0.5, (rays, 3)).astype(np.float32)
    dirs = rng.normal(size=(rays, 3))
    dirs = (dirs / np.linalg.norm(dirs, axis=1, keepdims=True)).astype(np.float32)
    tmin = rng.uniform(0.0, 0.2, rays).astype(np.float32)
    tmax = (tmin + rng.uniform(-0.01, 1.5 * lattice * STEP, rays)).astype(np.float32)
    valid = rng.random(rays) >= invalid_share
    grids = rng.random((2, 16, 16, 16)) > 0.4
    grid_ids = rng.integers(0, 2, rays).astype(np.int32)
    return tmin, tmax, valid, origins, dirs, grids, grid_ids


@pytest.mark.parametrize("case", list(_SAMPLER_CASES))
def test_generate_and_compact_samples_equal_jax(case):
    """The lattice, the range and occupancy tests and both compactions are
    exact: t, ray, valid, ray_included and num_valid equal JAX's. JAX runs
    op by op, each operation rounded as written (under jit XLA's CPU backend
    contracts tmin + j·step into an fma, one rounding fewer)."""
    rays, lattice, budget, invalid_share = _SAMPLER_CASES[case]
    inputs = _sampler_inputs(rays, lattice, invalid_share)
    jset = j_sampling.generate_samples(*map(jnp.asarray, inputs[:5]), STEP, lattice, budget,
                                       jnp.asarray(inputs[5]), jnp.asarray(inputs[6]))
    tset = t_sampling.generate_samples(*map(torch.tensor, inputs[:5]), STEP, lattice, budget,
                                       torch.tensor(inputs[5]), torch.tensor(inputs[6]))
    _assert_sets_equal(tset, jset)
    count = int(jset.num_valid)
    if case == "overflow":
        assert count == budget and not bool(jset.ray_included.all()) and bool(jset.ray_included[0])
    elif case == "empty_tail":
        assert 0 < count < budget and int(tset.ray[-1]) == rays and float(tset.t[-1]) == 0.0
    else:
        assert count == 0 and bool(tset.ray_included.all())

    # The visibility prune's re-compaction, into a budget that overflows
    # whenever more than half the survivors stay.
    keep = np.random.default_rng(1).random(budget) > 0.3
    budget2 = max(count // 2, 1)
    jflat = j_sampling.compact_flat_samples(jset, jnp.asarray(keep), budget2)
    tflat = t_sampling.compact_flat_samples(tset, torch.tensor(keep), budget2)
    _assert_sets_equal(tflat, jflat)


# ------------------------------------------------------ the flat render ops


def _flat_buffer(num_rays, max_len, tail, seed, scale=1.0):
    """A ray-major buffer: each ray 0..max_len samples, then `tail` empty
    slots (ray == num_rays, value 0)."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, max_len + 1, num_rays)
    ray = np.concatenate([np.repeat(np.arange(num_rays), lengths), np.full(tail, num_rays)]).astype(np.int32)
    values = (rng.exponential(scale, ray.shape) * (ray < num_rays)).astype(np.float32)
    return ray, values


def test_flat_scans_and_sums_match_jax():
    """segmented_cumsum, render_weights_from_density and accumulate_along_rays:
    the same fp32 values summed in tree order (JAX) or along rows (port),
    1e-6 of each output's scale."""
    num_rays, max_len = 300, 40
    ray, sigma = _flat_buffer(num_rays, max_len, tail=500, seed=2, scale=50.0)
    radiance = np.random.default_rng(3).random((len(ray), 3)).astype(np.float32)
    jcs = jax.jit(j_render.segmented_cumsum)(jnp.asarray(sigma), jnp.asarray(ray))
    tcs = t_render.segmented_cumsum(torch.tensor(sigma), torch.tensor(ray), num_rays, max_len)
    np.testing.assert_allclose(_np(tcs), _np(jcs), rtol=1e-6, atol=1e-6 * float(np.abs(_np(jcs)).max()))

    jsam = j_sampling.SampleSet(jnp.zeros(len(ray)), jnp.asarray(ray), jnp.asarray(ray < num_rays), None, None)
    tsam = t_sampling.SampleSet(torch.zeros(len(ray)), torch.tensor(ray), torch.tensor(ray < num_rays), None, None)
    jw = jax.jit(lambda d, st: j_render.render_weights_from_density(d, st, num_rays, STEP))(jnp.asarray(sigma), jsam)
    tw = t_render.render_weights_from_density(torch.tensor(sigma), tsam, num_rays, STEP, max_len)
    np.testing.assert_allclose(_np(tw), _np(jw), rtol=0, atol=1e-6)
    assert float(_np(jw).sum()) > 10  # the weights are not all negligible
    for values in (None, radiance):
        ja = j_render.accumulate_along_rays(jw, jnp.asarray(ray), num_rays, None if values is None else jnp.asarray(values))
        ta = t_render.accumulate_along_rays(tw, torch.tensor(ray), num_rays, max_len,
                                            None if values is None else torch.tensor(values))
        assert ta.shape == ja.shape
        np.testing.assert_allclose(_np(ta), _np(ja), rtol=0, atol=1e-6)


def _threshold_margin(alphas, transmittance):
    """Relative distance of each sample's alpha or transmittance to the 1e-4 bar."""
    return np.minimum(np.abs(alphas / 1e-4 - 1), np.abs(transmittance / 1e-4 - 1))


def test_render_visibility_matches_jax():
    """Visible iff alpha ≥ 1e-4 and the kept transmittance > 1e-4. The same
    fp32 alphas; log1p and the scans in another order may flip a sample
    within an fp32 rounding of a bar, and only such a sample may differ."""
    num_rays, max_len = 400, 64
    ray, _ = _flat_buffer(num_rays, max_len, tail=300, seed=4)
    rng = np.random.default_rng(5)
    alphas = np.where(rng.random(len(ray)) < 0.3, rng.uniform(0, 2e-4, len(ray)), rng.uniform(0, 0.6, len(ray)))
    alphas = alphas.astype(np.float32) * (ray < num_rays)
    jsam = j_sampling.SampleSet(jnp.zeros(len(ray)), jnp.asarray(ray), jnp.asarray(ray < num_rays), None, None)
    tsam = t_sampling.SampleSet(torch.zeros(len(ray)), torch.tensor(ray), torch.tensor(ray < num_rays), None, None)
    jv = _np(jax.jit(lambda a, st: j_render.render_visibility(a, st, num_rays))(jnp.asarray(alphas), jsam))
    tv = _np(t_render.render_visibility(torch.tensor(alphas), tsam, num_rays, max_len))
    assert 0.2 < jv.mean() < 0.8
    # Transmittance over the kept samples before each one, in float64.
    keep = (ray < num_rays) & (alphas >= 1e-4)
    neg_log = np.where(keep, -np.log1p(-np.clip(alphas.astype(np.float64), 0, 1 - 1e-7)), 0.0)
    excl = np.zeros_like(neg_log)
    for r in range(num_rays):
        idx = np.nonzero(ray == r)[0]
        excl[idx] = np.cumsum(neg_log[idx]) - neg_log[idx]
    flips = np.nonzero(tv != jv)[0]
    print(f"render_visibility: {len(flips)} of {len(ray)} samples differ from JAX")
    assert (_threshold_margin(alphas[flips], np.exp(-excl[flips])) < 1e-5).all()


def test_segmented_cumsum_keeps_fp32_precision_on_long_rays():
    """120k samples in rays of up to 1,000, the first rays with values of 1e4:
    the within-ray sums hold to fp32 rounding of the ray's own sum against a
    float64 per-ray oracle, where one fp32 cumsum over the buffer minus each
    ray's offset loses ~1e-2 of a late ray's sum."""
    num_rays, max_len = 240, 1000
    ray, values = _flat_buffer(num_rays, max_len, tail=0, seed=6)
    values[ray < 20] *= 1e4
    assert len(ray) >= 100_000
    port = _np(t_render.segmented_cumsum(torch.tensor(values), torch.tensor(ray), num_rays, max_len)).astype(np.float64)
    naive = np.cumsum(values, dtype=np.float32)
    starts = np.searchsorted(ray, ray)
    naive = naive - np.where(starts > 0, naive[starts - 1], 0)
    worst_port = worst_naive = 0.0
    for r in range(20, num_rays):
        idx = np.nonzero(ray == r)[0]
        if not len(idx):
            continue
        oracle = np.cumsum(values[idx].astype(np.float64))
        worst_port = max(worst_port, np.abs(port[idx] - oracle).max() / oracle[-1])
        worst_naive = max(worst_naive, np.abs(naive[idx] - oracle).max() / oracle[-1])
    assert worst_port < 1e-6, worst_port
    assert worst_naive > 1e-3, worst_naive  # the form the port avoids


# -------------------------------------------------- pipeline-level parity

# Two 25-frame segments at the r4 scene's frames, L2/F2 grids at T = 2^9 per
# segment, narrow MLPs, no proposal (dense models have none); density scale 10
# (tests/test_torch_train.py says why).
_SMALL = dict(
    sorted_frame_numbers=tuple(range(50)), segment_sizes=(25, 25), density_scale=10.0, n_levels=2, n_features_per_level=2,
    log2_hashmap_size=11, coarsest_resolution=4, finest_resolution=32, geometry_feature_dim=3,
    n_neurons=16, n_hidden_layers_density=1, n_hidden_layers_color=1, sh_degree=2, camera_embedding_dim=2,
)
# 128 supervised slots from 256 candidates; ~110 rays hit the actor with
# ~450 lattice points each, so both budgets overflow on a few rays.
_DENSE_PCFG = dict(
    sampling="dense", num_rays=128, candidate_rays_factor=2, samples_per_ray=512, candidate_budget=40_960,
    sample_budget=32_768, march_grid_factor=2, bce_loss_weight=1e-3, huber_delta=0.01,
)


@pytest.fixture(scope="module")
def train_inputs():
    return load_train_inputs(RUN_DIR / "torch_train_inputs.npz", "cpu")


@pytest.fixture(scope="module")
def small_models():
    jmodel = HumanRFModel(HumanRFConfig(**_SMALL, field_backend="gather"))
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    tmodel = THumanRFModel(THumanRFConfig(**_SMALL))
    tmodel.load_state_dict(convert_params(jax.tree_util.tree_map(np.asarray, jparams)))
    return jmodel, jparams, tmodel


def _batch(train_inputs, num, seed, on_actor):
    """`num` candidate pixels: `on_actor` inside the images' masks, the rest
    uniform (tests/test_torch_train.py's draw)."""
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
    tbatch = t_pipeline.HostBatch(torch.tensor(buffer_idx), torch.tensor(pixel_idx), torch.tensor(rgba),
                                  torch.ones(n, dtype=torch.bool))
    jpool = j_pipeline.PoolArrays(*(jnp.asarray(_np(a)) for a in train_inputs.pool))
    return jbatch, tbatch, jpool


@pytest.fixture(scope="module")
def dense_rays(train_inputs):
    """One batch's rays and candidate samples from the JAX package, the same
    arrays handed to both packages' prune_and_render."""
    cfg = j_pipeline.PipelineConfig(**{**_DENSE_PCFG, "candidate_rays_factor": 1})
    buffer_idx, pixel_idx, rgba = _batch(train_inputs, 128, seed=8, on_actor=70)
    jbatch, _, jpool = _both_batches(train_inputs, buffer_idx, pixel_idx, rgba)
    jgrids = jnp.asarray(_np(train_inputs.grids))

    @jax.jit
    def build(batch, pool, grids, aabb):
        rays = j_pipeline.build_rays(cfg, batch, pool, grids, aabb, train_inputs.width, train_inputs.height)
        return rays, j_pipeline.build_samples(cfg, rays, pool, grids, batch.buffer_idx)

    rays, samples = build(jbatch, jpool, jgrids, jnp.asarray(_np(train_inputs.aabb)))
    trays = t_pipeline.RayData(*(torch.tensor(_np(f)) for f in rays))
    tsamples = t_sampling.SampleSet(*(torch.tensor(_np(f)) for f in samples))
    return cfg, rays, samples, trays, tsamples


@pytest.fixture(scope="module")
def opaque_models():
    """The small model at density scale 300: a fresh field then reaches the
    1e-4 transmittance bar ~80 samples into the actor, so the prune culls."""
    config = {**_SMALL, "density_scale": 300.0}
    jmodel = HumanRFModel(HumanRFConfig(**config, field_backend="gather"))
    jparams = jmodel.init_params(jax.random.PRNGKey(1))
    tmodel = THumanRFModel(THumanRFConfig(**config))
    tmodel.load_state_dict(convert_params(jax.tree_util.tree_map(np.asarray, jparams)))
    return jmodel, jparams, tmodel


def _dense_cfgs(dense_rays, **overrides):
    jcfg = dataclasses.replace(dense_rays[0], **overrides)
    return jcfg, t_pipeline.PipelineConfig(**{**_DENSE_PCFG, "candidate_rays_factor": 1, **overrides})


def test_training_jitter_is_bit_equal_to_jax_at_valid_slots(small_models, dense_rays, monkeypatch):
    """The jitter t + U[0, step), keyed by ray id · samples_per_ray + lattice
    slot, as each package hands it to `render` (captured there; JAX op by
    op). Equal bit for bit at every valid slot. Empty slots may differ: JAX
    computes their ids in wrapping int32 from a negative lattice slot."""
    jmodel, jparams, tmodel = small_models
    _, rays, samples, trays, tsamples = dense_rays
    jcfg, tcfg = _dense_cfgs(dense_rays, use_visibility_prune=False)
    captured = {}

    def capture(name):
        def fake_render(forward_fn, rendered, *args, **kwargs):
            captured[name] = rendered
            return None
        return fake_render

    monkeypatch.setattr(j_pipeline, "render", capture("jax"))
    monkeypatch.setattr(t_pipeline, "render", capture("port"))
    j_pipeline.prune_and_render(jcfg, jmodel, jparams, rays, samples, 0.0, jax.random.PRNGKey(21), is_training=True)
    t_pipeline.prune_and_render(tcfg, tmodel, trays, tsamples, 0.0, t_rngs.make_key(21))
    n = int(samples.num_valid)
    assert n > 10_000
    jt, tt = _np(captured["jax"].t)[:n], _np(captured["port"].t)[:n]
    np.testing.assert_array_equal(tt, jt)
    moved = (jt - _np(samples.t)[:n]) / STEP
    assert 0 <= moved.min() and moved.max() < 1.001 and 0.45 < moved.mean() < 0.55


def _unmatched(jset, tset):
    """Samples of either pruned set with no sample of the same ray within 1e-6
    in t in the other (XLA's fma moves a jittered t by an ulp)."""
    def keys(st):
        n = int(st.num_valid)
        return np.sort(_np(st.ray)[:n].astype(np.float64) * 16.0 + _np(st.t)[:n])

    a, b = keys(jset), keys(tset)
    def missing(x, y):
        i = np.clip(np.searchsorted(y, x), 1, len(y) - 1)
        return int((np.minimum(np.abs(y[i] - x), np.abs(y[i - 1] - x)) > 1e-6).sum())
    return missing(a, b) + missing(b, a)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "training"])
def test_prune_and_render_matches_jax(opaque_models, dense_rays, training):
    """The same rays and candidates through both packages' prune_and_render
    (JAX jitted): colors and accumulated alpha within 1e-5 absolute (values
    ≤ 1, fp32 sums in another order). The pruned sets hold the same samples
    but for those whose alpha or transmittance lies within an fp32 rounding
    of the 1e-4 bars (counted and printed, at most 1e-4 of them); the ray
    inclusions are equal."""
    jmodel, jparams, tmodel = opaque_models
    _, rays, samples, trays, tsamples = dense_rays
    jcfg, tcfg = _dense_cfgs(dense_rays)
    background = np.random.default_rng(9).random((jcfg.num_rays, 3)).astype(np.float32)
    key = jax.random.PRNGKey(21) if training else None
    jout, jset = jax.jit(
        lambda p, r, s, bg, k: j_pipeline.prune_and_render(jcfg, jmodel, p, r, s, bg, k, is_training=training)
    )(jparams, rays, samples, jnp.asarray(background), key)
    with torch.no_grad():
        tout, tset = t_pipeline.prune_and_render(tcfg, tmodel, trays, tsamples, torch.tensor(background),
                                                 t_rngs.make_key(21) if training else None)
    np.testing.assert_allclose(_np(tout.color), _np(jout.color), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tout.weights_sum), _np(jout.weights_sum), rtol=0, atol=1e-5)
    assert 0.05 < float(_np(jout.weights_sum).mean()) < 0.95

    jn, tn = int(jset.num_valid), int(tset.num_valid)
    differ = _unmatched(jset, tset)
    print(f"prune ({'training' if training else 'eval'}): {jn} of {int(samples.num_valid)} samples kept by JAX, "
          f"{tn} by the port, {differ} differ")
    assert 0 < jn < 0.8 * int(samples.num_valid)  # the prune culled
    assert differ <= 1e-4 * jn
    np.testing.assert_array_equal(_np(tset.ray_included), _np(jset.ray_included))


def _jax_dense_loss_fn(cfg, model, width, height):
    """The JAX dense step's loss as a function of its inputs: `make_train_step`'s
    body up to `value_and_grad`."""

    def loss_fn(params, rng, batch, pool, grids, aabb):
        rays = j_pipeline.build_rays(cfg, batch, pool, grids, aabb, width, height)
        ray_ids = jnp.arange(cfg.num_rays * cfg.candidate_rays_factor, dtype=jnp.int32)
        rays, b, ray_ids = j_pipeline.compact_rays(rays, batch, ray_ids, cfg.num_rays)
        samples = j_pipeline.build_samples(cfg, rays, pool, grids, b.buffer_idx)
        return j_pipeline.training_loss(cfg, model, params, rays, samples, b.rgba, rng, ray_ids=ray_ids)

    return loss_fn


def test_dense_train_step_matches_jax(small_models, train_inputs):
    """The dense step (2× candidate rays, jitter, prune, render, loss) on the
    same params, batch and key: loss and aux within 1e-5 relative,
    `num_samples` and `num_rays_supervised` equal (some rays overflow the
    budgets and are left out), gradients per leaf at cosine ≥ 0.999."""
    jmodel, jparams, _ = small_models
    tmodel = THumanRFModel(THumanRFConfig(**_SMALL))
    tmodel.load_state_dict(convert_params(jax.tree_util.tree_map(np.asarray, jparams)))
    jcfg = j_pipeline.PipelineConfig(**_DENSE_PCFG)
    tcfg = t_pipeline.PipelineConfig(**_DENSE_PCFG)
    buffer_idx, pixel_idx, rgba = _batch(train_inputs, 256, seed=10, on_actor=115)
    jbatch, tbatch, jpool = _both_batches(train_inputs, buffer_idx, pixel_idx, rgba)
    grids, aabb, w, h = train_inputs.grids, train_inputs.aabb, train_inputs.width, train_inputs.height

    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(_jax_dense_loss_fn(jcfg, jmodel, w, h), has_aux=True))(
        jparams, jax.random.PRNGKey(5), jbatch, jpool, jnp.asarray(_np(grids)), jnp.asarray(_np(aabb))
    )
    topt = t_trainer.make_optimizer(tmodel.named_parameters(), 1e-2, 0.5, 50_001, weight_decay=0.03)
    tloss, taux = t_pipeline.make_train_step(tcfg, tmodel, topt, w, h)(
        tbatch, train_inputs.pool, grids, aabb, t_rngs.make_key(5)
    )
    assert set(taux) == set(jaux)
    assert int(taux["num_samples"]) == int(jaux["num_samples"])
    assert int(taux["num_rays_supervised"]) == int(jaux["num_rays_supervised"])
    assert 20 < int(jaux["num_rays_supervised"]) < int(jnp.sum(jbatch.rgba[:, 3] > 0))  # overflowed rays left out
    assert _rel(tloss, jloss) <= 1e-5
    for k, v in jaux.items():
        assert _rel(taux[k], v) <= 1e-5, k
    jflat = convert_params(jax.tree_util.tree_map(np.asarray, jgrads))
    assert set(jflat) == {n for n, _ in tmodel.named_parameters()}
    for name, p in tmodel.named_parameters():
        tg, jg = _np(p.grad), _np(jflat[name])
        assert np.abs(jg).max() > 0, name
        assert _cosine(tg, jg) >= 0.999, name


# ---------------------------------------------------------- render and trainer


def test_dense_render_fn_matches_the_baked_jax_render():
    """best.ckpt (trained with proposal sampling; its field renders under
    either sampler) through the port's dense `make_render_fn`, one 32×32
    batch of the patch that `scripts/make_torch_dense_inputs.py` rendered
    with the JAX package (fp32 gather field), at the baked settings, whose
    budgets hold every sample: colors and accumulated alpha within 2e-3 (fp32
    sums and the bf16 MLP's accumulation differ, as in the proposal render's
    test)."""
    view = load_view_inputs(RUN_DIR / "torch_view_inputs.npz", "cpu")
    dense = load_dense_inputs(RUN_DIR / "torch_dense_inputs.npz", "cpu")
    params, _, _, _, _ = t_load_checkpoint(RUN_DIR / "best.ckpt")
    tmodel = THumanRFModel(view.model_config)
    tmodel.load_state_dict(convert_params(params))
    block = int(np.argmin(dense.jax_weights_sum.mean(axis=1)))  # the batch with the most background
    pixel_idx = dense.pixel_idx[block]
    n = pixel_idx.shape[0]
    batch = t_pipeline.HostBatch(torch.full((n,), view.inputs.buffer_index, dtype=torch.int32), pixel_idx,
                                 torch.zeros((n, 4)), torch.ones(n, dtype=torch.bool))
    inputs = (view.inputs.pool, view.inputs.grids, view.inputs.aabb)
    tout, _ = t_pipeline.make_render_fn(dense.pipeline_config, tmodel, view.inputs.width, view.inputs.height)(
        batch, *inputs, 0.0)
    rays = t_pipeline.build_rays(dense.pipeline_config, batch, *inputs, view.inputs.width, view.inputs.height)
    candidates = t_pipeline.build_samples(dense.pipeline_config, rays, view.inputs.pool, view.inputs.grids,
                                          batch.buffer_idx)
    assert bool(candidates.ray_included.all()) and int(candidates.num_valid) > 100 * n
    assert 0.5 < float(tout.weights_sum.mean()) < 0.99
    assert np.abs(_np(tout.color) - dense.jax_color[block]).max() <= 2e-3
    assert np.abs(_np(tout.weights_sum)[:, 0] - dense.jax_weights_sum[block]).max() <= 2e-3


@pytest.mark.parametrize("batch_size", [1, 100, 1024, 16_384, 40_000])
def test_render_budgets_scale_as_the_jax_trainer(batch_size, monkeypatch):
    """`render_pipeline_config` against the JAX `Trainer._get_render_fn`'s
    budgets for the same training settings."""
    kw = dict(num_rays=1024, candidate_budget=131_072, sample_budget=65_536 + 77)
    monkeypatch.setattr(j_trainer, "make_render_fn", lambda pcfg, model, width, height: pcfg)
    fake = types.SimpleNamespace(pcfg=j_pipeline.PipelineConfig(**kw), resolution=(8, 8), _render_fns={}, model=None)
    jcfg = j_trainer.Trainer._get_render_fn(fake, batch_size)
    tcfg = t_trainer.render_pipeline_config(t_pipeline.PipelineConfig(**kw), batch_size)
    assert (tcfg.num_rays, tcfg.candidate_budget, tcfg.sample_budget) == (
        jcfg.num_rays, jcfg.candidate_budget, jcfg.sample_budget)
    assert tcfg.candidate_budget % 128 == 0 and tcfg.candidate_budget >= 128


# ------------------------------------------------------------------- the CLI

_CLI_FLAGS = [
    "--config", "example_synthetic", "--device", "cpu", "--dataset.deterministic_loader", "true",
    "--dataset.max_buffer_size", "3", "--training.max_steps", "20", "--training.rays_initial_batch_size", "128",
    "--training.samples_max_batch_size", "16384", "--training.save_checkpoint_every_n_steps", "10",
    "--validation.every_n_steps", "20", "--validation.rays_batch_size", "400", "--test.rays_batch_size", "400",
    "--model.log2_hashmap_size", "12", "--model.n_levels", "4", "--model.finest_resolution", "128",
    "--model.density_scale", "10", "--evaluate", "true", "--evaluation.frame_numbers", "0",
]


@pytest.fixture(scope="module")
def dense_cli(tmp_path_factory):
    """example_synthetic's own sampler (dense) on a tiny scene written by the port."""
    root = tmp_path_factory.mktemp("dense_cli")
    t_generate(root, TSceneConfig(num_cameras=6, width=40, height=40, num_frames=2, grid_resolution=32))
    ws = root / "ws"
    result = t_main([*_CLI_FLAGS, "--dataset.path", str(root), "--workspace", str(ws)])
    return ws, result


def test_dense_cli_trains_validates_saves_and_evaluates(dense_cli):
    ws, result = dense_cli
    files = {str(p.relative_to(ws)) for p in ws.rglob("*") if p.is_file()}
    assert {"config.yaml", "derived_split.json", "validation.txt", "checkpoints/best.ckpt",
            "checkpoints/step_00000010.ckpt", "checkpoints/step_00000020.ckpt",
            "results/metrics.csv", "results/averages.csv"} <= files
    assert any(f.startswith("results/test_frames/") for f in files)
    assert "sampling: \"dense\"" in (ws / "config.yaml").read_text()
    stats = result["train"]
    assert stats["skipped_nonfinite"] == 0 and stats["end_step"] == 21
    assert np.isfinite(result["averages"]["PSNR"])


def test_dense_checkpoint_is_the_jax_dense_models_tree(dense_cli):
    """No proposal factors: the parameter tree is that of the JAX model the
    JAX CLI builds for these flags, leaf for leaf, and the JAX package loads it."""
    ws, _ = dense_cli
    jmodel = HumanRFModel(HumanRFConfig(
        sorted_frame_numbers=(0, 1), segment_sizes=(2,), density_scale=10.0, log2_hashmap_size=12, n_levels=4,
        finest_resolution=128, camera_embedding_dim=0, proposal_rank=0,
    ))
    template = jmodel.init_params(jax.random.PRNGKey(0))
    params, _, step, _, _ = t_load_checkpoint(ws / "checkpoints" / "best.ckpt")

    def leaves(tree):
        flat = jax.tree_util.tree_leaves_with_path(serialization.to_state_dict(tree))
        return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}

    assert {k: v.shape for k, v in leaves(params).items()} == {k: v.shape for k, v in leaves(template).items()}
    assert "proposal" not in params
    jparams, _, jstep, _, _ = j_load_checkpoint(ws / "checkpoints" / "best.ckpt", template, None)
    assert jstep == step == 20
    loaded, written = leaves(jparams), leaves(params)
    for k, v in written.items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)
