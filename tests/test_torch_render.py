"""The port's render path (humanrf_torch/ops, humanrf_torch/train) against the
JAX package's: rays, the occupancy march, resampling, compositing, and
`make_render_fn` as a whole, on the trained r4 checkpoint and on a tiny
two-segment model."""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from humanrf_torch.convert import convert_params
from humanrf_torch.models.humanrf import HumanRFConfig as THumanRFConfig
from humanrf_torch.models.humanrf import HumanRFModel as THumanRFModel
from humanrf_torch.ops import occupancy as t_occ
from humanrf_torch.ops import rays as t_rays
from humanrf_torch.ops import render as t_render
from humanrf_torch.ops import resample as t_resample
from humanrf_torch.train import pipeline as t_pipeline
from humanrf_torch.train.checkpoint import load_checkpoint as t_load_checkpoint
from humanrf_torch.train.trainer import ViewInputs, render_image
from humanrf_torch.view_inputs import load_view_inputs
from humanrf_tpu.models.humanrf import HumanRFConfig, HumanRFModel
from humanrf_tpu.ops import occupancy as j_occ
from humanrf_tpu.ops import rays as j_rays
from humanrf_tpu.ops import render as j_render
from humanrf_tpu.ops import resample as j_resample
from humanrf_tpu.train import pipeline as j_pipeline
from humanrf_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint

torch.set_num_threads(2)

RUN_DIR = Path(__file__).resolve().parent.parent / "runs_evidence" / "r4_full_schedule_748"


@pytest.fixture(scope="module")
def view():
    return load_view_inputs(RUN_DIR / "torch_view_inputs.npz", "cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _jax_pool(pool):
    return j_pipeline.PoolArrays(*(jnp.asarray(_np(a)) for a in pool))


def _edge_patch(mask, size=16):
    """Flat pixel ids of a size×size patch centred where the middle row of
    the silhouette first enters the mask."""
    ys, _ = np.nonzero(mask)
    row = (ys.min() + ys.max()) // 2
    col = int(np.nonzero(mask[row])[0][0])
    yy, xx = np.meshgrid(np.arange(row - size // 2, row + size // 2), np.arange(col - size // 2, col + size // 2), indexing="ij")
    return (yy * mask.shape[1] + xx).reshape(-1).astype(np.int32)


def _rays(view, n=512, seed=0):
    """Rays of the test camera through random pixels (numpy)."""
    rng = np.random.default_rng(seed)
    inv_kr = _np(view.inputs.pool.inverse_krs)
    origins = _np(view.inputs.pool.camera_origins)
    px = rng.uniform(0, view.inputs.width, n).astype(np.float32)
    py = rng.uniform(0, view.inputs.height, n).astype(np.float32)
    return inv_kr, origins, np.zeros(n, np.int32), px, py


def test_pixel_to_ray_and_aabb_match_jax(view):
    """fp32 3×3 products and a slab test on both sides; 1e-6 absolute."""
    inv_kr, origins, image, px, py = _rays(view)
    jo, jd = j_rays.pixel_to_ray(jnp.asarray(inv_kr), jnp.asarray(origins), jnp.asarray(image), jnp.asarray(px), jnp.asarray(py))
    to, td = t_rays.pixel_to_ray(torch.tensor(inv_kr), torch.tensor(origins), torch.tensor(image).long(), torch.tensor(px), torch.tensor(py))
    np.testing.assert_allclose(_np(to), _np(jo), rtol=0, atol=1e-6)
    np.testing.assert_allclose(_np(td), _np(jd), rtol=0, atol=1e-6)
    aabb = _np(view.inputs.aabb)
    jt = j_rays.aabb_intersect(jo, jd, jnp.asarray(aabb))
    tt = t_rays.aabb_intersect(to, td, torch.tensor(aabb))
    for a, b in zip(tt, jt):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-6, atol=1e-6)


def test_occupancy_grid_ops_match_jax(view):
    grids = _np(view.inputs.grids)
    raw = np.random.default_rng(1).random((16, 16, 16)) > 0.9
    np.testing.assert_array_equal(
        _np(t_occ.dilate_grid(torch.tensor(raw.astype(np.uint8) * 255))),
        _np(j_occ.dilate_grid(jnp.asarray(raw.astype(np.uint8) * 255))),
    )
    np.testing.assert_array_equal(_np(t_occ.coarsen_grid(torch.tensor(grids), 2)), _np(j_occ.coarsen_grid(jnp.asarray(grids), 2)))
    pts = np.random.default_rng(2).uniform(-0.1, 1.1, (4000, 3)).astype(np.float32)
    ids = np.zeros(4000, np.int32)
    np.testing.assert_array_equal(
        _np(t_occ.sample_occupancy(torch.tensor(grids), torch.tensor(ids), torch.tensor(pts))),
        _np(j_occ.sample_occupancy(jnp.asarray(grids), jnp.asarray(ids), jnp.asarray(pts))),
    )


def test_occupancy_ray_minmax_matches_jax(view):
    """The same march, bisection and backward march in fp32: tmin/tmax agree
    to 1e-5 (one fp32 rounding of a t near 3)."""
    inv_kr, origins, image, px, py = _rays(view, n=2048, seed=3)
    o, d = j_rays.pixel_to_ray(jnp.asarray(inv_kr), jnp.asarray(origins), jnp.asarray(image), jnp.asarray(px), jnp.asarray(py))
    o, d = _np(o), _np(d)
    tmin, tmax = (_np(a) for a in j_rays.aabb_intersect(jnp.asarray(o), jnp.asarray(d), jnp.asarray(_np(view.inputs.aabb))))
    grids = _np(t_occ.coarsen_grid(view.inputs.grids, 2))
    ids = np.zeros(len(o), np.int32)
    jmin, jmax = j_occ.occupancy_ray_minmax(*(jnp.asarray(a) for a in (o, d, tmin, tmax, grids, ids)))
    tmin_t, tmax_t = t_occ.occupancy_ray_minmax(*(torch.tensor(a) for a in (o, d, tmin, tmax, grids, ids)))
    assert (_np(jmin) < _np(jmax)).sum() > 100  # rays that hit the actor
    np.testing.assert_allclose(_np(tmin_t), _np(jmin), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tmax_t), _np(jmax), rtol=0, atol=1e-5)


def test_resample_and_composite_match_jax():
    """Bins, CDF, inverse-CDF draw and compositing: fp32 cumsums whose order
    may differ, 1e-5 absolute on t in [2, 4] and on weights and colors ≤ 1."""
    rng = np.random.default_rng(4)
    R, K, S = 300, 32, 16
    tmin = rng.uniform(2.0, 3.0, R).astype(np.float32)
    tmax = (tmin + rng.uniform(0.0, 1.0, R)).astype(np.float32)
    tmax[:5] = tmin[:5]  # empty spans
    density = rng.exponential(20.0, (R, K)).astype(np.float32)
    mask = rng.random((R, K)) > 0.2
    radiance = rng.random((R, S, 3)).astype(np.float32)

    jt, jdt, jedges = j_resample.stratified_bins(jnp.asarray(tmin), jnp.asarray(tmax), K)
    tt, tdt, tedges = t_resample.stratified_bins(torch.tensor(tmin), torch.tensor(tmax), K)
    for a, b in ((tt, jt), (tdt, jdt), (tedges, jedges)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-5)

    jw = j_render.render_weights_grid(jnp.asarray(density), jdt, jnp.asarray(mask))
    tw = t_render.render_weights_grid(torch.tensor(density), tdt, torch.tensor(mask))
    np.testing.assert_allclose(_np(tw), _np(jw), rtol=0, atol=1e-5)

    jcdf = j_resample.weights_to_cdf(jw, 0.05)
    tcdf = t_resample.weights_to_cdf(tw, 0.05)
    np.testing.assert_allclose(_np(tcdf), _np(jcdf), rtol=0, atol=1e-5)

    jmid, jdtf, jedges_f = j_resample.sample_intervals(jedges, jcdf, S, return_edges=True)
    tmid, tdtf, tedges_f = t_resample.sample_intervals(tedges, tcdf, S, return_edges=True)
    for a, b in ((tmid, jmid), (tdtf, jdtf), (tedges_f, jedges_f)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-5)

    dens_f = density[:, :S]
    jwf = j_render.render_weights_grid(jnp.asarray(dens_f), jdtf)
    twf = t_render.render_weights_grid(torch.tensor(dens_f), tdtf)
    jout = j_render.composite_grid(jwf, jnp.asarray(radiance), 0.25)
    tout = t_render.composite_grid(twf, torch.tensor(radiance), 0.25)
    np.testing.assert_allclose(_np(tout.color), _np(jout.color), rtol=0, atol=1e-5)
    np.testing.assert_allclose(_np(tout.weights_sum), _np(jout.weights_sum), rtol=0, atol=1e-5)


def _render_both(jax_model, jax_params, torch_model, pcfg_kwargs, pool, grids, aabb, width, height, buffer_idx, pixel_idx):
    """One batch through both packages' make_render_fn (JAX: gather backend)."""
    n = len(pixel_idx)
    jcfg = j_pipeline.PipelineConfig(num_rays=n, sampling="proposal", **pcfg_kwargs)
    jfn = j_pipeline.make_render_fn(jcfg, jax_model, width, height)
    jbatch = j_pipeline.HostBatch(
        buffer_idx=jnp.asarray(buffer_idx), pixel_idx=jnp.asarray(pixel_idx),
        rgba=jnp.zeros((n, 4), jnp.float32), ray_light_ok=jnp.ones(n, bool),
    )
    jout, jvalid = jfn(jax_params, jbatch, _jax_pool(pool), jnp.asarray(_np(grids)), jnp.asarray(_np(aabb)), 0.0)

    tcfg = t_pipeline.PipelineConfig(sampling="proposal", **pcfg_kwargs)
    tfn = t_pipeline.make_render_fn(tcfg, torch_model, width, height)
    tbatch = t_pipeline.HostBatch(
        torch.tensor(buffer_idx), torch.tensor(pixel_idx), torch.zeros((n, 4)), torch.ones(n, dtype=torch.bool)
    )
    tout, tvalid = tfn(tbatch, pool, grids, aabb, 0.0)
    np.testing.assert_array_equal(_np(tvalid), _np(jvalid))
    return _np(tout.color), _np(jout.color), _np(tout.weights_sum), _np(jout.weights_sum)


def _pcfg_kwargs(pcfg):
    return dict(
        march_grid_factor=pcfg.march_grid_factor,
        proposal_samples_per_ray=pcfg.proposal_samples_per_ray,
        render_samples_per_ray=pcfg.render_samples_per_ray,
        proposal_mid_samples_per_ray=pcfg.proposal_mid_samples_per_ray,
        proposal_uniform_bonus=pcfg.proposal_uniform_bonus,
    )


def test_render_fn_matches_jax_on_trained_checkpoint(view):
    """best.ckpt's real weights at the r4 widths, the test view's camera and
    grid, a 16×16 patch across the silhouette edge. The JAX side uses the
    fp32 gather backend; the port's lookups are fp32 too, so what differs is
    fp32 summation order and the bf16 MLP's accumulation: 2e-3 max abs on
    colors in [0, 1]."""
    mc = view.model_config
    jax_model = HumanRFModel(HumanRFConfig(**{**mc.__dict__, "field_backend": "gather"}))
    template = jax_model.init_params(jax.random.PRNGKey(0))
    jax_params, _, _, _, _ = j_load_checkpoint(RUN_DIR / "best.ckpt", template, None)

    params, _, step, _, _ = t_load_checkpoint(RUN_DIR / "best.ckpt")
    torch_model = THumanRFModel(mc)
    torch_model.load_state_dict(convert_params(params))

    pixel_idx = _edge_patch(view.images["gt_mask"])
    buffer_idx = np.full(len(pixel_idx), view.inputs.buffer_index, np.int32)
    tc, jc, tw, jw = _render_both(
        jax_model, jax_params, torch_model, _pcfg_kwargs(view.pipeline_config),
        view.inputs.pool, view.inputs.grids, view.inputs.aabb, view.inputs.width, view.inputs.height,
        buffer_idx, pixel_idx,
    )
    assert step == 17500
    assert 0.05 < tw.mean() < 0.95  # the patch holds both actor and background
    assert np.max(np.abs(tc - jc)) <= 2e-3
    assert np.max(np.abs(tw - jw)) <= 2e-3


def _two_segment_models():
    """A tiny random model with two segments, in both packages (JAX: the
    gather backend), with features well away from the ±1e-4 init."""
    cfg = dict(
        sorted_frame_numbers=(0, 1, 2, 3), segment_sizes=(2, 2), n_levels=2, n_features_per_level=2,
        log2_hashmap_size=12, coarsest_resolution=4, finest_resolution=64, geometry_feature_dim=3,
        n_neurons=16, n_hidden_layers_density=1, n_hidden_layers_color=1, sh_degree=2,
        camera_embedding_dim=2, proposal_rank=4, proposal_resolution=16,
    )
    jax_model = HumanRFModel(HumanRFConfig(**cfg, field_backend="gather"))
    params = jax.tree_util.tree_map(np.asarray, jax_model.init_params(jax.random.PRNGKey(3)))
    for seg in params["segments"]:
        for name in ("xyz", "xyt", "yzt", "xzt"):
            seg[name] = seg[name] * 3e3
    torch_model = THumanRFModel(THumanRFConfig(**cfg))
    torch_model.load_state_dict(convert_params(params))
    return jax_model, params, torch_model


def _two_frame_pool(view, inverse_krs=None):
    """The test view's camera twice, at frames 1 and 3 (segments 0 and 1)."""
    pool0 = view.inputs.pool
    inverse_krs = pool0.inverse_krs if inverse_krs is None else inverse_krs
    return t_pipeline.PoolArrays(
        inverse_krs=inverse_krs.repeat(2, 1, 1),
        camera_origins=pool0.camera_origins.repeat(2, 1),
        landscape=pool0.landscape.repeat(2),
        frame_numbers=torch.tensor([1, 3], dtype=torch.int32),
        camera_numbers=pool0.camera_numbers.repeat(2),
        grid_slots=torch.zeros(2, dtype=torch.int32),
    )


def _small_pcfg_kwargs(mid_samples=0):
    return dict(
        march_grid_factor=2, proposal_samples_per_ray=16, render_samples_per_ray=8,
        proposal_mid_samples_per_ray=mid_samples, proposal_uniform_bonus=0.05,
    )


@pytest.mark.parametrize("mid_samples", [0, 8], ids=["one-level", "two-level"])
def test_render_fn_matches_jax_on_two_segment_model(view, mid_samples):
    """A tiny random model whose batch has rays in both segments: the port
    routes samples to their segment by index selection, JAX by masking. The
    second case adds the second proposal level."""
    jax_model, params, torch_model = _two_segment_models()
    pool = _two_frame_pool(view)
    patch = _edge_patch(view.images["gt_mask"], size=8)
    pixel_idx = np.concatenate([patch, patch])
    buffer_idx = np.repeat(np.arange(2, dtype=np.int32), len(patch))
    kwargs = _small_pcfg_kwargs(mid_samples)
    tc, jc, tw, jw = _render_both(
        jax_model, jax.tree_util.tree_map(jnp.asarray, params), torch_model, kwargs,
        pool, view.inputs.grids, view.inputs.aabb, view.inputs.width, view.inputs.height, buffer_idx, pixel_idx,
    )
    n = len(patch)
    assert np.abs(tc[:n] - tc[n:]).max() > 1e-3  # the two segments render differently
    assert np.max(np.abs(tc - jc)) <= 2e-3
    assert np.max(np.abs(tw - jw)) <= 2e-3


def test_render_image_matches_one_batch_of_the_render_fn(view):
    """`render_image`'s pixel loop (batches of 40 over a 12×12 image, the last
    one padded) gives what one 144-ray call of the render function gives, in
    raster order. The camera's pixels are scaled so the 12×12 image spans the
    748×748 view. Rays are independent, so only the MLP products' fp32
    summation order may differ with the batch's size: 1e-5 max abs."""
    _, _, torch_model = _two_segment_models()
    scale = view.inputs.width / 12.0
    inverse_krs = view.inputs.pool.inverse_krs * torch.tensor([scale, scale, 1.0])
    pool = _two_frame_pool(view, inverse_krs)
    inputs = ViewInputs(pool, view.inputs.grids, view.inputs.aabb, 12, 12, buffer_index=1)
    pcfg = t_pipeline.PipelineConfig(sampling="proposal", **_small_pcfg_kwargs())

    img = render_image(torch_model, pcfg, inputs, rays_batch_size=40)

    fn = t_pipeline.make_render_fn(pcfg, torch_model, 12, 12)
    batch = t_pipeline.HostBatch(
        torch.ones(144, dtype=torch.int32), torch.arange(144, dtype=torch.int32), torch.zeros((144, 4)),
        torch.ones(144, dtype=torch.bool),
    )
    out, valid = fn(batch, pool, view.inputs.grids, view.inputs.aabb, 0.0)
    assert img.shape == (12, 12, 3)
    assert 0 < int(valid.sum()) < 144  # rays that hit the actor and rays that miss
    np.testing.assert_allclose(_np(img).reshape(144, 3), _np(out.color), rtol=0, atol=1e-5)
