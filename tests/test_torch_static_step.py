"""The train step and the render function as one device program
(`humanrf_torch/train/graphs.py`): static sample budgets, the valid count and
the segment routing kept on the device, no host read inside.

On the CPU: the step with every host read patched to raise, the static
budget against the prefix render bit for bit, a batch spanning both
segments against the JAX package's step, the field kernels' skip inputs
(plain versions) against slicing, and the render function's padded last
batch against JAX's render function. On the card (`-m cuda`): the captured
graphs against the eager body and the kernels' skip inputs against their
plain versions. Inputs come from numpy seeds and go to both packages."""
import contextlib
import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from humanrf_torch.convert import convert_params
from humanrf_torch.models.activation import truncated_exp
from humanrf_torch.models.hash_encoding import HashGridConfig as THashGridConfig
from humanrf_torch.models.humanrf import HumanRFConfig as THumanRFConfig
from humanrf_torch.models.humanrf import HumanRFModel as THumanRFModel
from humanrf_torch.ops import field_interp as fli
from humanrf_torch.ops import render as t_render
from humanrf_torch.ops.sampling import SampleSet
from humanrf_torch.train import pipeline as t_pipeline
from humanrf_torch.train import trainer as t_trainer
from humanrf_torch.train.trainer import ViewInputs, render_image, render_pipeline_config
from humanrf_torch.utils import rngs as t_rngs
from humanrf_torch.view_inputs import load_train_inputs, load_view_inputs
from humanrf_tpu.models.humanrf import HumanRFConfig, HumanRFModel
from humanrf_tpu.train import pipeline as j_pipeline

torch.set_num_threads(2)

RUN_DIR = Path(__file__).resolve().parent.parent / "runs_evidence" / "r4_full_schedule_748"

# tests/test_torch_train.py's small two-segment model (frames 0-24 and
# 25-49; the baked pool holds frames 0 and 25) and its two samplers' settings.
_SMALL = dict(
    sorted_frame_numbers=tuple(range(50)), segment_sizes=(25, 25), density_scale=10.0, n_levels=2, n_features_per_level=2,
    log2_hashmap_size=11, coarsest_resolution=4, finest_resolution=32, geometry_feature_dim=3,
    n_neurons=16, n_hidden_layers_density=1, n_hidden_layers_color=1, sh_degree=2,
    camera_embedding_dim=2, proposal_rank=8, proposal_resolution=16,
)
_PCFG = {
    "proposal": dict(
        sampling="proposal", num_rays=128, candidate_rays_factor=2, proposal_samples_per_ray=16,
        render_samples_per_ray=8, proposal_uniform_bonus=0.05, march_grid_factor=2, bce_loss_weight=1e-3,
        huber_delta=0.01, proposal_loss_weight=1.0,
    ),
    "dense": dict(
        sampling="dense", num_rays=128, candidate_rays_factor=2, samples_per_ray=512, candidate_budget=40_960,
        sample_budget=32_768, march_grid_factor=2, bce_loss_weight=1e-3, huber_delta=0.01,
    ),
}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rel(a, b):
    return abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)


def _cosine(a, b):
    return float(np.dot(a.ravel(), b.ravel()) / (np.linalg.norm(a) * np.linalg.norm(b)))


@pytest.fixture(scope="module")
def train_inputs():
    return load_train_inputs(RUN_DIR / "torch_train_inputs.npz", "cpu")


@pytest.fixture(scope="module")
def jax_small():
    jmodel = HumanRFModel(HumanRFConfig(**_SMALL, field_backend="gather"))
    return jmodel, jmodel.init_params(jax.random.PRNGKey(0))


def _torch_small(jparams, device="cpu"):
    model = THumanRFModel(THumanRFConfig(**_SMALL))
    model.load_state_dict(convert_params(jax.tree_util.tree_map(np.asarray, jparams)))
    return model.to(device)


def _batch(train_inputs, num, seed, on_actor):
    """`num` candidate pixels over the whole pool, `on_actor` of them inside
    the images' masks (tests/test_torch_train.py's draw)."""
    rng = np.random.default_rng(seed)
    rgba = _np(train_inputs.pixel_rgba)
    b_act = rng.integers(0, rgba.shape[0], on_actor)
    p_act = np.array([rng.choice(np.nonzero(rgba[b, :, 3])[0]) for b in b_act])
    buffer_idx = np.concatenate([b_act, rng.integers(0, rgba.shape[0], num - on_actor)]).astype(np.int32)
    pixel_idx = np.concatenate([p_act, rng.integers(0, rgba.shape[1], num - on_actor)]).astype(np.int32)
    order = rng.permutation(num)
    buffer_idx, pixel_idx = buffer_idx[order], pixel_idx[order]
    return buffer_idx, pixel_idx, rgba[buffer_idx, pixel_idx].astype(np.float32) / 255.0


def _torch_batch(buffer_idx, pixel_idx, rgba, device="cpu"):
    n = len(buffer_idx)
    return t_pipeline.HostBatch(torch.tensor(buffer_idx, device=device), torch.tensor(pixel_idx, device=device),
                                torch.tensor(rgba, device=device), torch.ones(n, dtype=torch.bool, device=device))


# ------------------------------------------------------- no host read inside

_HOST_READ_METHODS = ("item", "__int__", "__float__", "__bool__", "__index__", "tolist", "numpy", "nonzero")
# The aten ops that read a tensor's values back to the host, or whose output
# size depends on them: `.item()`/int()/float()/bool() go through
# `_local_scalar_dense`; a boolean-mask index calls `nonzero` below the
# mode, so `index` with a boolean index is refused too.
_HOST_READ_OPS = ("_local_scalar_dense", "nonzero", "masked_select", "_unique2", "unique_dim", "unique_consecutive")


class _RefuseHostReads(TorchDispatchMode):
    """Raises at any aten op of `_HOST_READ_OPS`: what a CUDA graph cannot
    capture, seen from the CPU."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in _HOST_READ_OPS:
            raise AssertionError(f"host read inside the step: aten.{name}")
        if name in ("index", "index_put", "index_put_") and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool for i in args[1] if i is not None):
            raise AssertionError(f"host read inside the step: aten.{name} with a boolean mask")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _no_host_reads(monkeypatch):
    def refuse(name):
        def raiser(*args, **kwargs):
            raise AssertionError(f"host read inside the step: {name}")
        return raiser

    with monkeypatch.context() as mp:
        for name in _HOST_READ_METHODS:
            mp.setattr(torch.Tensor, name, refuse(f"Tensor.{name}"))
        mp.setattr(torch, "nonzero", refuse("torch.nonzero"))
        with _RefuseHostReads():
            yield


@pytest.mark.parametrize("sampling", ["dense", "proposal"])
def test_step_makes_no_host_read(train_inputs, jax_small, monkeypatch, sampling):
    """A two-segment model's whole step (rays, compaction, sampler, both
    passes, loss, backward, AdamW) on a batch spanning both segments, with
    every host read patched to raise: the CPU's stand-in for the capture,
    which refuses the same reads on the card. The step still trains: its
    loss is finite and an update is applied."""
    model = _torch_small(jax_small[1])
    cfg = t_pipeline.PipelineConfig(**_PCFG[sampling])
    batch = _torch_batch(*_batch(train_inputs, 256, seed=8, on_actor=110))
    optimizer = t_trainer.make_optimizer(model.named_parameters(), 1e-2, 0.5, 50_001, weight_decay=0.03)
    step = t_pipeline.make_train_step(cfg, model, optimizer, train_inputs.width, train_inputs.height)
    before = [p.detach().clone() for p in model.parameters()]
    with _no_host_reads(monkeypatch):
        for i in range(2):
            loss, aux = step(batch, train_inputs.pool, train_inputs.grids, train_inputs.aabb,
                             t_rngs.fold_in(t_rngs.make_key(3), torch.tensor(i)))
    assert np.isfinite(float(loss)) and int(optimizer.count) == 2 and int(optimizer.skipped) == 0
    assert int(aux["num_rays_supervised"]) > 20
    assert all(not torch.equal(a, p) for a, p in zip(before, model.parameters()))


def test_the_host_read_guard_catches_the_old_reads(monkeypatch):
    """The guard above refuses what the port used to do inside a step: the
    prefix's `int(num_valid)` and the segment routing's `torch.nonzero` and
    boolean-mask gathers."""
    x, mask = torch.arange(6.0), torch.tensor([True, False] * 3)
    for read in (lambda: int(x.sum()), lambda: torch.nonzero(mask), lambda: x[mask], lambda: float(x[0])):
        with pytest.raises(AssertionError, match="host read"), _no_host_reads(monkeypatch):
            read()


# ----------------------------------------------- static budget against prefix


def _flat_samples(budget, num_rays, seed=0):
    """A flat buffer of `budget` slots whose first third holds each ray's
    ascending samples (some rays empty), the rest empty (ray = num_rays)."""
    rng = np.random.default_rng(seed)
    per_ray = rng.integers(0, 12, num_rays)
    n = int(per_ray.sum())
    assert n < budget // 2
    ray = np.full(budget, num_rays, np.int32)
    ray[:n] = np.repeat(np.arange(num_rays, dtype=np.int32), per_ray)
    t = np.zeros(budget, np.float32)
    t[:n] = np.concatenate([np.sort(rng.uniform(2.0, 4.0, k)) for k in per_ray]).astype(np.float32)
    valid = np.arange(budget) < n
    return SampleSet(torch.tensor(t), torch.tensor(ray), torch.tensor(valid), torch.ones(num_rays, dtype=torch.bool),
                     torch.tensor(n, dtype=torch.int32)), n


def _prefix(samples, n):
    return samples._replace(t=samples.t[:n], ray=samples.ray[:n], valid=samples.valid[:n])


def test_static_budget_matches_the_prefix_render():
    """`prune_samples` and `render` over a whole static budget against the
    same calls on the valid prefix alone (what the port did before, with a
    host read of `num_valid`), at a valid count well under the budget: the
    pruned buffer, colors and weight sums bit-equal, the gradients of the
    queried densities and radiances bit-equal on the valid slots and exactly
    0 (not NaN) on the empty ones, whose raw values are garbage here (a
    density logit of 1e4 clamps to exp(16), a radiance logit of 1e30)."""
    num_rays, budget, step = 40, 1024, 4e-2
    samples, n = _flat_samples(budget, num_rays)
    rng = np.random.default_rng(1)
    origins = torch.tensor(rng.normal(size=(num_rays, 3)).astype(np.float32))
    dirs = torch.nn.functional.normalize(torch.tensor(rng.normal(size=(num_rays, 3)).astype(np.float32)), dim=-1)
    frames, cams = torch.zeros(num_rays, dtype=torch.int32), torch.zeros(num_rays, dtype=torch.int32)
    logits = rng.normal(size=budget).astype(np.float32) * 2
    logits[n:] = 1e4
    colors = rng.normal(size=(budget, 3)).astype(np.float32)
    colors[n:] = 1e30
    seen = []

    def density_fn(slots):
        def fn(positions, frame_numbers, num_valid):
            seen.append(int(num_valid))
            return truncated_exp(slots[: positions.shape[0]]) * 10.0
        return fn

    pruned = {}
    for name, s in (("static", samples), ("prefix", _prefix(samples, n))):
        pruned[name] = t_render.prune_samples(density_fn(torch.tensor(logits)), s, origins, dirs, frames, num_rays,
                                              budget // 2, step, 16)
    assert seen == [n, n]
    for a, b in zip(pruned["static"], pruned["prefix"]):
        assert torch.equal(a, b)
    assert 0 < int(pruned["static"].num_valid) < n

    outs, grads = {}, {}
    for name, s, size in (("static", samples, budget), ("prefix", _prefix(samples, n), n)):
        a = torch.tensor(logits[:size], requires_grad=True)
        c = torch.tensor(colors[:size], requires_grad=True)

        def forward_fn(positions, directions, frame_numbers, camera_numbers, num_valid, a=a, c=c):
            return truncated_exp(a) * 10.0, torch.sigmoid(c)

        out = t_render.render(forward_fn, s, origins, dirs, frames, cams, num_rays, 0.25, step, 16)
        (out.color.square().sum() + out.weights_sum.sum()).backward()
        outs[name], grads[name] = out, (a.grad, c.grad)
    assert torch.equal(outs["static"].color, outs["prefix"].color)
    assert torch.equal(outs["static"].weights_sum, outs["prefix"].weights_sum)
    for g_static, g_prefix in zip(*grads.values()):
        assert torch.equal(g_static[:n], g_prefix)
        assert torch.equal(g_static[n:], torch.zeros_like(g_static[n:]))
        assert bool(g_prefix.abs().sum() > 0)


# ----------------------------------------- two segments against the JAX step


def _jax_loss_fn(cfg, model, width, height):
    """The JAX step's loss as a function of (params, rng, batch, pool,
    grids, aabb): `make_train_step`'s body up to `value_and_grad`."""

    def loss_fn(params, rng, batch, pool, grids, aabb):
        rays = j_pipeline.build_rays(cfg, batch, pool, grids, aabb, width, height)
        ray_ids = jnp.arange(cfg.num_rays * cfg.candidate_rays_factor, dtype=jnp.int32)
        rays, b, ray_ids = j_pipeline.compact_rays(rays, batch, ray_ids, cfg.num_rays)
        samples = None
        if cfg.sampling == "dense":
            samples = j_pipeline.build_samples(cfg, rays, pool, grids, b.buffer_idx)
        return j_pipeline.training_loss(cfg, model, params, rays, samples, b.rgba, rng, ray_ids=ray_ids, pool=pool,
                                        grids=grids, buffer_idx=b.buffer_idx)

    return loss_fn


@pytest.mark.parametrize("sampling", ["dense", "proposal"])
def test_two_segment_batch_matches_jax_step(train_inputs, jax_small, sampling):
    """One batch whose supervised rays lie in both segments (the pool's
    frames 0 and 25), through the port's step (every segment's query over
    all samples, the other segment's skipped; the dense passes over their
    whole budgets) and the JAX step's loss and gradient (`fp32 gather`
    field), same params and key, with tests/test_torch_train.py's bars:
    loss and aux within 1e-5 relative, every leaf's gradient non-zero (both
    segments' too; the dense step leaves the proposal's at 0 in both) at
    cosine ≥ 0.999 and within 2e-2 of its largest entry."""
    jmodel, jparams = jax_small
    tmodel = _torch_small(jparams)
    jcfg = j_pipeline.PipelineConfig(**_PCFG[sampling])
    tcfg = t_pipeline.PipelineConfig(**_PCFG[sampling])
    buffer_idx, pixel_idx, rgba = _batch(train_inputs, 256, seed=12, on_actor=120)
    frames = _np(train_inputs.pool.frame_numbers)[buffer_idx]
    on_actor = rgba[:, 3] > 0
    assert on_actor[frames < 25].sum() > 20 and on_actor[frames >= 25].sum() > 20
    n = len(buffer_idx)
    jbatch = j_pipeline.HostBatch(jnp.asarray(buffer_idx), jnp.asarray(pixel_idx), jnp.asarray(rgba), jnp.ones(n, bool))
    jpool = j_pipeline.PoolArrays(*(jnp.asarray(_np(a)) for a in train_inputs.pool))
    grids, aabb, w, h = train_inputs.grids, train_inputs.aabb, train_inputs.width, train_inputs.height

    (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(_jax_loss_fn(jcfg, jmodel, w, h), has_aux=True))(
        jparams, jax.random.PRNGKey(5), jbatch, jpool, jnp.asarray(_np(grids)), jnp.asarray(_np(aabb))
    )
    topt = t_trainer.make_optimizer(tmodel.named_parameters(), 1e-2, 0.5, 50_001, weight_decay=0.03)
    tloss, taux = t_pipeline.make_train_step(tcfg, tmodel, topt, w, h)(
        _torch_batch(buffer_idx, pixel_idx, rgba), train_inputs.pool, grids, aabb, t_rngs.make_key(5)
    )
    assert int(taux["num_rays_supervised"]) == int(jaux["num_rays_supervised"]) > 40
    assert int(taux["num_samples"]) == int(jaux["num_samples"])
    assert _rel(tloss, jloss) <= 1e-5
    for k, v in jaux.items():
        assert _rel(taux[k], v) <= 1e-5, k
    jflat = convert_params(jax.tree_util.tree_map(np.asarray, jgrads))
    for name, p in tmodel.named_parameters():
        jg = _np(jflat[name])
        if sampling == "dense" and name.startswith("proposal."):
            assert (p.grad is None or not p.grad.any()) and not jg.any(), name  # the dense step has no proposal
            continue
        tg = _np(p.grad)
        assert np.abs(jg).max() > 0, name
        assert _cosine(tg, jg) >= 0.999, name
        assert np.abs(tg - jg).max() <= 2e-2 * np.abs(jg).max(), name


# ------------------------------------------------- the kernels' skip inputs

_GRID = dict(n_levels=3, n_features_per_level=2, log2_hashmap_size=10, base_resolution=4, finest_resolution=64)


def _skip_case(mode, n, seed=0):
    rng = np.random.default_rng(seed)
    if mode == "grid":
        cfg = THashGridConfig(**_GRID)
        spec, P, F, T = fli.grid_spec(cfg), 4 * cfg.n_levels, cfg.n_features_per_level, cfg.table_size
    else:
        spec, P, F, T = fli.VECTOR_SPEC, 4, 6, 64
    tables = torch.tensor(rng.normal(size=(P, F, T)).astype(np.float32))
    xyzt = torch.tensor(rng.uniform(-0.05, 1.05, (n, 4)).astype(np.float32))
    g = torch.tensor(rng.normal(size=(P, F, n)).astype(np.float32))
    seg = torch.tensor(rng.integers(-1, 3, n).astype(np.int32))
    return spec, tables, xyzt, g, seg, T


_SKIPS = {"n_valid": (True, False), "seg": (False, True), "both": (True, True)}


@pytest.mark.parametrize("skips", list(_SKIPS))
@pytest.mark.parametrize("mode", ["grid", "vector"])
def test_field_interp_skip_inputs_match_slicing(mode, skips):
    """The plain versions with `n_valid` and/or `seg`/`s`: the forward's
    served samples bit-equal to a call on those samples alone, the others
    exactly 0; the backward bit-equal to the backward of the served samples
    alone (a skipped sample adds exact zeros). Segment ids include -1 (a
    frame of no segment), which no call serves."""
    n, n_valid, s = 500, 333, 1
    spec, tables, xyzt, g, seg, T = _skip_case(mode, n)
    use_nv, use_seg = _SKIPS[skips]
    args = (torch.tensor([n_valid], dtype=torch.int32) if use_nv else None, seg if use_seg else None, s)
    live = torch.ones(n, dtype=torch.bool)
    if use_nv:
        live &= torch.arange(n) < n_valid
    if use_seg:
        live &= seg == s
    assert 50 < int(live.sum()) < n
    out = fli.field_interp_plain(tables, xyzt, spec, *args)
    assert torch.equal(out[..., live], fli.field_interp_plain(tables, xyzt[live], spec))
    assert torch.equal(out[..., ~live], torch.zeros_like(out[..., ~live]))
    dtab = fli.field_interp_bwd_plain(g, xyzt, spec, T, *args)
    assert torch.equal(dtab, fli.field_interp_bwd_plain(g[..., live].contiguous(), xyzt[live], spec, T))
    # Through the wrapper and autograd, as the model calls it.
    t = tables.clone().requires_grad_()
    fli.field_interp(t, xyzt, spec, *args).backward(g)
    assert torch.equal(t.grad, dtab)


def test_field_interp_rejects_bad_skip_inputs():
    spec, tables, xyzt, _, seg, _ = _skip_case("vector", 50)
    for bad in ({"n_valid": torch.tensor([3])}, {"n_valid": torch.tensor([1, 2], dtype=torch.int32)},
                {"seg": seg[:10]}, {"seg": seg.long()}):
        with pytest.raises((TypeError, ValueError)):
            fli.field_interp(tables, xyzt, spec, **bad)


# ----------------------------------------------- the render's padded batch


@pytest.fixture(scope="module")
def view():
    return load_view_inputs(RUN_DIR / "torch_view_inputs.npz", "cpu")


def _two_segment_render_models():
    """tests/test_torch_render.py's tiny two-segment model (frames 0-3 in
    segments [2, 2]), tables scaled well away from their ±1e-4 init."""
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
    return jax_model, jax.tree_util.tree_map(jnp.asarray, params), torch_model


@pytest.mark.parametrize("sampling", ["dense", "proposal"])
def test_render_fn_pads_the_last_batch(view, sampling):
    """`render_image` over a 12×12 view in batches of 32 (the last one, 16
    pixels, padded with pixel 0 to the batch size, so one render function
    serves every batch, as one captured graph does on the card) against the
    JAX package's render function on the same padded batches, at frame 3
    (segment 1): colors within 2e-3 (tests/test_torch_render.py's bar for
    this model). Under dense sampling both packages get the budgets
    `render_pipeline_config` scales to the batch."""
    jax_model, jax_params, torch_model = _two_segment_render_models()
    size, batch_size = 12, 32  # JAX's gather field takes multiples of 128 samples
    scale = view.inputs.width / size
    pool0 = view.inputs.pool
    pool = t_pipeline.PoolArrays(pool0.inverse_krs * torch.tensor([scale, scale, 1.0]), pool0.camera_origins,
                                 pool0.landscape, torch.tensor([3], dtype=torch.int32), pool0.camera_numbers,
                                 torch.zeros(1, dtype=torch.int32))
    inputs = ViewInputs(pool, view.inputs.grids, view.inputs.aabb, size, size, buffer_index=0)
    extra = (dict(samples_per_ray=1024, candidate_budget=64 * 1024, sample_budget=32 * 1024) if sampling == "dense"
             else dict(proposal_samples_per_ray=16, render_samples_per_ray=8))
    pcfg = t_pipeline.PipelineConfig(sampling=sampling, num_rays=128, march_grid_factor=2, **extra)
    fields = {f.name: getattr(render_pipeline_config(pcfg, batch_size), f.name)
              for f in dataclasses.fields(t_pipeline.PipelineConfig)
              if f.name != "photometric"}  # the port's own loss choice, at its default (Huber)
    jfn = j_pipeline.make_render_fn(j_pipeline.PipelineConfig(**fields), jax_model, size, size)
    jpool = j_pipeline.PoolArrays(*(jnp.asarray(_np(a)) for a in pool))
    jcolors = []
    for start in range(0, size * size, batch_size):
        real = min(batch_size, size * size - start)
        pixel_idx = np.zeros(batch_size, np.int32)
        pixel_idx[:real] = np.arange(start, start + real)
        jbatch = j_pipeline.HostBatch(jnp.zeros(batch_size, jnp.int32), jnp.asarray(pixel_idx),
                                      jnp.zeros((batch_size, 4)), jnp.ones(batch_size, bool))
        out, _ = jfn(jax_params, jbatch, jpool, jnp.asarray(_np(view.inputs.grids)), jnp.asarray(_np(view.inputs.aabb)),
                     0.0)
        jcolors.append(np.asarray(out.color)[:real])
    jimg = np.concatenate(jcolors).reshape(size, size, 3)

    img = _np(render_image(torch_model, pcfg, inputs, batch_size))
    assert img.shape == (size, size, 3) and 0.02 < (img.sum(-1) > 0.05).mean() < 0.98  # actor and background
    np.testing.assert_allclose(img, jimg, rtol=0, atol=2e-3)
    # The cached render function serves a second view: the same pixels again.
    np.testing.assert_array_equal(_np(render_image(torch_model, pcfg, inputs, batch_size)), img)


# ------------------------------------------------------------- on the card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("sampling", ["dense", "proposal"])
def test_graph_step_matches_the_eager_step_on_card(train_inputs, jax_small, cuda_device, sampling):
    """The captured step against the eager body on the same batches and
    keys: step 0 (the graph's warm-up, the eager body) bit-equal; the
    first replay (step 1) against the eager body from the graph's state
    before it, the loss bit-equal (the forward sums in a fixed order) and
    the gradients at cosine ≥ 0.99999 per parameter (the backward kernel's
    fp32 atomics add in a run-dependent order); a few steps' losses within
    1e-4 of the eager run's from the same start, and the launches counted
    per replay equal to the eager step's."""
    pool = t_pipeline.PoolArrays(*(a.to(cuda_device) for a in train_inputs.pool))
    grids, aabb = train_inputs.grids.to(cuda_device), train_inputs.aabb.to(cuda_device)
    cfg = t_pipeline.PipelineConfig(**_PCFG[sampling])
    batches = [_torch_batch(*_batch(train_inputs, 256, seed=20 + i, on_actor=110), device=cuda_device) for i in range(4)]
    keys = [t_rngs.fold_in(t_rngs.make_key(3, cuda_device), torch.tensor(i)) for i in range(4)]

    def train(graph, steps, state=None):
        model = _torch_small(jax_small[1], cuda_device)
        opt = t_trainer.make_optimizer(model.named_parameters(), 1e-2, 0.5, 50_001, weight_decay=0.03)
        if state is not None:
            with torch.no_grad():
                for dst, src in zip([*model.parameters(), opt.count, *opt.mu, *opt.nu], state):
                    dst.copy_(src)
        step = t_pipeline.make_train_step(cfg, model, opt, train_inputs.width, train_inputs.height, graph=graph)
        losses, grads, launches, before_1 = [], {}, [], None
        for i in steps:
            if i == 1:
                before_1 = [t.detach().clone() for t in (*model.parameters(), opt.count, *opt.mu, *opt.nu)]
            before = dict(fli.launches)
            loss, _ = step(batches[i], pool, grids, aabb, keys[i])
            launches.append({d: fli.launches[d] - before[d] for d in before})
            losses.append(float(loss))
            # (the dense step leaves the proposal's factors without a gradient)
            grads[i] = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
        return losses, grads, launches, before_1

    lg, gg, ng, state_1 = train(True, range(4))
    le, ge, ne, _ = train(False, range(4))
    (l1,), g1, _, _ = train(False, [1], state_1)
    assert lg[0] == le[0] and lg[1] == l1 and gg[1].keys() == g1[1].keys()
    assert all(_cosine(_np(gg[1][k]).astype(np.float64), _np(g1[1][k]).astype(np.float64)) >= 0.99999 for k in g1[1])
    assert all(_rel(a, b) <= 1e-4 for a, b in zip(lg, le))
    # Per step one field query kernel forward in the render pass (and,
    # dense, the prune pass), backward once.
    assert ng == ne and ne[0] == {"fwd": 2 if sampling == "dense" else 1, "bwd": 1}


@pytest.mark.cuda
def test_graph_render_matches_the_eager_render_on_card(view, cuda_device):
    """A 48×48 view of the tiny two-segment model, graph against eager, bit
    for bit, with launches counted per replayed batch: 9 batches, each with
    a prune and a render pass, one field query kernel each."""
    _, _, model = _two_segment_render_models()
    model = model.to(cuda_device)
    inputs = ViewInputs(*(t_pipeline.PoolArrays(*(a.to(cuda_device) for a in view.inputs.pool)),
                          view.inputs.grids.to(cuda_device), view.inputs.aabb.to(cuda_device)), 48, 48)
    pcfg = t_pipeline.PipelineConfig(sampling="dense", num_rays=128, samples_per_ray=1024,
                                     candidate_budget=64 * 1024, sample_budget=32 * 1024)
    images, launches = {}, {}
    for graph in (False, True, True):
        before = dict(fli.launches)
        images[graph] = render_image(model, pcfg, inputs, 256, graph=graph)
        launches[graph] = {d: fli.launches[d] - before[d] for d in before}
    assert torch.equal(images[True], images[False])
    assert launches[True] == launches[False] == {"fwd": 9 * 2, "bwd": 0}


@pytest.mark.cuda
@pytest.mark.parametrize("skips", list(_SKIPS))
@pytest.mark.parametrize("mode", ["grid", "vector"])
def test_skip_inputs_match_plain_on_card(cuda_device, mode, skips):
    """The field query's kernels with `n_valid` and/or `seg` against their
    plain version on the same inputs: three segments of `_skip_case`'s
    grid tables and vectors (segment ids -1..2; without `seg`, segment 0
    alone); the forward bit for bit, and the backward of the grid tables
    (mode "grid") or of the vectors ("vector") within 1e-5 of the scale of
    the plain version summed in fp64."""
    n = 70_001
    use_nv, use_seg = _SKIPS[skips]
    _, vectors, xyzt, g, seg, _ = (t.to(cuda_device) if isinstance(t, torch.Tensor) else t
                                   for t in _skip_case("vector", n))
    fields = []
    for s in range(3 if use_seg else 1):
        spec, grids, *_ = _skip_case("grid", n, seed=s)
        fields.append(fli.SegmentField(tuple(grids.to(cuda_device).split(spec.n_levels)), vectors, spec))
    n_valid = torch.tensor([n // 3], dtype=torch.int32, device=cuda_device) if use_nv else None
    seg = seg if use_seg else None
    out = fli.field_query(fields, xyzt, n_valid, seg)
    assert torch.equal(out, fli.field_query_plain(fields, xyzt, n_valid, seg))
    grad = g[0].T.contiguous()  # (n, L·F)
    tensors = [t.clone().requires_grad_() for t in fli._flat(fields)]
    fli.field_query(fli._unflat([(f.spec, len(f.grids)) for f in fields], tensors), xyzt, n_valid, seg).backward(grad)
    refs = fli.field_query_bwd_plain(fields, xyzt, grad.double(), n_valid, seg)
    for i, (t, r) in enumerate(zip(tensors, refs)):
        if (i % 5 == 4) == (mode == "vector"):  # each segment's four grid tables, then its vectors
            assert float((t.grad.double() - r).abs().max() / r.abs().max()) < 1e-5, i


def test_graph_inputs_are_copied_when_new_or_changed():
    """A captured step's static inputs take a call's tensor unless it is the
    object copied last time at the same version: the loader's cached pool
    snapshot and grid ring are not copied again, but a tensor written in
    place since (its version moved) or a new one is."""
    from humanrf_torch.train.graphs import _Captured

    entry = _Captured([torch.zeros(3), None])
    pool, other = torch.tensor([1.0, 2.0, 3.0]), "not a tensor"
    entry.copy_inputs([pool, other])
    assert torch.equal(entry.static[0], pool)
    entry.static[0].fill_(-1)  # stands for a buffer the copy would overwrite
    entry.copy_inputs([pool, other])
    assert torch.equal(entry.static[0], torch.full((3,), -1.0))  # same object, same version: not copied
    pool.add_(1)
    entry.copy_inputs([pool, other])
    assert torch.equal(entry.static[0], torch.tensor([2.0, 3.0, 4.0]))  # written in place: copied
    entry.copy_inputs([torch.tensor([7.0, 8.0, 9.0]), other])
    assert torch.equal(entry.static[0], torch.tensor([7.0, 8.0, 9.0]))  # a new object: copied


def test_render_function_runs_eagerly_on_the_cpu(train_inputs, jax_small):
    """On the CPU the graph wrapper calls the body as it is (no graph, no
    static buffer): two calls on different batches return distinct outputs,
    equal to those of `graph=False`."""
    model = _torch_small(jax_small[1])
    cfg = t_pipeline.PipelineConfig(**_PCFG["proposal"])
    fns = {graph: t_pipeline.make_render_fn(cfg, model, train_inputs.width, train_inputs.height, graph=graph)
           for graph in (True, False)}
    outs = {}
    for graph, fn in fns.items():
        outs[graph] = [fn(_torch_batch(*_batch(train_inputs, 64, seed=30 + i, on_actor=40)), train_inputs.pool,
                          train_inputs.grids, train_inputs.aabb, 0.0)[0].color for i in range(2)]
    assert not torch.equal(outs[True][0], outs[True][1])
    assert all(torch.equal(a, b) for a, b in zip(outs[True], outs[False]))
