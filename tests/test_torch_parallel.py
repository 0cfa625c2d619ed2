"""The port's data-parallel training (humanrf_torch/parallel: mesh, feed,
launch) on two spawned CPU ranks over gloo, against the JAX package's
`make_sharded_train_step` on a two-device mesh and its single-device
`make_train_step`, with the bars of `tests/test_parallel.py`; the replicas'
bit-equality, the non-finite skip on every rank, the device checks, and the
CLI with `--tpu.num_devices 2`, data-parallel and FSDP.

Inputs come from numpy seeds and go to both packages: the small model of
`tests/test_torch_train.py` (JAX's init, converted; the fp32 `gather`
field), the baked pool of the r4 scene, one batch and one key. The budgets
hold every sample of every rank, so the ranks' blocks see what one device
sees. The ranks run `humanrf_torch.parallel.harness.run_steps` on inputs
saved to `tmp_path` and write their results there: a spawned worker imports
nothing of this process (JAX included)."""
import shutil
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from humanrf_torch.convert import convert_params
from humanrf_torch.core.synthetic import SyntheticSceneConfig as TSceneConfig
from humanrf_torch.core.synthetic import generate_synthetic_dataset as t_generate
from humanrf_torch.models.humanrf import HumanRFConfig as THumanRFConfig
from humanrf_torch.parallel import harness
from humanrf_torch.parallel.launch import launch
from humanrf_torch.parallel.mesh import rank_device, shard_pipeline_config
from humanrf_torch.run import main as t_main
from humanrf_torch.train import pipeline as t_pipeline
from humanrf_torch.train.checkpoint import load_checkpoint as t_load_checkpoint
from humanrf_torch.utils.rngs import make_key
from humanrf_torch.view_inputs import load_train_inputs
from humanrf_tpu.models.humanrf import HumanRFConfig, HumanRFModel
from humanrf_tpu.parallel.mesh import make_mesh, make_sharded_train_step
from humanrf_tpu.train import pipeline as j_pipeline
from humanrf_tpu.train.checkpoint import load_checkpoint as j_load_checkpoint

torch.set_num_threads(2)

RUN_DIR = Path(__file__).resolve().parent.parent / "runs_evidence" / "r4_full_schedule_748"
RANKS = 2
LR = 1e-2

# tests/test_torch_train.py's small model: two 25-frame segments at the r4
# scene's frames, L2/F2 grids at T = 2^9 per segment, narrow MLPs.
SMALL = dict(
    sorted_frame_numbers=tuple(range(50)), segment_sizes=(25, 25), density_scale=10.0, n_levels=2, n_features_per_level=2,
    log2_hashmap_size=11, coarsest_resolution=4, finest_resolution=32, geometry_feature_dim=3,
    n_neurons=16, n_hidden_layers_density=1, n_hidden_layers_color=1, sh_degree=2, camera_embedding_dim=2,
)
NUM_RAYS = 64
# Budgets no rank can fill: 32 rays × 512 lattice points per rank.
PCFG = dict(num_rays=NUM_RAYS, samples_per_ray=512, candidate_budget=32_768, sample_budget=32_768,
            proposal_samples_per_ray=16, render_samples_per_ray=8, bce_loss_weight=1e-3, huber_delta=0.01)
MODES = {
    "dense": dict(sampling="dense", use_visibility_prune=False),
    "prune": dict(sampling="dense", use_visibility_prune=True),
    "proposal": dict(sampling="proposal"),
}
ADAMW = {"kind": "adamw", "lr": 1e-2, "lr_decay": 0.5, "max_steps": 50_001, "weight_decay": 0.03}


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def model_config(mode, **overrides):
    return dict(SMALL, proposal_rank=8 if mode == "proposal" else 0, proposal_resolution=16, **overrides)


def pipeline_config(mode, **overrides):
    return dict(PCFG, **MODES[mode], **overrides)


def draw_batch(train_inputs, num, seed, on_actor, entries=None):
    """`num` candidate pixels of the pool: `on_actor` inside the images'
    masks (their rays hit the hull), the rest uniform; from pool `entries`
    only, when given. → (buffer_idx, pixel_idx, rgba) as numpy."""
    rng = np.random.default_rng(seed)
    rgba = _np(train_inputs.pixel_rgba)
    entries = np.arange(rgba.shape[0]) if entries is None else np.asarray(entries)
    b_act = rng.choice(entries, on_actor)
    p_act = np.array([rng.choice(np.nonzero(rgba[b, :, 3])[0]) for b in b_act])
    buffer_idx = np.concatenate([b_act, rng.choice(entries, num - on_actor)]).astype(np.int32)
    pixel_idx = np.concatenate([p_act, rng.integers(0, rgba.shape[1], num - on_actor)]).astype(np.int32)
    order = rng.permutation(num)
    buffer_idx, pixel_idx = buffer_idx[order], pixel_idx[order]
    return buffer_idx, pixel_idx, rgba[buffer_idx, pixel_idx].astype(np.float32) / 255.0


def torch_batch(arrays):
    buffer_idx, pixel_idx, rgba = arrays
    n = len(buffer_idx)
    return t_pipeline.HostBatch(torch.tensor(buffer_idx), torch.tensor(pixel_idx), torch.tensor(rgba),
                                torch.ones(n, dtype=torch.bool))


def jax_batch(arrays):
    buffer_idx, pixel_idx, rgba = arrays
    return j_pipeline.HostBatch(jnp.asarray(buffer_idx), jnp.asarray(pixel_idx), jnp.asarray(rgba),
                                jnp.ones(len(buffer_idx), bool))


def jax_params(config, seed=0):
    model = HumanRFModel(HumanRFConfig(**config, field_backend="gather"))
    return model, model.init_params(jax.random.PRNGKey(seed))


def save_job(path, train_inputs, config, pcfg, optimizer, batches, keys, state):
    harness.save_inputs(path, THumanRFConfig(**config), state, t_pipeline.PipelineConfig(**pcfg), optimizer,
                        [torch_batch(b) for b in batches], [make_key(k) for k in keys], train_inputs.pool,
                        train_inputs.grids, train_inputs.aabb, train_inputs.width, train_inputs.height)


def run_ranks(jobs, mode):
    """Launch RANKS gloo ranks over `jobs` [(name, inputs path)] → {name: [rank results]}."""
    launch(harness.run_jobs, RANKS, [(path, path.parent / name, mode) for name, path in jobs], device_type="cpu",
           threads=1)
    return {name: harness.load_results(path.parent / name, RANKS) for name, path in jobs}


def assert_leaves_match(port: dict, ref: dict, before: dict, what: str):
    """tests/test_parallel.py's bars for a one-step SGD update: leaves of
    ndim ≤ 2 element-wise within 3e-5 + 2e-2·(the update's scale) + 1e-3
    relative; grid tables (ndim 3) get a budget of boundary-flipped entries."""
    assert set(port) == set(ref)
    for name, leaf in ref.items():
        update_scale = float(np.abs(leaf - before[name]).max())
        atol = 3e-5 + 2e-2 * update_scale
        bad = np.abs(port[name] - leaf) > (atol + 1e-3 * np.abs(leaf))
        budget = max(8, leaf.size // 20) if leaf.ndim >= 3 else 0
        assert int(bad.sum()) <= budget, f"{what}: {name} has {int(bad.sum())}/{leaf.size} elements beyond tolerance"


def params_of(result, prefix="param/"):
    return {k[len(prefix):]: v for k, v in result.items() if k.startswith(prefix)}


# ------------------------------------------------------------------ fixtures


@pytest.fixture(scope="module")
def train_inputs():
    return load_train_inputs(RUN_DIR / "torch_train_inputs.npz", "cpu")


@pytest.fixture(scope="module")
def cli_started(tmp_path_factory):
    """The CLI runs of `cli_runs`, started in a background thread → their
    future. `dp_runs` asks for it, so that the runs overlap the JAX
    package's compiles there."""
    with ThreadPoolExecutor(1) as pool:
        yield pool.submit(_cli_runs, tmp_path_factory.mktemp("cli"))


@pytest.fixture(scope="module")
def dp_runs(train_inputs, tmp_path_factory, cli_started):
    """Every two-rank data-parallel run of this file in one launch, and the
    JAX package's steps on the same inputs while the ranks run. → {name:
    (jax results or None, rank results, inputs)}."""
    tmp = tmp_path_factory.mktemp("dp")
    frame0 = np.nonzero(_np(train_inputs.pool.frame_numbers) == 0)[0]
    jobs, refs = [], {}

    def add(name, mode, optimizer, batches, keys, factor=1, seed=0):
        config = model_config(mode)
        jmodel, jparams = jax_params(config, seed)
        state = convert_params(jax.tree_util.tree_map(np.asarray, jparams))
        pcfg = pipeline_config(mode, candidate_rays_factor=factor)
        save_job(tmp / f"{name}.npz", train_inputs, config, pcfg, optimizer, batches, keys, state)
        jobs.append((name, tmp / f"{name}.npz"))
        refs[name] = (jmodel, jparams, pcfg, batches, keys, state)

    one = [draw_batch(train_inputs, NUM_RAYS, seed=8, on_actor=40)]
    for mode in MODES:
        add(mode, mode, {"kind": "sgd", "lr": LR}, one, [5])
    add("factor2", "proposal", {"kind": "sgd", "lr": LR}, [draw_batch(train_inputs, 2 * NUM_RAYS, seed=9, on_actor=60)],
        [5], factor=2)
    # Three AdamW steps; in the second, rank 1's rays all see frame 0, so
    # that rank holds no gradient of segment 1.
    split = draw_batch(train_inputs, NUM_RAYS, seed=10, on_actor=40)
    frame0_half = draw_batch(train_inputs, NUM_RAYS // 2, seed=11, on_actor=20, entries=frame0)
    split = tuple(np.concatenate([a[: NUM_RAYS // 2], b]) for a, b in zip(split, frame0_half))
    add("replicas", "proposal", ADAMW, [one[0], split, draw_batch(train_inputs, NUM_RAYS, seed=12, on_actor=40)],
        [5, 6, 7])
    # A NaN in one rgba entry of rank 1's block.
    poisoned = tuple(a.copy() for a in one[0])
    poisoned[2][NUM_RAYS - 3, 0] = np.nan
    add("nonfinite", "proposal", ADAMW, [poisoned], [5])

    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, jobs, "dp")
        jax_results = {}
        mesh = make_mesh(RANKS)
        for name in (*MODES, "factor2"):
            jmodel, jparams, pcfg, batches, keys, _ = refs[name]
            jcfg = j_pipeline.PipelineConfig(**pcfg)
            w, h = train_inputs.width, train_inputs.height
            args = (jax_batch(batches[0]), j_pipeline.PoolArrays(*(jnp.asarray(_np(a)) for a in train_inputs.pool)),
                    jnp.asarray(_np(train_inputs.grids)), jnp.asarray(_np(train_inputs.aabb)), jax.random.PRNGKey(keys[0]))
            opt = optax.sgd(LR)
            steps = {"sharded": make_sharded_train_step(jcfg, jmodel, opt, w, h, mesh)}
            if name in MODES:
                steps["single"] = j_pipeline.make_train_step(jcfg, jmodel, opt, w, h)
            jax_results[name] = {}
            for which, step in steps.items():
                p, _, loss, aux = step(jax.tree_util.tree_map(jnp.copy, jparams), opt.init(jparams), *args)
                jax_results[name][which] = (convert_params(jax.tree_util.tree_map(np.asarray, p)), float(loss),
                                            {k: np.asarray(v) for k, v in aux.items()})
        port = ranks.result()
    return {name: (jax_results.get(name), port[name], refs[name]) for name, _ in jobs}


# ---------------------------------------------------------------- the step


@pytest.mark.parametrize("mode", list(MODES))
def test_dp_step_matches_jax_sharded_and_single_device(dp_runs, mode):
    """Two ranks against JAX's two-device sharded step and its single-device
    step, one SGD step: the loss within 1e-5 relative, equal sample and
    supervised-ray counts, the parameters within tests/test_parallel.py's
    bars (the frameworks' bf16 MLPs round differently, so nothing is
    bit-equal across them)."""
    jax_results, ranks, refs = dp_runs[mode]
    before = {k: v.numpy() for k, v in refs[-1].items()}
    port = params_of(ranks[0])
    assert int(ranks[0]["aux/num_rays_supervised"][0]) > 20
    for which, (jparams, jloss, jaux) in jax_results.items():
        np.testing.assert_allclose(ranks[0]["losses"][0], jloss, rtol=1e-5, err_msg=which)
        assert int(ranks[0]["aux/num_samples"][0]) == int(jaux["num_samples"]), which
        assert int(ranks[0]["aux/num_rays_supervised"][0]) == int(jaux["num_rays_supervised"]), which
        assert_leaves_match(port, {k: v.numpy() for k, v in jparams.items()}, before, f"{mode} vs JAX {which}")
    # The color MLP and the tables moved (on this nearly transparent fresh
    # field the density MLP's gradients are ~1e-9, below its fp32 resolution).
    for name in ("color_net.w1", "segments.0.xyz"):
        assert not np.array_equal(port[name], before[name]), name


def test_dp_factor_2_compacts_each_ranks_block_as_jax_does(dp_runs):
    """128 candidates into 64 slots: each rank compacts its own 64 into 32,
    as each JAX shard does, so the supervised rays and the loss are JAX's
    sharded step's (which differ from one device's compaction)."""
    jax_results, ranks, refs = dp_runs["factor2"]
    jparams, jloss, jaux = jax_results["sharded"]
    assert int(ranks[0]["aux/num_rays_supervised"][0]) == int(jaux["num_rays_supervised"]) > NUM_RAYS // 2
    np.testing.assert_allclose(ranks[0]["losses"][0], jloss, rtol=1e-5)
    assert_leaves_match(params_of(ranks[0]), {k: v.numpy() for k, v in jparams.items()},
                        {k: v.numpy() for k, v in refs[-1].items()}, "factor 2")


def test_replicas_stay_bit_equal_when_a_rank_misses_a_segment(dp_runs):
    """Three AdamW steps, one of them with rank 1's rays all in segment 0:
    its bucket still carries (zero) gradients for segment 1, so both ranks
    apply the same update and end bit-equal, segment 1 included."""
    _, ranks, refs = dp_runs["replicas"]
    a, b = params_of(ranks[0]), params_of(ranks[1])
    for name in a:
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)
    np.testing.assert_array_equal(ranks[0]["losses"], ranks[1]["losses"])
    assert int(ranks[0]["skipped"]) == int(ranks[1]["skipped"]) == 0
    assert not np.array_equal(a["segments.1.xyz"], refs[-1]["segments.1.xyz"].numpy())


def test_a_nan_on_one_rank_skips_the_update_on_every_rank(dp_runs):
    _, ranks, refs = dp_runs["nonfinite"]
    for r in ranks:
        assert int(r["skipped"]) == 1
        for name, v in params_of(r).items():
            np.testing.assert_array_equal(v, refs[-1][name].numpy(), err_msg=name)


# ----------------------------------------------------------- the group


def test_under_provisioning_raises_before_anything_is_written(tmp_path):
    """More GPUs than are visible (none here) is an error, from the device
    check, the launcher and the CLI, and the CLI writes no workspace."""
    with pytest.raises(RuntimeError, match="under-provision"):
        rank_device(0, torch.cuda.device_count() + 1, "cuda")
    with pytest.raises(RuntimeError, match="under-provision"):
        launch(harness.run_jobs, torch.cuda.device_count() + 1, [], device_type="cuda")
    with pytest.raises(RuntimeError):
        t_main(["--config", "example_synthetic", "--device", "cuda", "--tpu.num_devices", "2",
                "--workspace", str(tmp_path / "ws")])
    assert not (tmp_path / "ws").exists()


def test_shard_pipeline_config_divides():
    cfg = t_pipeline.PipelineConfig(num_rays=64, candidate_budget=2048, sample_budget=1024)
    s = shard_pipeline_config(cfg, 8)
    assert (s.num_rays, s.candidate_budget, s.sample_budget) == (8, 256, 128)
    with pytest.raises(ValueError, match="num_rays"):
        shard_pipeline_config(t_pipeline.PipelineConfig(num_rays=65), 8)


# ------------------------------------------------------------------ the CLI

_CLI_FLAGS = [
    "--config", "example_synthetic", "--device", "cpu", "--dataset.deterministic_loader", "true",
    "--dataset.max_buffer_size", "3", "--training.max_steps", "10", "--training.rays_initial_batch_size", "128",
    "--training.samples_max_batch_size", "16384", "--training.save_checkpoint_every_n_steps", "10",
    "--validation.every_n_steps", "10", "--validation.rays_batch_size", "400", "--test.rays_batch_size", "400",
    "--model.log2_hashmap_size", "12", "--model.n_levels", "4", "--model.finest_resolution", "128",
    "--model.density_scale", "10",
]


def _cli_runs(root):
    """example_synthetic's dense sampler on a tiny scene written by the port
    into `root`: one process, then two ranks data-parallel and with FSDP (T =
    64 per table, sharded 32 + 32). → {name: (workspace, result)}."""
    t_generate(root, TSceneConfig(num_cameras=6, width=40, height=40, num_frames=2, grid_resolution=32))
    runs = {}
    for name, extra in (("single", []), ("dp", ["--tpu.num_devices", "2"]),
                        ("fsdp", ["--tpu.num_devices", "2", "--tpu.param_sharding", "fsdp"])):
        ws = root / name
        runs[name] = (ws, t_main([*_CLI_FLAGS, *extra, "--dataset.path", str(root), "--workspace", str(ws)]))
    return runs


@pytest.fixture(scope="module")
def cli_runs(cli_started):
    return cli_started.result()


def _files(ws):
    return {str(p.relative_to(ws)) for p in ws.rglob("*") if p.is_file() and p.parent.name != "run"}


@pytest.mark.parametrize("name", ["dp", "fsdp"])
def test_two_rank_cli_trains_validates_saves_and_resumes_in_one_process(cli_runs, name):
    """Rank 0 alone writes, the single-process layout (one events file); the
    first step's loss is the single process's (the same global batch and key,
    the sums in another order); the checkpoint resumes in one process."""
    single_ws, single = cli_runs["single"]
    ws, result = cli_runs[name]
    assert _files(ws) == _files(single_ws)
    assert len(list((ws / "run").iterdir())) == 1
    assert "checkpoints/step_00000010.ckpt" in _files(ws) and "checkpoints/best.ckpt" in _files(ws)
    stats = result["train"]
    assert (stats["start_step"], stats["end_step"], stats["skipped_nonfinite"]) == (0, 11, 0)
    np.testing.assert_allclose(stats["first_loss"], single["train"]["first_loss"], rtol=1e-5)
    assert (ws / "validation.txt").read_text().count("psnr=") == 1

    resumed_ws = ws.parent / f"{name}_resumed"
    shutil.copytree(ws, resumed_ws)
    flags = [*_CLI_FLAGS, "--dataset.path", str(ws.parent), "--workspace", str(resumed_ws)]
    resumed = t_main([*flags, "--training.max_steps", "13", "--training.checkpoint", "latest"])["train"]
    assert (resumed["start_step"], resumed["end_step"], resumed["skipped_nonfinite"]) == (10, 14, 0)


def test_fsdp_checkpoint_is_the_full_state_and_loads_in_jax(cli_runs):
    """The FSDP run's checkpoint holds full tables and moments, the JAX dense
    model's tree, and the JAX package's `load_checkpoint` reads it leaf for
    leaf as the port does."""
    ws, _ = cli_runs["fsdp"]
    jmodel = HumanRFModel(HumanRFConfig(
        sorted_frame_numbers=(0, 1), segment_sizes=(2,), density_scale=10.0, log2_hashmap_size=12, n_levels=4,
        finest_resolution=128, camera_embedding_dim=0, proposal_rank=0,
    ))
    template = jmodel.init_params(jax.random.PRNGKey(0))
    params, opt_state, step, _, _ = t_load_checkpoint(ws / "checkpoints" / "step_00000010.ckpt")
    assert np.asarray(params["segments"]["0"]["xyz"]).shape == (4, 2, 64)
    assert np.asarray(opt_state["inner_state"]["0"]["mu"]["segments"]["0"]["xyz"]).shape == (4, 2, 64)

    def leaves(tree):
        flat = jax.tree_util.tree_leaves_with_path(serialization.to_state_dict(tree))
        return {jax.tree_util.keystr(k): np.asarray(v) for k, v in flat}

    jparams, _, jstep, _, _ = j_load_checkpoint(ws / "checkpoints" / "step_00000010.ckpt", template, None)
    assert jstep == step == 10
    loaded, written = leaves(jparams), leaves(params)
    assert set(loaded) == set(written)
    for k, v in written.items():
        np.testing.assert_array_equal(loaded[k], v, err_msg=k)
