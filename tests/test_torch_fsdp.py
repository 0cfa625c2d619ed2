"""The port's segment-table sharding (humanrf_torch/parallel/fsdp.py) on two
spawned CPU ranks over gloo, against the JAX package's `make_fsdp_train_step`
on a two-device mesh, with the bars of `tests/test_fsdp.py`: one SGD step
in dense and proposal sampling within rtol 1e-4 / atol 1e-6, the table
shards and both Adam moments at half the full bytes, a table the ranks do
not divide kept whole, the untouched segments of a four-segment model bit
for bit unchanged, and the non-finite skip agreed over the ranks.

The inputs are `tests/test_torch_parallel.py`'s (the FSDP CLI and its
checkpoint are tested there, beside the data-parallel CLI)."""
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from humanrf_torch.convert import convert_params
from humanrf_torch.models.humanrf import HumanRFConfig as THumanRFConfig
from humanrf_torch.models.humanrf import HumanRFModel as THumanRFModel
from humanrf_torch.parallel.fsdp import sharded_segments
from humanrf_tpu.parallel.fsdp import make_fsdp_train_step, param_shardings
from humanrf_tpu.parallel.mesh import make_mesh
from humanrf_tpu.train import pipeline as j_pipeline

from test_torch_parallel import (  # noqa: F401  (train_inputs is a fixture)
    ADAMW, LR, NUM_RAYS, RANKS, _np, draw_batch, jax_batch, jax_params, model_config, params_of,
    pipeline_config, run_ranks, save_job, train_inputs,
)

torch.set_num_threads(2)

TABLES = ("xyz", "xyt", "yzt", "xzt")
# A second segment of one frame at log2 7 has T = 1, which two ranks do not
# divide: that segment stays replicated (segment 0 has T = 32, sharded).
MIXED = dict(sorted_frame_numbers=tuple(range(26)), segment_sizes=(25, 1), log2_hashmap_size=7)
# Four segments of 6 frames at T = 256; the pool's frames 0 and 25 become
# frames 3 and 20, in segments 0 and 3 (tests/test_fsdp.py:201).
FOUR = dict(sorted_frame_numbers=tuple(range(24)), segment_sizes=(6, 6, 6, 6), log2_hashmap_size=12)
CASES = {"dense": ("dense", {}), "proposal": ("proposal", MIXED)}


@pytest.fixture(scope="module")
def fsdp_runs(train_inputs, tmp_path_factory):
    """Every two-rank FSDP run of this file in one launch, and the JAX FSDP
    step on the same inputs while the ranks run. → {name: (jax result or
    None, rank results, (config, initial state))}."""
    tmp = tmp_path_factory.mktemp("fsdp")
    one = [draw_batch(train_inputs, NUM_RAYS, seed=8, on_actor=40)]
    jobs, refs = [], {}

    def add(name, mode, overrides, optimizer, batches, pool=None):
        config = model_config(mode, **overrides)
        jmodel, jparams = jax_params(config)
        state = convert_params(jax.tree_util.tree_map(np.asarray, jparams))
        inputs = train_inputs if pool is None else train_inputs._replace(pool=pool)
        save_job(tmp / f"{name}.npz", inputs, config, pipeline_config(mode), optimizer, batches, [5] * len(batches),
                 state)
        jobs.append((name, tmp / f"{name}.npz"))
        refs[name] = (jmodel, jparams, config, state)

    for name, (mode, overrides) in CASES.items():
        add(name, mode, overrides, {"kind": "sgd", "lr": LR}, one)
    add("adamw", "proposal", {}, ADAMW, one * 3)
    frames = torch.where(train_inputs.pool.frame_numbers == 0, 3, 20).to(train_inputs.pool.frame_numbers.dtype)
    add("four", "dense", FOUR, {"kind": "sgd", "lr": LR}, one, pool=train_inputs.pool._replace(frame_numbers=frames))
    poisoned = tuple(a.copy() for a in one[0])
    poisoned[2][NUM_RAYS - 3, 0] = np.nan
    add("nonfinite", "proposal", {}, ADAMW, [poisoned])

    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, jobs, "fsdp")
        jax_results = {}
        mesh = make_mesh(RANKS)
        for name, (mode, _) in CASES.items():
            jmodel, jparams, _, _ = refs[name]
            jcfg = j_pipeline.PipelineConfig(**pipeline_config(mode))
            opt = optax.sgd(LR)
            step, init_state = make_fsdp_train_step(jcfg, jmodel, opt, train_inputs.width, train_inputs.height, mesh)
            placed, opt_state = init_state(jax.tree_util.tree_map(jnp.copy, jparams))
            p, _, loss, aux = step(
                placed, opt_state, jax_batch(one[0]),
                j_pipeline.PoolArrays(*(jnp.asarray(_np(a)) for a in train_inputs.pool)),
                jnp.asarray(_np(train_inputs.grids)), jnp.asarray(_np(train_inputs.aabb)), jax.random.PRNGKey(5))
            sharded = {s for s, seg in enumerate(param_shardings(jmodel, jparams, mesh)["segments"])
                       if seg["xyz"].spec == jax.sharding.PartitionSpec(None, None, "data")}
            jax_results[name] = (convert_params(jax.tree_util.tree_map(np.asarray, p)), float(loss),
                                 {k: np.asarray(v) for k, v in aux.items()}, sharded)
        port = ranks.result()
    return {name: (jax_results.get(name), port[name], refs[name][2:]) for name, _ in jobs}


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_step_matches_jax_fsdp(fsdp_runs, case):
    """One SGD step on two ranks against JAX's FSDP step on two devices: the
    loss within 1e-5, the counts equal, every gathered parameter within
    tests/test_fsdp.py's rtol 1e-4 / atol 1e-6; the same segments sharded."""
    (jparams, jloss, jaux, jax_sharded), ranks, (config, state) = fsdp_runs[case]
    np.testing.assert_allclose(ranks[0]["losses"][0], jloss, rtol=1e-5)
    assert int(ranks[0]["aux/num_rays_supervised"][0]) == int(jaux["num_rays_supervised"]) > 20
    assert int(ranks[0]["aux/num_samples"][0]) == int(jaux["num_samples"])
    full = params_of(ranks[0], "full/")
    for name, leaf in jparams.items():
        np.testing.assert_allclose(full[name], leaf.numpy(), rtol=1e-4, atol=1e-6, err_msg=name)
    assert not np.array_equal(full["segments.0.xyz"], state["segments.0.xyz"].numpy())
    model = THumanRFModel(THumanRFConfig(**config))
    assert set(sharded_segments(model, RANKS)) == jax_sharded
    for r in ranks:  # each rank's gathered state is the same
        for name, v in params_of(r, "full/").items():
            np.testing.assert_array_equal(v, full[name], err_msg=name)


def test_each_rank_holds_half_of_the_tables_and_their_moments(fsdp_runs):
    """After three AdamW steps: every table parameter of each rank is its
    half of the full table's columns, both Adam moments of them half the full
    bytes; the replicated parameters are bit-equal across the ranks."""
    _, ranks, (config, state) = fsdp_runs["adamw"]
    table_bytes = sum(v.numel() * 4 for k, v in state.items() if k.rsplit(".", 1)[-1] in TABLES)
    full = params_of(ranks[0], "full/")
    for r, result in enumerate(ranks):
        assert int(result["shard_bytes"]) * RANKS == table_bytes
        assert int(result["moment_bytes"]) * RANKS == 2 * table_bytes
        assert int(result["skipped"]) == 0
        for name, shard in params_of(result).items():
            if name.rsplit(".", 1)[-1] in TABLES:
                width = full[name].shape[-1] // RANKS
                np.testing.assert_array_equal(shard, full[name][..., r * width:(r + 1) * width], err_msg=name)
            else:
                np.testing.assert_array_equal(shard, params_of(ranks[0])[name], err_msg=name)


def test_a_table_the_ranks_do_not_divide_stays_whole(fsdp_runs):
    """The mixed model's second segment (T = 1) is replicated: each rank
    holds it whole and equal, while segment 0 (T = 32) is split 16 + 16."""
    model = THumanRFModel(THumanRFConfig(**model_config("proposal", **MIXED)))
    assert [c.grid.table_size for c in model.segment_grid_configs] == [32, 1]
    assert sharded_segments(model, 2) == [0] and sharded_segments(model, 64) == []
    _, ranks, _ = fsdp_runs["proposal"]
    a, b = params_of(ranks[0]), params_of(ranks[1])
    assert a["segments.0.xyz"].shape[-1] == 16 and a["segments.1.xyz"].shape[-1] == 1
    for name in TABLES:
        np.testing.assert_array_equal(a[f"segments.1.{name}"], b[f"segments.1.{name}"])


def test_untouched_segments_stay_bit_equal(fsdp_runs):
    """Four sharded segments, a batch in segments 0 and 3 only: segments 1
    and 2 (tables and vectors) are bit for bit unchanged after the step,
    segments 0 and 3 moved."""
    _, ranks, (config, state) = fsdp_runs["four"]
    full = params_of(ranks[0], "full/")
    assert all(full[f"segments.{s}.xyz"].shape[-1] == 256 for s in range(4))
    for s, touched in ((0, True), (1, False), (2, False), (3, True)):
        if touched:
            assert not np.array_equal(full[f"segments.{s}.xyz"], state[f"segments.{s}.xyz"].numpy()), s
            continue
        for name in (*TABLES, "vectors"):
            np.testing.assert_array_equal(full[f"segments.{s}.{name}"], state[f"segments.{s}.{name}"].numpy(),
                                          err_msg=f"segment {s} {name}")


def test_a_nan_on_one_rank_skips_the_update_on_every_rank(fsdp_runs):
    """The NaN sits in rank 1's block; rank 0's shards' gradients may all be
    finite, yet it skips too: the flag is agreed over the group."""
    _, ranks, (_, state) = fsdp_runs["nonfinite"]
    for r in ranks:
        assert int(r["skipped"]) == 1
        for name, v in params_of(r, "full/").items():
            np.testing.assert_array_equal(v, state[name].numpy(), err_msg=name)
