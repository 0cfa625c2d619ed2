"""The port's stdlib checkpoint reader (humanrf_torch/train/checkpoint.py)
against flax and msgpack, and `convert_params` against the model's state."""
from pathlib import Path

import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

import humanrf_tpu.train.checkpoint as j_checkpoint
from humanrf_torch.convert import convert_params
from humanrf_torch.models.humanrf import HumanRFModel
from humanrf_torch.train import checkpoint as t_checkpoint
from humanrf_torch.view_inputs import load_view_inputs

torch.set_num_threads(2)

RUN_DIR = Path(__file__).resolve().parent.parent / "runs_evidence" / "r4_full_schedule_748"


def _assert_same_tree(a, b, path="root"):
    """Same structure, same leaf types; arrays equal in dtype, shape and bits."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and a.keys() == b.keys(), path
        for k in b:
            _assert_same_tree(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, (list, tuple)):
        assert isinstance(a, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same_tree(x, y, f"{path}/{i}")
    elif isinstance(b, (np.ndarray, np.generic)):
        assert type(a) is type(b), path
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert type(a) is type(b) and a == b, path


def test_reader_matches_flax_on_best_checkpoint():
    blob = (RUN_DIR / "best.ckpt").read_bytes()
    ref = serialization.msgpack_restore(blob)
    out = t_checkpoint.msgpack_restore(blob)
    _assert_same_tree(out, ref)
    for section in ("params", "opt_state"):
        _assert_same_tree(t_checkpoint.msgpack_restore(out[section]), serialization.msgpack_restore(ref[section]))


def test_load_checkpoint_reads_params_and_meta():
    params, _, step, val_step, stats = t_checkpoint.load_checkpoint(RUN_DIR / "best.ckpt")
    assert step == 17500 and val_step > 0 and "psnr_vals" in stats
    assert params["segments"]["0"]["xyz"].shape == (8, 4, 2048)


def test_reader_joins_chunked_sections(tmp_path, monkeypatch):
    """Sections above the size limit are stored as lists of chunks
    (humanrf_tpu/train/checkpoint.py::_split)."""
    monkeypatch.setattr(j_checkpoint, "_MAX_SECTION", 1000)
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(40, 30)).astype(np.float32), "b": {"c": np.arange(7, dtype=np.int32)}}
    path = tmp_path / "chunked.ckpt"
    j_checkpoint.save_checkpoint(path, params, None, 3, 1, {"best_psnr": 1.5})
    assert isinstance(serialization.msgpack_restore(path.read_bytes())["params"], list)
    out, opt_state, step, val_step, stats = t_checkpoint.load_checkpoint(path)
    _assert_same_tree(out, params)
    assert opt_state is None and (step, val_step, stats) == (3, 1, {"best_psnr": 1.5})


def test_reader_unchunks_large_array_leaves(monkeypatch):
    """flax splits array leaves above MAX_CHUNK_SIZE bytes into chunk dicts."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 256)
    tree = {"big": np.arange(300, dtype=np.float32).reshape(10, 30), "small": np.ones(3, np.float64)}
    blob = serialization.msgpack_serialize(tree)
    assert "__msgpack_chunked_array__" in msgpack.unpackb(blob, raw=False)["big"]
    _assert_same_tree(t_checkpoint.msgpack_restore(blob), serialization.msgpack_restore(blob))


def test_reader_decodes_every_msgpack_family():
    """Every width of int, float, str, bin, array and map, nil and bools, and
    flax's numpy-scalar and complex extensions."""
    obj = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
                 -1, -32, -33, -128, -129, -32768, -32769, -(2**31), -(2**31) - 1, -(2**63)],
        "floats": [0.5, -1e300],
        "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "é" * 40000],
        "bins": [b"", b"x" * 300, b"y" * 70000],
        "arrays": [list(range(15)), list(range(16)), list(range(70000))],
        "maps": [{str(i): i for i in range(15)}, {str(i): i for i in range(16)}, {str(i): i for i in range(70000)}],
        "flags": [None, True, False],
        "scalar": np.float32(2.5),
        "complex": 1.5 - 2j,
    }
    blob = serialization.msgpack_serialize(obj)
    _assert_same_tree(t_checkpoint.msgpack_restore(blob), serialization.msgpack_restore(blob))
    single = msgpack.packb(3.25, use_single_float=True)
    assert t_checkpoint.msgpack_restore(single) == msgpack.unpackb(single)
    with pytest.raises(ValueError):
        t_checkpoint.msgpack_restore(blob[:-1])


def test_convert_maps_every_leaf():
    params, _, _, _, _ = t_checkpoint.load_checkpoint(RUN_DIR / "best.ckpt")
    view = load_view_inputs(RUN_DIR / "torch_view_inputs.npz", "cpu")
    model = HumanRFModel(view.model_config)
    state = convert_params(params)
    model.load_state_dict(state)  # strict: no missing and no unexpected key

    leaves = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}.")
            else:
                leaves[f"{prefix}{k}"] = v

    walk(params, "")
    assert len(leaves) == len(state) == len(list(model.parameters()))
    for name, leaf in leaves.items():
        np.testing.assert_array_equal(model.get_parameter(name).detach().numpy(), leaf, err_msg=name)


# ------------------------------------------------ the writer and the optimizer

_TINY = dict(
    sorted_frame_numbers=(0, 1, 2, 3), segment_sizes=(2, 2), density_scale=10.0, n_levels=2, n_features_per_level=2,
    log2_hashmap_size=10, coarsest_resolution=4, finest_resolution=16, geometry_feature_dim=3, n_neurons=16,
    n_hidden_layers_density=1, n_hidden_layers_color=1, sh_degree=2, camera_embedding_dim=2, proposal_rank=4,
    proposal_resolution=8,
)


def _tiny_models():
    """A JAX model's fresh parameters (every kind of leaf: two segments,
    proposal, camera embeddings) and a port model holding the same values."""
    import jax

    from humanrf_torch.models.humanrf import HumanRFConfig as TConfig
    from humanrf_tpu.models.humanrf import HumanRFConfig, HumanRFModel as JModel

    jparams = JModel(HumanRFConfig(**_TINY)).init_params(jax.random.PRNGKey(0))
    jparams = jax.tree_util.tree_map(np.asarray, jparams)
    tmodel = HumanRFModel(TConfig(**_TINY))
    tmodel.load_state_dict(convert_params(jparams))
    return jparams, tmodel


def _grads(jparams, seed, nan=False):
    import jax

    rng = np.random.default_rng(seed)
    g = jax.tree_util.tree_map(lambda p: rng.normal(scale=0.1, size=p.shape).astype(np.float32), jparams)
    if nan:
        g["sigma_net"]["w0"][0, 0] = np.nan
    return g


def _steps(jparams, tmodel, weight_decay, grads):
    """Apply `grads` with the JAX optimizer and with the port's → (JAX params,
    JAX state, port optimizer)."""
    import jax
    import jax.numpy as jnp
    import optax

    from humanrf_torch.train.trainer import make_optimizer as t_make_optimizer
    from humanrf_tpu.train.trainer import make_optimizer as j_make_optimizer

    jopt = j_make_optimizer(1e-2, 0.5, 100, weight_decay=weight_decay)
    jp = jax.tree_util.tree_map(jnp.asarray, jparams)
    jstate = jopt.init(jp)
    topt = t_make_optimizer(tmodel.named_parameters(), 1e-2, 0.5, 100, weight_decay=weight_decay)
    for g in grads:
        updates, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), jstate, jp)
        jp = optax.apply_updates(jp, updates)
        flat = convert_params(g)
        for name, p in tmodel.named_parameters():
            p.grad = flat[name].clone()
        topt.step()
    return jp, jstate, topt


def _assert_close_tree(a, b, path="root"):
    """Same structure and leaf dtypes and shapes; float leaves within fp32
    rounding of Adam's powers and quotients, other leaves equal."""
    if isinstance(b, dict):
        assert isinstance(a, dict) and sorted(a) == sorted(b), (path, sorted(a), sorted(b))
        for k in b:
            _assert_close_tree(a[k], b[k], f"{path}/{k}")
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (path, a.dtype, b.dtype, a.shape, b.shape)
    if a.dtype.kind == "f":
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9, err_msg=path)
    else:
        np.testing.assert_array_equal(a, b, err_msg=path)


@pytest.mark.parametrize("weight_decay", [0.03, 0.0])
def test_optimizer_state_maps_onto_the_jax_state(weight_decay):
    """Three steps, the second non-finite: the port's state as a JAX tree
    (`opt_state_to_jax`) equals optax's `apply_if_finite(adamw | adam)`
    state of the same steps, skip counters included."""
    from flax import serialization

    from humanrf_torch.convert import opt_state_to_jax

    jparams, tmodel = _tiny_models()
    grads = [_grads(jparams, 1), _grads(jparams, 2, nan=True), _grads(jparams, 3)]
    _, jstate, topt = _steps(jparams, tmodel, weight_decay, grads)
    jtree = serialization.to_state_dict(jstate)
    ttree = opt_state_to_jax(topt)
    _assert_close_tree(ttree, jtree)
    assert int(ttree["inner_state"]["0"]["count"]) == 2 and int(ttree["total_notfinite"]) == 1
    assert int(ttree["notfinite_count"]) == 0 and bool(ttree["last_finite"])


@pytest.mark.parametrize("weight_decay", [0.03, 0.0])
def test_a_jax_state_loaded_into_the_port_continues_to_the_same_update(weight_decay):
    """Two steps in JAX, the second non-finite (so the consecutive-skip count
    is 1), loaded into a fresh port model and optimizer; then one more step
    with the same gradient on both: parameters within 1e-6."""
    import jax
    import optax
    from flax import serialization

    from humanrf_torch.convert import load_opt_state
    from humanrf_torch.train.trainer import make_optimizer as t_make_optimizer
    from humanrf_tpu.train.trainer import make_optimizer as j_make_optimizer

    jparams, tmodel = _tiny_models()
    jp, jstate, _ = _steps(jparams, tmodel, weight_decay, [_grads(jparams, 1), _grads(jparams, 2, nan=True)])
    fresh = HumanRFModel(tmodel.config)
    fresh.load_state_dict(convert_params(jax.tree_util.tree_map(np.asarray, jp)))
    topt = t_make_optimizer(fresh.named_parameters(), 1e-2, 0.5, 100, weight_decay=weight_decay)
    load_opt_state(topt, jax.tree_util.tree_map(np.asarray, serialization.to_state_dict(jstate)))
    assert (int(topt.count), int(topt.notfinite_count), int(topt.skipped), bool(topt.last_finite)) == (1, 1, 1, False)

    g = _grads(jparams, 4)
    updates, _ = j_make_optimizer(1e-2, 0.5, 100, weight_decay=weight_decay).update(g, jstate, jp)
    jp = convert_params(jax.tree_util.tree_map(np.asarray, optax.apply_updates(jp, updates)))
    flat = convert_params(g)
    for name, p in fresh.named_parameters():
        p.grad = flat[name]
    topt.step()
    for name, p in fresh.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), jp[name].numpy(), rtol=1e-6, atol=1e-7, err_msg=name)
    with pytest.raises(ValueError, match="chained states"):
        other = t_make_optimizer(fresh.named_parameters(), 1e-2, 0.5, 100, weight_decay=0.03 - weight_decay)
        load_opt_state(other, serialization.to_state_dict(jstate))


def test_jax_restores_a_port_checkpoint(tmp_path, monkeypatch):
    """A port checkpoint (params and optimizer state), with its sections
    chunked and its array leaves split into flax chunk dicts under small
    limits, restored by the JAX package's `load_checkpoint` into its
    templates: leaves equal in value, shape and dtype to what JAX's own
    save of the same values restores."""
    import jax
    from flax import serialization

    from humanrf_torch.convert import export_params, opt_state_to_jax
    from humanrf_tpu.train.trainer import make_optimizer as j_make_optimizer

    jparams, tmodel = _tiny_models()
    jp, jstate, topt = _steps(jparams, tmodel, 0.03, [_grads(jparams, 1), _grads(jparams, 2, nan=True)])
    stats = {"psnr_vals": [12.5], "best_lpips": float("inf"), "checkpoints": ["a"]}

    monkeypatch.setattr(t_checkpoint, "_MAX_SECTION", 4096)
    monkeypatch.setattr(t_checkpoint, "_MAX_CHUNK_SIZE", 512)
    port_path, jax_path = tmp_path / "port.ckpt", tmp_path / "jax.ckpt"
    t_checkpoint.save_checkpoint(port_path, export_params(tmodel), opt_state_to_jax(topt), 2, 1, stats)
    payload = serialization.msgpack_restore(port_path.read_bytes())
    assert isinstance(payload["params"], list) and isinstance(payload["opt_state"], list)
    assert not (tmp_path / "port.ckpt.tmp").exists()
    j_checkpoint.save_checkpoint(jax_path, jp, jstate, 2, 1, stats)

    template_params = jax.tree_util.tree_map(np.zeros_like, jparams)
    template_state = j_make_optimizer(1e-2, 0.5, 100, weight_decay=0.03).init(template_params)
    port = j_checkpoint.load_checkpoint(port_path, template_params, template_state)
    ref = j_checkpoint.load_checkpoint(jax_path, template_params, template_state)
    assert port[2:] == ref[2:] == (2, 1, stats)
    assert jax.tree_util.tree_structure(port[1]) == jax.tree_util.tree_structure(ref[1])
    _assert_close_tree(serialization.to_state_dict(port[0]), serialization.to_state_dict(ref[0]))
    _assert_close_tree(serialization.to_state_dict(port[1]), serialization.to_state_dict(ref[1]))


def test_port_resumes_the_jax_best_checkpoint_with_its_optimizer_state():
    """best.ckpt of the JAX r4 run: step 17,500, validation count 7, the
    trainer's stats; its optax state loads into the port's AdamW on the r4
    model and maps back to the same tree bit for bit."""
    from humanrf_torch.convert import load_opt_state, opt_state_to_jax
    from humanrf_torch.train.trainer import make_optimizer as t_make_optimizer

    params, opt_state, step, val_step, stats = t_checkpoint.load_checkpoint(RUN_DIR / "best.ckpt")
    assert (step, val_step) == (17500, 7)
    assert {"psnr_vals", "ssim_vals", "lpips_vals", "checkpoints", "best_psnr", "best_ssim", "best_lpips"} <= set(stats)
    view = load_view_inputs(RUN_DIR / "torch_view_inputs.npz", "cpu")
    model = HumanRFModel(view.model_config)
    model.load_state_dict(convert_params(params))
    optimizer = t_make_optimizer(model.named_parameters(), 1e-2, 0.5, 50_001, weight_decay=0.03)
    load_opt_state(optimizer, opt_state)
    assert int(optimizer.count) == int(opt_state["inner_state"]["0"]["count"]) > 0
    _assert_same_tree(opt_state_to_jax(optimizer), opt_state)
