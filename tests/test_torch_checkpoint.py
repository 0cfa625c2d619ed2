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
    params, step, val_step, stats = t_checkpoint.load_checkpoint(RUN_DIR / "best.ckpt")
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
    out, step, val_step, stats = t_checkpoint.load_checkpoint(path)
    _assert_same_tree(out, params)
    assert (step, val_step, stats) == (3, 1, {"best_psnr": 1.5})


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
    params, _, _, _ = t_checkpoint.load_checkpoint(RUN_DIR / "best.ckpt")
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
