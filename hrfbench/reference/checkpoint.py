"""Read a checkpoint of the port (the JAX package's format: one msgpack map
`{"params", "opt_state", "meta"}`, flax `to_bytes` blobs inside) into a
state dict of the reference model. A frozen copy of the port's reader: the
subset of msgpack that flax writes, with no msgpack package.
"""
from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

import numpy as np

CHECKPOINT_SUFFIX = ".ckpt"

# A checkpoint section above this many bytes is stored as a list of chunks
# (msgpack caps one bin at 2**32 - 1 bytes); flax chunks array leaves above
# the same size.
_MAX_SECTION = 1 << 30
_MAX_CHUNK_SIZE = 1 << 30

# flax.serialization._MsgpackExtType
_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3

_CHUNKED_ARRAY_KEY = "__msgpack_chunked_array__"


class _Reader:
    def __init__(self, data: bytes, raw_str: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw_str = raw_str

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw_str else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return _decode_ext(code, bytes(self.take(n)))

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def obj(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str_(b & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        fixed = {
            0xCA: ">f", 0xCB: ">d",
            0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
            0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q",
        }
        if b in fixed:
            return self.unpack(fixed[b])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:
            return bytes(self.take(self.unpack(lengths[b])))
        lengths = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in lengths:
            return self.str_(self.unpack(lengths[b]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        lengths = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in lengths:
            return self.ext(self.unpack(lengths[b]))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _unpackb(data: bytes, raw_str: bool = False) -> Any:
    reader = _Reader(data, raw_str)
    out = reader.obj()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    """flax's ndarray encoding: msgpack (shape, dtype name, C-order buffer)."""
    shape, dtype_name, buffer = _unpackb(data, raw_str=True)
    if dtype_name == b"bfloat16":
        raise ValueError("bfloat16 checkpoint leaves are not supported")
    return np.frombuffer(buffer, dtype=np.dtype(dtype_name.decode())).reshape(shape)


def _decode_ext(code: int, data: bytes):
    if code == _EXT_NDARRAY:
        return _ndarray_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _ndarray_from_bytes(data)[()]
    if code == _EXT_COMPLEX:
        real, imag = _unpackb(data)
        return complex(real, imag)
    raise ValueError(f"unknown msgpack ext type {code}")


def _unchunk(tree):
    """Reassemble flax's chunked array leaves (arrays above 1 GiB)."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED_ARRAY_KEY in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(encoded: bytes):
    """Decode flax msgpack bytes into dicts, lists and numpy leaves."""
    return _unchunk(_unpackb(encoded))


def _join(section) -> bytes:
    return section if isinstance(section, bytes) else b"".join(section)


def load_checkpoint(path) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]], int, int, Dict[str, Any]]:
    """→ (params tree, optimizer-state tree or None, step, val_step, stats),
    the trees of numpy arrays as flax state dicts: lists (segments, proposal,
    optax's chained states) come back as dicts keyed "0", "1", ..."""
    payload = msgpack_restore(Path(path).read_bytes())
    params = msgpack_restore(_join(payload["params"]))
    opt_state = msgpack_restore(_join(payload["opt_state"])) if "opt_state" in payload else None
    meta = json.loads(payload["meta"].decode())
    return params, opt_state, meta["step"], meta["val_step"], meta["stats"]


def _as_list(node) -> list:
    """A pytree list, or the "0", "1", ... dict a flax state dict makes of it."""
    if isinstance(node, dict):
        return [node[str(i)] for i in range(len(node))]
    return list(node)


def convert_params(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """→ a `HumanRFModel` state dict of float32 CPU tensors (copies)."""
    flat: Dict[str, np.ndarray] = {}
    for s, seg in enumerate(_as_list(params["segments"])):
        for name, leaf in seg.items():
            flat[f"segments.{s}.{name}"] = leaf
    for net in ("sigma_net", "color_net"):
        for name, leaf in params[net].items():
            flat[f"{net}.{name}"] = leaf
    for s, prop in enumerate(_as_list(params.get("proposal", []))):
        flat[f"proposal.{s}.factors"] = prop["factors"]
    if "camera_embeddings" in params:
        flat["camera_embeddings"] = params["camera_embeddings"]
    return {k: torch.tensor(np.asarray(v, dtype=np.float32)) for k, v in flat.items()}


