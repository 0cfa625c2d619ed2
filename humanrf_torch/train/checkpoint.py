"""Checkpoints in the JAX package's format, with no flax or msgpack package.

Counterpart of `humanrf_tpu/train/checkpoint.py`. A checkpoint is one msgpack
map `{"params", "opt_state", "meta"}`: `params` and `opt_state` are flax
`to_bytes` blobs (themselves msgpack), stored as one `bin` or, above 1 GiB, as
a list of chunks; `meta` is JSON bytes of step, val_step and stats.

`msgpack_restore` decodes the subset of msgpack that flax writes (maps,
arrays, str, bin, nil/bool, ints, floats, and flax's ext types for ndarrays,
numpy scalars and complex numbers) and reassembles flax's chunked array
leaves, so it returns what `flax.serialization.msgpack_restore` returns;
`msgpack_serialize` writes that subset as flax does (array leaves above 1 GiB
as flax's chunk dicts). So the JAX package's `load_checkpoint` restores a
checkpoint of the port (`save_checkpoint`) into its templates, and the port
resumes a JAX one (`load_checkpoint`, with `convert.load_opt_state`).
"""
from __future__ import annotations

import json
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

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


class _Writer:
    def __init__(self):
        self.parts = []

    def head(self, small: int, tags, n: int) -> None:
        """A length or value header: the fix form below `small`, else the
        smallest of the (limit, tag byte, struct format) forms."""
        if small and n < small[0]:
            self.parts.append(bytes([small[1] | n]))
            return
        for limit, tag, fmt in tags:
            if n < limit:
                self.parts.append(bytes([tag]) + struct.pack(fmt, n))
                return
        raise ValueError(f"msgpack length {n} too large")

    def obj(self, x) -> None:
        if x is None:
            self.parts.append(b"\xc0")
        elif type(x) is bool:
            self.parts.append(b"\xc3" if x else b"\xc2")
        elif type(x) is int:
            self.int_(x)
        elif type(x) is float:
            self.parts.append(b"\xcb" + struct.pack(">d", x))
        elif type(x) is str:
            b = x.encode("utf-8")
            self.head((32, 0xA0), ((1 << 8, 0xD9, ">B"), (1 << 16, 0xDA, ">H"), (1 << 32, 0xDB, ">I")), len(b))
            self.parts.append(b)
        elif isinstance(x, (bytes, bytearray, memoryview)):
            b = bytes(x)
            self.head(None, ((1 << 8, 0xC4, ">B"), (1 << 16, 0xC5, ">H"), (1 << 32, 0xC6, ">I")), len(b))
            self.parts.append(b)
        elif isinstance(x, (list, tuple)):
            self.head((16, 0x90), ((1 << 16, 0xDC, ">H"), (1 << 32, 0xDD, ">I")), len(x))
            for v in x:
                self.obj(v)
        elif isinstance(x, dict):
            self.head((16, 0x80), ((1 << 16, 0xDE, ">H"), (1 << 32, 0xDF, ">I")), len(x))
            for k, v in x.items():
                self.obj(k)
                self.obj(v)
        elif isinstance(x, np.ndarray):
            self.ext(_EXT_NDARRAY, _ndarray_to_bytes(x))
        elif isinstance(x, np.generic):
            self.ext(_EXT_NPSCALAR, _ndarray_to_bytes(np.asarray(x)))
        else:
            raise TypeError(f"cannot serialize {type(x).__name__}")

    def int_(self, n: int) -> None:
        if 0 <= n < 128:
            self.parts.append(bytes([n]))
        elif -32 <= n < 0:
            self.parts.append(struct.pack(">b", n))
        elif n >= 0:
            self.head(None, ((1 << 8, 0xCC, ">B"), (1 << 16, 0xCD, ">H"), (1 << 32, 0xCE, ">I"), (1 << 64, 0xCF, ">Q")), n)
        else:
            for lo, tag, fmt in ((-(1 << 7), 0xD0, ">b"), (-(1 << 15), 0xD1, ">h"), (-(1 << 31), 0xD2, ">i"), (-(1 << 63), 0xD3, ">q")):
                if n >= lo:
                    self.parts.append(bytes([tag]) + struct.pack(fmt, n))
                    return
            raise ValueError(f"integer {n} out of msgpack range")

    def ext(self, code: int, data: bytes) -> None:
        n = len(data)
        fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixext:
            self.parts.append(bytes([fixext[n]]))
        else:
            self.head(None, ((1 << 8, 0xC7, ">B"), (1 << 16, 0xC8, ">H"), (1 << 32, 0xC9, ">I")), n)
        self.parts.append(struct.pack(">b", code) + data)


def _ndarray_to_bytes(arr: np.ndarray) -> bytes:
    """flax's ndarray encoding: msgpack (shape, dtype name, C-order buffer)."""
    return _packb([list(arr.shape), arr.dtype.name, np.ascontiguousarray(arr).tobytes()])


def _packb(x) -> bytes:
    w = _Writer()
    w.obj(x)
    return b"".join(w.parts)


def _chunk_leaves(tree):
    """flax's `_chunk_array_leaves_in_place`, on a copy: arrays above 1 GiB
    become {"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}."""
    if isinstance(tree, dict):
        return {k: _chunk_leaves(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.size * tree.dtype.itemsize > _MAX_CHUNK_SIZE:
        size = max(1, int(_MAX_CHUNK_SIZE / tree.dtype.itemsize))
        flat = tree.reshape(-1)
        chunks = [flat[i : i + size] for i in range(0, flat.size, size)]
        return {
            _CHUNKED_ARRAY_KEY: True,
            "shape": {str(i): int(d) for i, d in enumerate(tree.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)},
        }
    return tree


def msgpack_serialize(tree) -> bytes:
    """Encode dicts (str keys), lists, str, bytes, bool, None, ints, floats
    and numpy arrays/scalars as `flax.serialization.msgpack_serialize` does."""
    return _packb(_chunk_leaves(tree))


def _join(section) -> bytes:
    return section if isinstance(section, bytes) else b"".join(section)


def _split(blob: bytes):
    if len(blob) <= _MAX_SECTION:
        return blob
    return [blob[i : i + _MAX_SECTION] for i in range(0, len(blob), _MAX_SECTION)]


def save_checkpoint(path, params: Dict[str, Any], opt_state: Optional[Dict[str, Any]], step: int, val_step: int,
                    stats: Dict[str, Any]) -> None:
    """Write a checkpoint of flax state-dict trees (`convert.export_params`,
    `convert.opt_state_to_jax`) to a `.tmp` file, then rename it over `path`."""
    payload = {
        "params": _split(msgpack_serialize(params)),
        "opt_state": _split(msgpack_serialize(opt_state)),
        "meta": json.dumps({"step": step, "val_step": val_step, "stats": stats}).encode(),
    }
    tmp = Path(str(path) + ".tmp")
    tmp.write_bytes(_packb(payload))
    tmp.rename(path)


def load_checkpoint(path) -> Tuple[Dict[str, Any], Optional[Dict[str, Any]], int, int, Dict[str, Any]]:
    """→ (params tree, optimizer-state tree or None, step, val_step, stats),
    the trees of numpy arrays as flax state dicts: lists (segments, proposal,
    optax's chained states) come back as dicts keyed "0", "1", ..."""
    payload = msgpack_restore(Path(path).read_bytes())
    params = msgpack_restore(_join(payload["params"]))
    opt_state = msgpack_restore(_join(payload["opt_state"])) if "opt_state" in payload else None
    meta = json.loads(payload["meta"].decode())
    return params, opt_state, meta["step"], meta["val_step"], meta["stats"]


def resolve_checkpoint(checkpoints_dir: Path, checkpoint: Optional[str]) -> Optional[Path]:
    """'latest' → newest step_*.ckpt; 'best' → best.ckpt; else a literal
    path. None when nothing is found."""
    if checkpoint is None:
        return None
    if checkpoint == "latest":
        candidates = sorted(Path(checkpoints_dir).glob(f"step_*{CHECKPOINT_SUFFIX}"))
        return candidates[-1] if candidates else None
    if checkpoint == "best":
        best = Path(checkpoints_dir) / f"best{CHECKPOINT_SUFFIX}"
        return best if best.exists() else None
    p = Path(checkpoint)
    return p if p.exists() else None
