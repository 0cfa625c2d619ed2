"""Host side of the mesh renderer: OBJ meshes, the calibration CSV in
float32, the camera rotation and PFM depth maps.

The port's copy of what `humanrf_tpu/native/mesh_renderer/main.cpp` does on
the host, to the bit, so that `toolbox/mesh_renderer.py` writes the native
tool's masks and depths:

- `load_obj` (`main.cpp:110-136`): `v` lines and `f` lines with `a`, `a/t` or
  `a/t/n` tokens, negative indices relative to the vertices read so far, and
  polygons fan-triangulated as (0, k-1, k). The file is tokenised with numpy
  over its bytes, not line by line in Python. Vertex coordinates are parsed
  to float32 as `sscanf("%f")` parses them, correctly rounded: through
  float64, and with the C library's `strtof` for the rare values whose
  float64 lies exactly halfway between two float32 (the only ones where
  rounding twice can differ from rounding once).
- `read_calibration_f32` (`main.cpp:77-103`): every value through `strtof`,
  as `std::stof` parses it.
- `rotation_from_axisangle_f32` (`main.cpp:57-67`): Rodrigues in float32,
  with `cosf` and `sinf` from the C library through ctypes. Other cosines
  (numpy's, torch's, a float64 cosine rounded) differ from glibc's on a few
  percent of float32 inputs, and one ulp of the rotation moves depths and
  edge pixels.
- `write_pfm` (`main.cpp:216-223`): `Pf\\n<w> <h>\\n-1.0\\n`, rows bottom to top.
"""
from __future__ import annotations

import ctypes
import ctypes.util
import functools
import re
from dataclasses import dataclass
from pathlib import Path
from typing import List, Tuple

import numpy as np

_WHITESPACE = np.zeros(256, dtype=bool)
_WHITESPACE[[ord(c) for c in " \t\r\v\f"]] = True
_DIGIT = np.zeros(256, dtype=bool)
_DIGIT[ord("0") : ord("9") + 1] = True
_STOI = re.compile(rb"\s*([+-]?\d+)")


# ----------------------------------------------------------------- libc


@functools.cache
def _libc():
    lib = ctypes.CDLL(ctypes.util.find_library("c"))
    lib.strtof.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p)]
    lib.strtof.restype = ctypes.c_float
    return lib


@functools.cache
def _libm():
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name in ("cosf", "sinf"):
        getattr(lib, name).argtypes = [ctypes.c_float]
        getattr(lib, name).restype = ctypes.c_float
    return lib


def strtof(text: bytes) -> np.float32:
    """`std::stof`: leading whitespace skipped, the longest float prefix
    parsed by the C library, anything after it ignored; raises when nothing
    converts."""
    end = ctypes.c_char_p()
    buf = ctypes.create_string_buffer(text)
    value = _libc().strtof(buf, ctypes.byref(end))
    if ctypes.cast(end, ctypes.c_void_p).value == ctypes.addressof(buf):
        raise ValueError(f"stof: no conversion of {text!r}")
    return np.float32(value)


def stoi(text: bytes) -> int:
    """`std::stoi`: leading whitespace, a sign and digits; the rest ignored."""
    match = _STOI.match(text)
    if match is None:
        raise ValueError(f"stoi: no conversion of {text!r}")
    value = int(match.group(1))
    if not -(2**31) <= value < 2**31:
        raise ValueError(f"stoi: {text!r} is out of range")
    return value


def parse_f32(tokens: np.ndarray) -> np.ndarray:
    """A bytes array of decimal literals → float32, each correctly rounded
    (as `strtof`)."""
    doubles = tokens.astype(np.float64)
    with np.errstate(over="ignore"):
        out = doubles.astype(np.float32)
    bits = doubles.view(np.uint64)
    magnitude = np.abs(doubles)
    # A float64 exactly halfway between two normal float32 has its 29 low
    # mantissa bits 1 followed by zeros; subnormal and overflowing results
    # round at other bits. Those few go through strtof.
    halfway = (bits & np.uint64((1 << 29) - 1)) == np.uint64(1 << 28)
    redo = (halfway & (magnitude >= 2.0**-126)) | ((magnitude > 0) & (magnitude < 2.0**-126))
    redo |= np.isfinite(doubles) & (magnitude >= float(np.finfo(np.float32).max))
    for i in np.flatnonzero(redo):
        out[i] = strtof(bytes(tokens[i]))
    return out


# ------------------------------------------------------------------ OBJ


def _tokens(buf: np.ndarray, starts: np.ndarray, ends: np.ndarray):
    """The whitespace-separated tokens of the byte ranges [starts, ends) →
    (token start, token end, index of its range), in file order."""
    n = len(buf) + 1
    inside = np.cumsum(np.bincount(starts, minlength=n) - np.bincount(ends, minlength=n))[:-1] > 0
    token = inside & ~_WHITESPACE[buf]
    prev = np.concatenate([[False], token[:-1]])
    following = np.concatenate([token[1:], [False]])
    tok_start = np.flatnonzero(token & ~prev)
    tok_end = np.flatnonzero(token & ~following) + 1
    return tok_start, tok_end, np.searchsorted(starts, tok_start, side="right") - 1


def token_bytes(buf: np.ndarray, tok_start: np.ndarray, tok_end: np.ndarray) -> np.ndarray:
    """The byte ranges [tok_start, tok_end) of `buf` as a fixed-width bytes array."""
    lengths = tok_end - tok_start
    width = max(int(lengths.max(initial=0)), 1)
    table = np.zeros((len(tok_start), width), dtype=np.uint8)
    rows = np.repeat(np.arange(len(tok_start)), lengths)
    cols = np.arange(len(rows)) - np.repeat(np.cumsum(lengths) - lengths, lengths)
    table[rows, cols] = buf[tok_start[rows] + cols]
    return table.view(f"S{width}").reshape(-1)


def _leading_ints(buf: np.ndarray, tok_start: np.ndarray, tok_end: np.ndarray) -> np.ndarray:
    """`std::stoi(token.substr(0, token.find('/')))` of each token."""
    padded = np.concatenate([buf, [ord(" ")]])
    sign = padded[tok_start]
    negative = sign == ord("-")
    first = tok_start + ((sign == ord("-")) | (sign == ord("+")))
    value = np.zeros(len(tok_start), dtype=np.int64)
    ndigits = np.zeros(len(tok_start), dtype=np.int64)
    running = np.ones(len(tok_start), dtype=bool)
    for k in range(11):
        pos = np.minimum(first + k, tok_end)
        running &= (first + k < tok_end) & _DIGIT[padded[pos]]
        if not running.any():
            break
        value = np.where(running, value * 10 + (padded[pos].astype(np.int64) - ord("0")), value)
        ndigits += running
    if (ndigits == 0).any():
        bad = int(np.flatnonzero(ndigits == 0)[0])
        raise ValueError(f"stoi: no conversion of face token {bytes(buf[tok_start[bad]:tok_end[bad]])!r}")
    value = np.where(negative, -value, value)
    if running.any() or (np.abs(value) >= 2**31).any():
        raise ValueError("stoi: a face index is out of range")
    return value


def load_obj(path) -> Tuple[np.ndarray, np.ndarray]:
    """An OBJ file → (vertices (V, 3) float32, faces (F, 3) int32), the faces
    of each `f` line fan-triangulated in order. A face index outside the
    vertices raises (the native tool would read past its array)."""
    data = Path(path).read_bytes()
    buf = np.frombuffer(data, dtype=np.uint8)
    newlines = np.flatnonzero(buf == ord("\n"))
    starts = np.concatenate([[0], newlines + 1]).astype(np.int64)
    ends = np.concatenate([newlines, [len(buf)]]).astype(np.int64)
    padded = np.concatenate([buf, [0, 0]])
    long_enough = ends - starts >= 2
    is_v = long_enough & (padded[starts] == ord("v")) & (padded[starts + 1] == ord(" "))
    is_f = long_enough & (padded[starts] == ord("f")) & (padded[starts + 1] == ord(" "))

    # One pass of tokens over the payloads of both kinds of line.
    lines = np.flatnonzero(is_v | is_f)
    tok_start, tok_end, which = _tokens(buf, starts[lines] + 2, ends[lines])
    line = lines[which]
    first_of_line = np.searchsorted(line, line)  # each token's line's first token
    rank = np.arange(len(line)) - first_of_line

    # Vertices: the first three tokens of each `v` line; missing ones stay 0.
    v_index = np.cumsum(is_v) - 1  # each line's vertex number (at a `v` line)
    vertices = np.zeros((int(is_v.sum()), 3), dtype=np.float32)
    keep = is_v[line] & (rank < 3)
    if keep.any():
        vertices[v_index[line[keep]], rank[keep]] = parse_f32(token_bytes(buf, tok_start[keep], tok_end[keep]))

    # Faces: (first, k-1, k) of each `f` line's tokens, k = 2..n-1.
    in_f = np.flatnonzero(is_f[line])
    if not len(in_f):
        return vertices, np.zeros((0, 3), dtype=np.int32)
    idx = _leading_ints(buf, tok_start[in_f], tok_end[in_f])
    vertices_before = v_index[line[in_f]] + 1  # `v` lines above each face line
    idx = np.where(idx < 0, vertices_before + idx + 1, idx) - 1
    corner = np.flatnonzero(rank[in_f] >= 2)
    first = np.searchsorted(in_f, first_of_line[in_f])  # in `idx`, each token's line's first token
    faces = np.stack([idx[first[corner]], idx[corner - 1], idx[corner]], axis=1)
    if len(faces) and (faces.min() < 0 or faces.max() >= len(vertices)):
        raise ValueError(f"{path}: a face index lies outside the {len(vertices)} vertices")
    return vertices, faces.astype(np.int32)


def _float_text(value: float) -> str:
    """A float as C++'s `ostream << float` writes it (glibc's "-nan")."""
    if value != value and np.signbit(value):
        return "-nan"
    return "%g" % value


def obj_text(positions: np.ndarray, counts: np.ndarray, indices: np.ndarray) -> str:
    """OBJ text as the native extractor writes it: a `v x y z` line for each
    triple of the positions, floats as C++'s default `ostream` writes them
    (`%g`, 6 significant digits, `-0` kept), then for each face an `f` line
    of its `counts[k]` indices, 1-based, in the order given."""
    array = np.asarray(positions, dtype=np.float32).reshape(-1)
    values = array[: len(array) // 3 * 3].astype(np.float64).tolist()
    if np.isfinite(array).all():
        text = ("v %g %g %g\n" * (len(values) // 3)) % tuple(values)
    else:
        text = "".join("v %s %s %s\n" % tuple(_float_text(v) for v in values[i : i + 3])
                       for i in range(0, len(values), 3))
    counts = np.asarray(counts, dtype=np.int64)
    line_format = {}
    fmt = "".join(line_format.setdefault(n, "f" + " %d" * n + "\n") for n in counts.tolist())
    return text + fmt % tuple((np.asarray(indices)[: int(counts.sum())].astype(np.int64) + 1).tolist())


def write_obj(path, vertices: np.ndarray, faces: np.ndarray) -> None:
    """A triangle mesh, (V, 3) vertices and (F, 3) faces, as `obj_text`."""
    faces = np.asarray(faces).reshape(-1, 3)
    Path(path).write_text(obj_text(vertices, np.full(len(faces), 3), faces.reshape(-1)))


# ----------------------------------------------------------- calibration


@dataclass
class Camera:
    """One calibration row as the native tool holds it: cam2world rotation
    and translation in float32, intrinsics normalised by width and height."""

    name: str
    width: int
    height: int
    rotation: np.ndarray  # (3, 3) float32, row-major cam2world
    translation: np.ndarray  # (3,) float32
    fx: np.float32
    fy: np.float32
    cx: np.float32
    cy: np.float32


def rotation_from_axisangle_f32(rx, ry, rz) -> np.ndarray:
    """Rodrigues in float32 (`main.cpp:57-67`), with the C library's cosf/sinf."""
    rx, ry, rz = np.float32(rx), np.float32(ry), np.float32(rz)
    theta = np.sqrt(rx * rx + ry * ry + rz * rz)
    if theta < np.float32(1e-12):
        return np.eye(3, dtype=np.float32)
    kx, ky, kz = rx / theta, ry / theta, rz / theta
    libm = _libm()
    c, s = np.float32(libm.cosf(float(theta))), np.float32(libm.sinf(float(theta)))
    ic = np.float32(1) - c
    return np.array([
        [c + kx * kx * ic, kx * ky * ic - kz * s, kx * kz * ic + ky * s],
        [ky * kx * ic + kz * s, c + ky * ky * ic, ky * kz * ic - kx * s],
        [kz * kx * ic - ky * s, kz * ky * ic + kx * s, c + kz * kz * ic],
    ], dtype=np.float32)


def read_calibration_f32(path) -> List[Camera]:
    """The calibration CSV (`name,w,h,rx,ry,rz,tx,ty,tz,fx,fy,px,py`) as the
    native tool reads it: the header line skipped, empty lines and rows of
    fewer than 13 columns ignored, numbers through stoi/stof."""
    cameras = []
    for line in Path(path).read_bytes().split(b"\n")[1:]:
        if not line:
            continue
        cols = line.split(b",")
        if cols[-1] == b"":
            cols = cols[:-1]  # getline(ss, tok, ',') yields no empty last column
        if len(cols) < 13:
            continue
        values = [strtof(col) for col in cols[3:13]]
        cameras.append(Camera(
            name=cols[0].decode(), width=stoi(cols[1]), height=stoi(cols[2]),
            rotation=rotation_from_axisangle_f32(*values[0:3]),
            translation=np.array(values[3:6], dtype=np.float32),
            fx=values[6], fy=values[7], cx=values[8], cy=values[9],
        ))
    return cameras


# ------------------------------------------------------------------ PFM


def write_pfm(path, depth: np.ndarray) -> None:
    """(H, W) float32 → a little-endian grayscale PFM, rows bottom to top."""
    depth = np.asarray(depth, dtype="<f4")
    height, width = depth.shape
    Path(path).write_bytes(b"Pf\n%d %d\n-1.0\n" % (width, height) + depth[::-1].tobytes())


def read_pfm(path) -> np.ndarray:
    """A grayscale PFM → (H, W) float32, rows top to bottom."""
    data = Path(path).read_bytes()
    kind, size, scale, body = data.split(b"\n", 3)
    if kind != b"Pf":
        raise ValueError(f"{path}: not a grayscale PFM")
    width, height = (int(v) for v in size.split())
    dtype = "<f4" if float(scale) < 0 else ">f4"
    return np.frombuffer(body, dtype=dtype, count=width * height).reshape(height, width)[::-1].astype(np.float32)
