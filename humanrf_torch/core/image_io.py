"""Image files without OpenCV: baseline JPEG through a small C codec, PNG
through `zlib`.

The JAX package reads and writes every image with `cv2`; the port depends on
torch, numpy and scipy only, so it carries its own codec with cv2's results:

- `imread(path)` → (H, W, 3) uint8 **BGR**, as `cv2.imread(path)` returns it
  (a grayscale or gray+alpha file is replicated into three channels, alpha
  dropped). A baseline JPEG decodes bit for bit as cv2's libjpeg-turbo
  decodes it (`csrc/jpeg_codec.c`); progressive, arithmetic-coded, lossless
  and 12-bit JPEGs raise `ValueError` naming the file.
- `imwrite(path, img, quality=95)` → the format by suffix, as
  `cv2.imwrite(path, img, [IMWRITE_JPEG_QUALITY, quality])`: a JPEG is what
  cv2 writes (JFIF, libjpeg's tables and quality scaling, 4:2:0, islow
  DCT); a PNG is 8-bit gray, RGB (from BGR) or RGBA (from BGRA),
  non-interlaced.

The C library (`csrc/jpeg_codec.c`) is built with the system C compiler into
`humanrf_torch/build/` at first use (`ops/cuda_build.py`); if it cannot be
built the call raises. ctypes releases the GIL while it runs, so loader
threads decode in parallel. PNG's rows are unfiltered by the same library.
"""
from __future__ import annotations

import ctypes
import struct
import zlib
from pathlib import Path

import numpy as np

from humanrf_torch.ops.cuda_build import load_library

_ERRLEN = 256
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _codec():
    lib = load_library("jpeg_codec").lib
    if not getattr(lib, "_humanrf_typed", False):
        c_i64, c_int, c_p = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
        lib.jpeg_info.argtypes = [c_p, c_i64, ctypes.POINTER(c_int), ctypes.POINTER(c_int), ctypes.POINTER(c_int), ctypes.c_char_p, c_int]
        lib.jpeg_info.restype = c_int
        lib.jpeg_decode.argtypes = [c_p, c_i64, c_p, c_int, c_int, ctypes.c_char_p, c_int]
        lib.jpeg_decode.restype = c_int
        lib.jpeg_encode.argtypes = [c_p, c_int, c_int, c_int, c_int, ctypes.POINTER(c_i64)]
        lib.jpeg_encode.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.jpeg_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
        lib.jpeg_free.restype = None
        lib.png_unfilter.argtypes = [c_p, c_int, c_i64, c_int, c_p]
        lib.png_unfilter.restype = c_int
        lib._humanrf_typed = True
    return lib


# ------------------------------------------------------------------ JPEG


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """JPEG bytes → (H, W, 3) uint8 BGR."""
    lib = _codec()
    buf = np.frombuffer(data, dtype=np.uint8)
    err = ctypes.create_string_buffer(_ERRLEN)
    w, h, c = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if lib.jpeg_info(buf.ctypes.data, buf.size, ctypes.byref(w), ctypes.byref(h), ctypes.byref(c), err, _ERRLEN):
        raise ValueError(f"{name}: {err.value.decode()}")
    out = np.empty((h.value, w.value, 3), dtype=np.uint8)
    rc = lib.jpeg_decode(buf.ctypes.data, buf.size, out.ctypes.data, w.value, h.value, err, _ERRLEN)
    if rc == -2:
        raise MemoryError(f"{name}: {err.value.decode()}")
    if rc:
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def encode_jpeg(img: np.ndarray, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 BGR or (H, W) uint8 gray → JPEG bytes."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = np.ascontiguousarray(img[..., 0])
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"JPEG needs a gray or 3-channel image, got shape {img.shape}")
    channels = 1 if img.ndim == 2 else 3
    lib = _codec()
    n = ctypes.c_int64()
    ptr = lib.jpeg_encode(img.ctypes.data, img.shape[1], img.shape[0], channels, int(quality), ctypes.byref(n))
    if not ptr:
        raise MemoryError(f"JPEG encode of a {img.shape} image failed")
    try:
        return ctypes.string_at(ptr, n.value)
    finally:
        lib.jpeg_free(ptr)


# ------------------------------------------------------------------- PNG


def _chunks(data: bytes, name: str):
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{name}: truncated PNG chunk {kind!r}")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{name}: PNG without IEND")


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """PNG bytes → (H, W, C) uint8 with C = 1 (gray), 2 (gray+alpha), 3 (RGB)
    or 4 (RGBA), in the file's channel order."""
    header, idat = None, []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{name}: PNG without IHDR")
    width, height, depth, color, _, _, interlace = header
    channels = {0: 1, 4: 2, 2: 3, 6: 4}.get(color)
    if depth != 8 or channels is None or interlace:
        raise ValueError(f"{name}: only 8-bit non-interlaced gray/RGB(A) PNGs are supported "
                         f"(depth {depth}, color type {color}, interlace {interlace})")
    raw = zlib.decompress(b"".join(idat))
    rowbytes = width * channels
    if len(raw) < height * (rowbytes + 1):
        raise ValueError(f"{name}: truncated PNG image data")
    raw = np.frombuffer(raw, dtype=np.uint8)
    out = np.empty((height, width, channels), dtype=np.uint8)
    if _codec().png_unfilter(raw.ctypes.data, height, rowbytes, channels, out.ctypes.data):
        raise ValueError(f"{name}: unknown PNG filter type")
    return out


def encode_png(img: np.ndarray, compression: int = 1) -> bytes:
    """(H, W) or (H, W, 1) gray, (H, W, 3) BGR or (H, W, 4) BGRA uint8 → PNG
    bytes (filter None, zlib at `compression`)."""
    img = np.asarray(img, dtype=np.uint8)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        img, color = img[..., ::-1], 2  # BGR → RGB
    elif img.ndim == 3 and img.shape[2] == 4:
        img, color = img[..., [2, 1, 0, 3]], 6  # BGRA → RGBA
    else:
        raise ValueError(f"PNG needs a gray, 3- or 4-channel image, got shape {img.shape}")
    height, width = img.shape[:2]
    rows = np.ascontiguousarray(img).reshape(height, -1)
    raw = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1).tobytes()

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    return b"".join([
        _PNG_SIGNATURE,
        chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, color, 0, 0, 0)),
        chunk(b"IDAT", zlib.compress(raw, compression)),
        chunk(b"IEND", b""),
    ])


# ------------------------------------------------------------ cv2-like API


def imread(path) -> np.ndarray:
    """`cv2.imread(path)`: (H, W, 3) uint8 BGR. Raises FileNotFoundError for a
    missing file and ValueError for one it cannot decode."""
    path = Path(path)
    data = path.read_bytes()
    if data[:8] == _PNG_SIGNATURE:
        img = decode_png(data, str(path))
        c = img.shape[2]
        if c <= 2:
            return np.repeat(img[..., :1], 3, axis=2)
        return np.ascontiguousarray(img[..., 2::-1])  # RGB(A) → BGR
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data, str(path))
    raise ValueError(f"{path}: neither a JPEG nor a PNG file")


def imwrite(path, img: np.ndarray, quality: int = 95) -> None:
    """`cv2.imwrite(path, img, [IMWRITE_JPEG_QUALITY, quality])` for .jpg/.jpeg
    and .png paths; `img` is BGR, BGRA (PNG only) or gray uint8."""
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix in (".jpg", ".jpeg"):
        data = encode_jpeg(img, quality)
    elif suffix == ".png":
        data = encode_png(img)
    else:
        raise ValueError(f"{path}: unsupported image suffix {suffix!r}")
    path.write_bytes(data)
