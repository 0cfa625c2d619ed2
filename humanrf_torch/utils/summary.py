"""A TensorBoard event-file writer without TensorFlow, tensorboardX or
protobuf.

`SummaryWriter(log_dir)` writes `events.out.tfevents.<time>.<host>` under
`log_dir`, the file TensorBoard reads: a sequence of TFRecords, each

    uint64 length | uint32 masked CRC32C(length) | data | uint32 masked CRC32C(data)

(little-endian; a masked CRC is ((crc >> 15) | (crc << 17)) + 0xa282ead8),
whose data is one `tensorflow.Event` protocol buffer, encoded here by hand:
first `file_version: "brain.Event:2"`, then one event per `add_scalar`
(`Summary.Value.simple_value`) and per `add_image` (`Summary.Image`, the
image PNG-encoded by `core/image_io.encode_png`). Each event is flushed as it
is written.
"""
from __future__ import annotations

import socket
import struct
import time
from pathlib import Path

import numpy as np

from humanrf_torch.core import image_io


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC32C_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli) of `data`."""
    crc = 0xFFFFFFFF
    table = _CRC32C_TABLE
    for byte in data:
        crc = table[(crc ^ byte) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    crc = crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


def tfrecord(data: bytes) -> bytes:
    length = struct.pack("<Q", len(data))
    return length + struct.pack("<I", masked_crc32c(length)) + data + struct.pack("<I", masked_crc32c(data))


# -------------------------------------------------------- protocol buffers


def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # negative int64 values take ten bytes, as protobuf writes them
    out = bytearray()
    while True:
        bits, n = n & 0x7F, n >> 7
        if n:
            out.append(bits | 0x80)
        else:
            out.append(bits)
            return bytes(out)


def _field(number: int, wire_type: int, payload: bytes) -> bytes:
    return _varint(number << 3 | wire_type) + payload


def _int(number: int, value: int) -> bytes:
    return _field(number, 0, _varint(int(value)))


def _bytes(number: int, value: bytes) -> bytes:
    return _field(number, 2, _varint(len(value)) + value)


def _event(wall_time: float, step: int, file_version: str = None, summary: bytes = None) -> bytes:
    """tensorflow.Event: wall_time = 1 (double), step = 2 (int64),
    file_version = 3 (string), summary = 5 (Summary)."""
    out = _field(1, 1, struct.pack("<d", wall_time)) + _int(2, step)
    if file_version is not None:
        out += _bytes(3, file_version.encode())
    if summary is not None:
        out += _bytes(5, summary)
    return out


def _summary_value(tag: str, simple_value: float = None, image: bytes = None) -> bytes:
    """Summary = {value = 1 (repeated Summary.Value)}; Summary.Value: tag = 1,
    simple_value = 2 (float), image = 4 (Summary.Image)."""
    value = _bytes(1, tag.encode())
    if simple_value is not None:
        value += _field(2, 5, struct.pack("<f", simple_value))
    if image is not None:
        value += _bytes(4, image)
    return _bytes(1, value)


class SummaryWriter:
    """`add_scalar` and `add_image` into one event file under `log_dir`."""

    def __init__(self, log_dir: Path) -> None:
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        self.path = log_dir / f"events.out.tfevents.{int(time.time()):010d}.{socket.gethostname()}"
        self._file = open(self.path, "wb")
        self._write(_event(time.time(), 0, file_version="brain.Event:2"))

    def _write(self, event: bytes) -> None:
        self._file.write(tfrecord(event))
        self._file.flush()

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._write(_event(time.time(), step, summary=_summary_value(tag, simple_value=float(value))))

    def add_image(self, tag: str, image: np.ndarray, step: int) -> None:
        """`image`: (H, W, 3) uint8 RGB."""
        height, width = image.shape[:2]
        png = image_io.encode_png(np.ascontiguousarray(image[..., ::-1]))  # the encoder takes BGR
        encoded = _int(1, height) + _int(2, width) + _int(3, 3) + _bytes(4, png)  # colorspace 3: RGB
        self._write(_event(time.time(), step, summary=_summary_value(tag, image=encoded)))

    def close(self) -> None:
        self._file.close()
