"""Minimal Alembic (.abc, Ogawa container) PolyMesh *writer*.

The port's copy of `humanrf_tpu/toolbox/write_alembic.py` (pure numpy; the
same bytes, held equal by `tests/test_torch_toolbox.py`). The format subset
is documented beside the JAX package's native reader
(`humanrf_tpu/native/alembic_extractor/abc_ogawa.hpp`): it writes an animated
triangle/polygon mesh as a single PolyMesh object with one stored sample per
frame. Used as the hermetic test fixture for the extractor and as a
dependency-free way to produce mesh sequences for tools that consume .abc
(e.g. the Blender exporter's person-mesh path, `export_blender.py`).

The reference ships no writer — its ActorsHQ archives come pre-made
(`actorshq/dataset/download_manager.py` downloads `meshes.abc`) and its
extractor links the full Alembic SDK.
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np

_DATA_BIT = 0x8000000000000000

# POD enum (matches abc_ogawa.hpp's reader).
POD_INT32 = 6
POD_FLOAT32 = 10


class _OgawaWriter:
    """Bottom-up Ogawa serializer: children are written before their group so
    every reference is known when the group body is emitted."""

    def __init__(self):
        # Header: magic, frozen flag, version, root-offset placeholder.
        self.buf = bytearray(b"Ogawa" + b"\xff" + struct.pack("<H", 1) + b"\x00" * 8)

    def data(self, payload: bytes) -> int:
        if not payload:
            return _DATA_BIT  # canonical empty-data reference
        off = len(self.buf)
        self.buf += struct.pack("<Q", len(payload)) + payload
        return off | _DATA_BIT

    def group(self, child_refs: Sequence[int]) -> int:
        if not child_refs:
            return 0  # canonical empty-group reference
        off = len(self.buf)
        self.buf += struct.pack("<Q", len(child_refs))
        self.buf += b"".join(struct.pack("<Q", r) for r in child_refs)
        return off

    def finish(self, root_ref: int) -> bytes:
        struct.pack_into("<Q", self.buf, 8, root_ref)
        return bytes(self.buf)


def _sample_blob(payload: bytes) -> bytes:
    """Stored samples are prefixed with a 16-byte content key; the reader only
    skips it, so zeros are a valid (never-deduplicated) key."""
    return b"\x00" * 16 + payload


def _array_property_group(w: _OgawaWriter, samples: List[np.ndarray]) -> int:
    """Array property: sample j at data child 2j (key + payload), dims at
    2j+1 (u64 element count)."""
    refs = []
    for arr in samples:
        refs.append(w.data(_sample_blob(arr.tobytes())))
        refs.append(w.data(struct.pack("<Q", arr.shape[0])))
    return w.group(refs)


def _property_header(
    name: str,
    *,
    ptype: int,
    pod: int = 0,
    extent: int = 1,
    num_samples: int = 0,
    metadata: str = "",
) -> bytes:
    """One entry of a compound's property-header blob (spec in abc_ogawa.hpp)."""
    info = ptype & 0x3
    info |= 2 << 2  # size hint: u32 index fields
    info |= (pod & 0xF) << 4
    info |= (extent & 0xFF) << 12
    info |= 0xFFF << 20  # metadata always inline
    out = struct.pack("<I", info)
    if ptype != 0:
        first_changed = 0
        last_changed = max(num_samples - 1, 0)
        out += struct.pack("<III", num_samples, first_changed, last_changed)
    name_b = name.encode()
    meta_b = metadata.encode()
    out += struct.pack("<I", len(name_b)) + name_b
    out += struct.pack("<I", len(meta_b)) + meta_b
    return out


def _object_header(name: str, metadata: str) -> bytes:
    name_b = name.encode()
    meta_b = metadata.encode()
    return struct.pack("<I", len(name_b)) + name_b + b"\xff" + struct.pack("<I", len(meta_b)) + meta_b


def write_polymesh_abc(
    path: Path | str,
    frames: Sequence[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    mesh_name: str = "mesh1",
    frames_per_second: float = 30.0,
) -> Path:
    """Write an animated PolyMesh archive.

    frames: per-frame (positions (N, 3) float32, face_counts (F,) int32,
    face_indices (sum(counts),) int32). Topology may vary per frame.
    """
    assert frames, "need at least one frame"
    w = _OgawaWriter()

    positions = [np.ascontiguousarray(p, dtype=np.float32).reshape(-1, 3).reshape(-1) for p, _, _ in frames]
    counts = [np.ascontiguousarray(c, dtype=np.int32).reshape(-1) for _, c, _ in frames]
    indices = [np.ascontiguousarray(i, dtype=np.int32).reshape(-1) for _, _, i in frames]
    n = len(frames)

    # .geom compound: P / .faceIndices / .faceCounts array properties.
    geom_children = [
        _array_property_group(w, positions),
        _array_property_group(w, indices),
        _array_property_group(w, counts),
    ]
    geom_headers = (
        _property_header("P", ptype=2, pod=POD_FLOAT32, extent=3, num_samples=n,
                         metadata="interpretation=point")
        + _property_header(".faceIndices", ptype=2, pod=POD_INT32, extent=1, num_samples=n)
        + _property_header(".faceCounts", ptype=2, pod=POD_INT32, extent=1, num_samples=n)
    )
    geom_group = w.group(geom_children + [w.data(geom_headers)])

    # Mesh object: top compound holds the .geom compound; no child objects.
    mesh_props = w.group([geom_group, w.data(_property_header(".geom", ptype=0))])
    mesh_object = w.group([mesh_props, w.data(b"")])

    # Top object "ABC": no properties, one child object.
    top_headers = _object_header(
        mesh_name, "schema=AbcGeom_PolyMesh_v1;schemaObjTitle=AbcGeom_PolyMesh_v1:.geom"
    )
    top_object = w.group([w.group([]), mesh_object, w.data(top_headers)])

    # Archive root: versions, top object, archive metadata, time samplings,
    # indexed metadata (none — all metadata is written inline).
    time_sampling = struct.pack("<IdId", n, 1.0 / frames_per_second, 1, 0.0)
    root = w.group(
        [
            w.data(struct.pack("<i", 1)),      # Ogawa file version
            w.data(struct.pack("<i", 10709)),  # archive (library) version
            top_object,
            w.data(b""),                       # archive metadata
            w.data(time_sampling),
            w.data(b""),                       # indexed metadata
        ]
    )

    path = Path(path)
    path.write_bytes(w.finish(root))
    return path


def objs_to_abc(obj_paths: Sequence[Path | str], out_path: Path | str, **kw) -> Path:
    """Bundle a per-frame OBJ sequence into one animated .abc (the inverse of
    the extractor, for round-tripping mesh sequences)."""
    frames = []
    for p in obj_paths:
        verts, faces = [], []
        for line in Path(p).read_text().splitlines():
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                verts.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                faces.append([int(tok.split("/")[0]) - 1 for tok in parts[1:]])
        counts = np.asarray([len(f) for f in faces], dtype=np.int32)
        # OBJ faces are counter-clockwise; Alembic winds clockwise.
        idx = np.concatenate([np.asarray(f[::-1], dtype=np.int32) for f in faces]) if faces else np.zeros(0, np.int32)
        frames.append((np.asarray(verts, dtype=np.float32), counts, idx))
    return write_polymesh_abc(out_path, frames, **kw)
