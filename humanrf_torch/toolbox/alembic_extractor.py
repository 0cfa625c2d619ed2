#!/usr/bin/env python3
"""Alembic (.abc) animated mesh → per-frame `Frame%06d.obj` files.

The port's counterpart of `humanrf_tpu/native/alembic_extractor` (its
`main.cpp` and the Ogawa/PolyMesh reader `abc_ogawa.hpp`), in Python with
`struct` and numpy; no Alembic SDK. The format subset and its layout are
documented at the top of `abc_ogawa.hpp`; this reader walks it the same
way: the Ogawa groups and data blobs, the object and compound-property
headers (size hints, inline or indexed metadata), the sample → stored-sample
mapping, array samples after their 16-byte key, and the first PolyMesh
(depth first) with its `P`, `.faceIndices` and `.faceCounts`.

Each frame with positions becomes one OBJ written as the native tool writes
it, byte for byte: `v x y z` with floats as C++'s default `ostream` writes
them (`%g`, 6 significant digits, `-0` kept), then `f` lines with each face
rewound (Alembic winds clockwise, OBJ counter-clockwise) and 1-based.

    python -m humanrf_torch.toolbox.alembic_extractor --alembic mesh.abc --output <dir>

Exit 1 with `error: ...` on a malformed archive, 2 on a usage error.
"""
from __future__ import annotations

import struct
import sys
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional

import numpy as np

from humanrf_torch.toolbox.mesh_io import obj_text

_DATA_BIT = 1 << 63


class _Archive:
    """The Ogawa container: the whole file, read-checked accesses."""

    def __init__(self, path: str):
        self.path = path
        try:
            self.buf = Path(path).read_bytes()
        except OSError:
            raise ValueError(f"cannot open {path}") from None
        if len(self.buf) < 16 or self.buf[:5] != b"Ogawa":
            raise ValueError(f"{path}: not an Ogawa archive")
        self.root = self.u64(8)

    def check(self, off: int, n: int) -> None:
        if off + n > len(self.buf):
            raise ValueError(f"{self.path}: truncated archive (read at {off}+{n})")

    def u64(self, off: int) -> int:
        self.check(off, 8)
        return struct.unpack_from("<Q", self.buf, off)[0]

    def num_children(self, ref: int) -> int:
        if ref & _DATA_BIT or ref == 0:
            return 0
        return self.u64(ref)

    def child(self, ref: int, i: int) -> int:
        if i >= self.num_children(ref):
            raise ValueError(f"{self.path}: child index out of range")
        return self.u64(ref + 8 + 8 * i)

    def data(self, ref: int) -> bytes:
        if not ref & _DATA_BIT:
            raise ValueError(f"{self.path}: not a data node")
        off = ref & ~_DATA_BIT
        if off == 0:
            return b""
        n = self.u64(off)
        self.check(off + 8, n)
        return self.buf[off + 8 : off + 8 + n]


def _is_data(ref: int) -> bool:
    return bool(ref & _DATA_BIT)


class _Cursor:
    def __init__(self, blob: bytes, path: str):
        self.blob, self.pos, self.path = blob, 0, path

    def done(self) -> bool:
        return self.pos >= len(self.blob)

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.blob):
            raise ValueError(f"{self.path}: truncated header blob")
        out = self.blob[self.pos : self.pos + n]
        self.pos += n
        return out

    def u8(self) -> int:
        return self.take(1)[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def hinted(self, hint: int) -> int:
        return self.u8() if hint == 0 else struct.unpack("<H", self.take(2))[0] if hint == 1 else self.u32()


def _metadata(cursor: _Cursor, index: int, indexed: List[bytes]) -> bytes:
    if index in (0xFF, 0xFFF):  # inline
        return cursor.take(cursor.u32())
    return indexed[index] if index < len(indexed) else b""


@dataclass
class _Property:
    name: bytes
    kind: int  # 0 compound, 1 scalar, 2 array
    child: int  # index of its subtree in the compound's group
    num_samples: int = 0
    first_changed: int = 0
    last_changed: int = 0

    def stored_index(self, i: int) -> int:
        """Sample → stored sample (constant runs are stored once)."""
        if self.first_changed == 0 and self.last_changed == 0 and self.num_samples > 1:
            return 0
        if i < self.first_changed:
            return 0
        if self.last_changed and i > self.last_changed:
            i = self.last_changed
        return i - self.first_changed + 1 if self.first_changed else i


def _compound(archive: _Archive, group: int, indexed: List[bytes]) -> List[_Property]:
    """A compound property group's headers (its last child's blob)."""
    n = archive.num_children(group)
    if n == 0:
        return []
    last = archive.child(group, n - 1)
    if not _is_data(last):
        return []
    cursor, props = _Cursor(archive.data(last), archive.path), []
    while not cursor.done():
        info = cursor.u32()
        prop = _Property(name=b"", kind=info & 0x3, child=len(props))
        hint = (info >> 2) & 0x3
        if prop.kind != 0:
            if info & 0x200:  # index fields omitted: one sample
                prop.num_samples = 1
            else:
                prop.num_samples, prop.first_changed, prop.last_changed = (cursor.hinted(hint) for _ in range(3))
            if info & 0x100:
                cursor.u32()  # time-sampling index
        prop.name = cursor.take(cursor.u32())
        _metadata(cursor, (info >> 20) & 0xFFF, indexed)
        props.append(prop)
    return props


@dataclass
class _Object:
    name: bytes
    metadata: bytes
    group: int
    properties: Optional[List[_Property]] = None
    children: List["_Object"] = field(default_factory=list)


def _object(archive: _Archive, group: int, name: bytes, metadata: bytes, indexed: List[bytes]) -> _Object:
    obj = _Object(name, metadata, group)
    n = archive.num_children(group)
    if n == 0:
        return obj
    if not _is_data(archive.child(group, 0)):
        obj.properties = _compound(archive, archive.child(group, 0), indexed)
    last = archive.child(group, n - 1)
    if n >= 2 and _is_data(last) and archive.data(last):
        cursor, child_group = _Cursor(archive.data(last), archive.path), 1
        while not cursor.done() and child_group <= n - 2:
            child_name = cursor.take(cursor.u32())
            child_meta = _metadata(cursor, cursor.u8(), indexed)
            obj.children.append(_object(archive, archive.child(group, child_group), child_name, child_meta, indexed))
            child_group += 1
    return obj


@dataclass
class PolyMesh:
    """The first PolyMesh of an archive: its `.geom` compound's group and
    the headers of its three arrays."""

    archive: _Archive
    name: str
    geom: int
    positions: _Property
    face_indices: _Property
    face_counts: _Property

    @property
    def num_samples(self) -> int:
        return self.positions.num_samples

    def _array(self, prop: _Property, i: int, dtype) -> np.ndarray:
        group = self.archive.child(self.geom, prop.child)
        want = 2 * prop.stored_index(i)  # data child 2s: key + payload; 2s+1: dims
        if want >= self.archive.num_children(group):
            raise ValueError(f"{self.archive.path}: sample {i} of '{prop.name.decode()}' out of range")
        raw = self.archive.data(self.archive.child(group, want))
        if len(raw) < 16:
            raise ValueError(f"{self.archive.path}: sample blob of '{prop.name.decode()}' too small for its hash key")
        payload = raw[16:]
        return np.frombuffer(payload[: len(payload) // 4 * 4], dtype=dtype)

    def positions_at(self, i: int) -> np.ndarray:
        return self._array(self.positions, i, "<f4")

    def face_counts_at(self, i: int) -> np.ndarray:
        return self._array(self.face_counts, i, "<i4")

    def face_indices_at(self, i: int) -> np.ndarray:
        return self._array(self.face_indices, i, "<i4")


def _find_poly_meshes(archive: _Archive, obj: _Object, out: List[PolyMesh]) -> None:
    schema_says_mesh = b"AbcGeom_PolyMesh" in obj.metadata
    for prop in obj.properties or ():
        if prop.kind != 0:
            continue
        geom = archive.child(archive.child(obj.group, 0), prop.child)
        sub = {p.name: p for p in reversed(_compound(archive, geom, []))}  # the first of a name wins
        trio = [sub.get(name) for name in (b"P", b".faceIndices", b".faceCounts")]
        if all(trio) and (schema_says_mesh or prop.name == b".geom"):
            out.append(PolyMesh(archive, obj.name.decode(errors="replace"), geom, *trio))
            break
    for child in obj.children:
        _find_poly_meshes(archive, child, out)


def read_poly_meshes(path) -> List[PolyMesh]:
    """Every PolyMesh of the archive at `path`, depth first."""
    archive = _Archive(str(path))
    root = archive.root
    if archive.num_children(root) < 3 or _is_data(archive.child(root, 2)):
        raise ValueError(f"{path}: missing top object group (root child 2)")
    indexed = []
    if archive.num_children(root) >= 6 and _is_data(archive.child(root, 5)):
        cursor = _Cursor(archive.data(archive.child(root, 5)), archive.path)
        while not cursor.done():
            indexed.append(cursor.take(cursor.u8()))
    meshes: List[PolyMesh] = []
    _find_poly_meshes(archive, _object(archive, archive.child(root, 2), b"ABC", b"", indexed), meshes)
    return meshes


def mesh_to_obj(positions: np.ndarray, counts: np.ndarray, indices: np.ndarray) -> str:
    """One frame's OBJ text, the native tool's bytes: each face rewound."""
    counts = counts.astype(np.int64)
    if (counts < 0).any() or int(counts.sum()) > len(indices):
        raise ValueError("face counts run past the face indices")
    offsets = np.cumsum(counts) - counts
    face = np.repeat(np.arange(len(counts)), counts)
    order = 2 * offsets[face] + counts[face] - 1 - np.arange(len(face))
    return obj_text(positions, counts, indices[order])


def convert_alembic_to_objs(abc_path, out_dir) -> int:
    """Extract every frame of the archive's first PolyMesh into `out_dir`
    → exit code (1 when there is no PolyMesh)."""
    meshes = read_poly_meshes(abc_path)
    if not meshes:
        print(f'no PolyMesh found in "{abc_path}"', file=sys.stderr)
        return 1
    mesh = meshes[0]
    print(f"Extracting {mesh.num_samples} frames from \"{abc_path}\" (mesh '{mesh.name}')", flush=True)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    for i in range(mesh.num_samples):
        positions = mesh.positions_at(i)
        if not len(positions):
            continue  # the reference writes no file for a frame without positions
        obj = mesh_to_obj(positions, mesh.face_counts_at(i), mesh.face_indices_at(i))
        (out_dir / f"Frame{i:06d}.obj").write_bytes(obj.encode())
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    alembic = output = None
    i = 0
    while i < len(argv):
        if argv[i] == "--alembic" and i + 1 < len(argv):
            alembic, i = argv[i + 1], i + 2
        elif argv[i] == "--output" and i + 1 < len(argv):
            output, i = argv[i + 1], i + 2
        else:
            print(f"unknown argument: {argv[i]}", file=sys.stderr)
            return 2
    if not alembic or not output:
        print("usage: alembic_extractor --alembic mesh.abc --output <dir>", file=sys.stderr)
        return 2
    try:
        return convert_alembic_to_objs(alembic, output)
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
