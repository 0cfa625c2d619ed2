"""The port's mesh tools against the JAX package's native ones.

`humanrf_torch.toolbox.mesh_renderer` (rasterizing with `--device cpu`
through `ops/rasterize.py::rasterize_plain`) against
`humanrf_tpu/native/mesh_renderer/main.cpp`: decoded masks and PFM bytes
equal, on the port's synthetic scene (6 cameras of 96×80, one of them
portrait). `humanrf_torch.toolbox.alembic_extractor` against
`humanrf_tpu/native/alembic_extractor`: OBJ files byte-equal, on archives
from the port's writer (`toolbox/write_alembic.py`). Both native tools are
built with g++ as the JAX package's tests build them; without g++ these
tests skip. The `cuda`-marked tests run on the card only: the kernels
against their plain version, and the native renderer's time per view at
the r4 scene's full size (the context for the kernels' times).
"""
import dataclasses
import os
import shutil
import subprocess
import sys
import time
from decimal import Decimal, localcontext
from pathlib import Path

import numpy as np
import pytest
import torch

from humanrf_torch.core import image_io
from humanrf_torch.core.camera import write_calibration_csv
from humanrf_torch.core.synthetic import generate_synthetic_dataset, make_cameras, subject_mesh
from humanrf_torch.ops import rasterize as raster
from humanrf_torch.r4 import R4_SCENE
from humanrf_torch.toolbox import alembic_extractor, mesh_io, mesh_renderer
from humanrf_torch.toolbox.write_alembic import objs_to_abc, write_polymesh_abc

REPO = Path(__file__).resolve().parent.parent
NATIVE = REPO / "humanrf_tpu" / "native"
# The r4 subject (sphere and 12 rods) at the test's size; camera 3 portrait.
SCENE = dataclasses.replace(R4_SCENE, num_cameras=6, width=96, height=80, num_frames=2, grid_resolution=32,
                            portrait_camera_indices=(2,))
MASK_IOU_MIN = 0.93  # tests/test_mesh_renderer.py's bar

torch.set_num_threads(2)


def _build(tmp_path_factory, name: str, source: Path, prelude: str = "") -> Path:
    if shutil.which("g++") is None:
        pytest.skip("g++ not available")
    out = tmp_path_factory.mktemp("bin") / name
    if prelude:
        harness = out.with_suffix(".cpp")
        harness.write_text(prelude.replace("SOURCE", str(source)))
        source = harness
    subprocess.run(["g++", "-O2", "-std=c++17", "-o", str(out), str(source), "-lpthread"], check=True)
    return out


@pytest.fixture(scope="module")
def native_renderer(tmp_path_factory):
    return _build(tmp_path_factory, "mesh_renderer", NATIVE / "mesh_renderer" / "main.cpp")


@pytest.fixture(scope="module")
def native_extractor(tmp_path_factory):
    return _build(tmp_path_factory, "alembic_extractor", NATIVE / "alembic_extractor" / "main.cpp")


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The port's synthetic scene: calibration, analytic masks, and the
    subject of both frames as OBJ files."""
    root = tmp_path_factory.mktemp("mesh_scene")
    data_dir = generate_synthetic_dataset(root, SCENE)
    objs = []
    for frame in range(SCENE.num_frames):
        objs.append(root / f"Frame{frame:06d}.obj")
        mesh_io.write_obj(objs[-1], *subject_mesh(SCENE, frame))
    return data_dir, objs


def _outputs(out: Path) -> dict:
    """Every file the renderer wrote: decoded mask pixels, PFM bytes."""
    files = {}
    for path in sorted(out.rglob("*")):
        if path.suffix == ".png":
            files[path.relative_to(out)] = image_io.decode_png(path.read_bytes()).tobytes()
        elif path.suffix == ".pfm":
            files[path.relative_to(out)] = path.read_bytes()
    return files


def _render_both(native_renderer, tmp_path, args) -> tuple:
    """The native tool and the port's CLI (`--device cpu`) on the same
    arguments → (native files, port files)."""
    res = subprocess.run([str(native_renderer), *args, "--output", str(tmp_path / "native")],
                         capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    assert mesh_renderer.main([*args, "--output", str(tmp_path / "port"), "--device", "cpu"]) == 0
    return _outputs(tmp_path / "native"), _outputs(tmp_path / "port")


def _write_uv_sphere(path: Path, center, radius):
    """tests/test_mesh_renderer.py's UV sphere, float64 coordinates in full."""
    n_lat, n_lon = 24, 48
    theta = np.pi * np.arange(n_lat + 1) / n_lat
    phi = 2 * np.pi * np.arange(n_lon) / n_lon
    verts = np.stack([center[0] + radius * np.outer(np.sin(theta), np.cos(phi)),
                      center[1] + radius * np.outer(np.sin(theta), np.sin(phi)),
                      center[2] + radius * np.outer(np.cos(theta), np.ones(n_lon))], -1).reshape(-1, 3)
    lines = [f"v {x} {y} {z}" for x, y, z in verts.tolist()]
    for i in range(n_lat):
        for j in range(n_lon):
            a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
            c, d = a + n_lon, b + n_lon
            lines += [f"f {a + 1} {c + 1} {b + 1}", f"f {b + 1} {c + 1} {d + 1}"]
    path.write_text("\n".join(lines) + "\n")


# An OBJ of the syntax the tool takes: texture and normal tokens, a quad, a
# pentagon, negative (relative) indices, comments and vt/vn lines, CRLF.
OBJ_SYNTAX = """# quads and polygons
v -0.4 -0.3 0.1
v 0.4 -0.3 0.1
v 0.4 0.3 0.1
v -0.4 0.3 0.1
vt 0 0
vn 0 0 1
f 1/1/1 2/1/1 3/1/1 4/1/1
v 0.0 -0.2 -0.3\r
v 0.3 0.0 -0.3
v 0.1 0.3 -0.3
v -0.2 0.25 -0.3
v -0.3 -0.05 -0.3
f -5//1 -4//1 -3//1 -2//1 -1//1
v 0.5 0.5 0.5
f 9/1 -1 3
f\t1 2 3
"""


def _clipping_case(tmp_path: Path) -> list:
    """A camera at the origin looking down +z (beside two scene cameras),
    and triangles that it draws, clips, skips or draws in part: across the
    near plane, behind it, off-screen, degenerate, a vertex whose x/z
    overflows int32 (the tool's box then converts to INT_MIN and skips it),
    a NaN vertex, and ones larger than the image."""
    cams = make_cameras(SCENE)[:2]
    csv = tmp_path / "calibration.csv"
    write_calibration_csv(cams, csv)
    with open(csv, "a") as f:
        f.write("CamZ,96,80,0,0,0,0,0,0,1.2,1.44,0.5,0.5\n")
    tris = [
        [(-0.2, -0.2, 2), (0.2, -0.2, 2), (0, 0.2, 2)],            # drawn
        [(-0.5, 0, -1), (0.5, 0, 1), (0, 0.5, 1)],                 # across the near plane
        [(-0.5, 0, -1), (0.5, 0, -1), (0, 0.5, -2)],               # behind
        [(0, 0, 1e-7), (0.1, 0, 1), (0, 0.1, 1)],                  # a vertex inside the near clip
        [(100, 100, 2), (101, 100, 2), (100, 101, 2)],             # off-screen
        [(0, 0, 3), (0.1, 0.1, 3), (0.2, 0.2, 3)],                 # collinear
        [(0.1, 0.1, 3), (0.1, 0.1, 3), (0.3, 0.1, 3)],             # a repeated vertex
        [(30, 0, 1.1e-6), (0.1, 0, 2), (0, 0.1, 2)],               # px beyond int32
        [(-30, 0, 1.1e-6), (0.1, 0, 2), (0, -0.1, 2)],             # px below int32
        [(float("nan"), 0, 2), (0.1, 0, 2), (0, 0.1, 2)],          # NaN
        [(-1, -1, 2.5), (3, -1, 2.5), (-1, 3, 2.5)],               # clamped to the image
        [(-10, -10, 5), (10, -10, 5), (0, 10, 5)],                 # fills the image, behind the rest
        [(0.05, 0.05, 1.5), (0.3, 0.05, 2.5), (0.05, 0.3, 2.5)],   # slanted, in front of the first
    ]
    obj = tmp_path / "clip.obj"
    lines = [f"v {x!r} {y!r} {z!r}" for tri in tris for x, y, z in tri]
    lines += [f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}" for i in range(len(tris))]
    obj.write_text("\n".join(lines) + "\n")
    return ["--objs", str(obj), "--csv", str(csv), "--mask", "--depth"]


# Two cameras at the origin looking down +z, landscape 96×80 and portrait
# 80×96, both with fx·W = fy·H = 115.2: a point (x, y, 2) lands at pixel
# (57.6·x + 48, 57.6·y + 40) in the first.
TWO_SHAPES_CSV = ("name,w,h,rx,ry,rz,tx,ty,tz,fx,fy,px,py\n"
                  "CamL,96,80,0,0,0,0,0,0,1.2,1.44,0.5,0.5\n"
                  "CamP,80,96,0,0,0,0,0,0,1.44,1.2,0.5,0.5\n")


def _pixel_triangles(tmp_path: Path, name: str, tris) -> list:
    """Triangles given by their corners' pixels in CamL at depth z → the
    renderer's arguments for both cameras of TWO_SHAPES_CSV."""
    csv = tmp_path / "two_shapes.csv"
    csv.write_text(TWO_SHAPES_CSV)
    lines = []
    for corners, z in tris:
        lines += [f"v {(px - 48) / 57.6 * z / 2!r} {(py - 40) / 57.6 * z / 2!r} {float(z)!r}" for px, py in corners]
    lines += [f"f {3 * i + 1} {3 * i + 2} {3 * i + 3}" for i in range(len(tris))]
    obj = tmp_path / f"{name}.obj"
    obj.write_text("\n".join(lines) + "\n")
    return ["--objs", str(obj), "--csv", str(csv), "--mask", "--depth"]


def _case_args(case: str, scene, tmp_path: Path) -> list:
    data_dir, objs = scene
    csv = str(data_dir / "calibration.csv")
    if case == "threshold_boxes":
        # In CamL a box of exactly SMALL_BOX (16 × 16) pixels, walked by one
        # thread, and one a pixel wider (17 × 16), walked by a warp.
        assert raster.SMALL_BOX == 16 * 16
        return _pixel_triangles(tmp_path, case, [(((10.3, 10.3), (24.7, 10.3), (10.3, 24.7)), 2),
                                                 (((30.3, 10.3), (45.7, 24.7), (30.3, 24.7)), 2)])
    if case == "whole_image":
        # One triangle over every pixel of both images, a smaller one in front.
        return _pixel_triangles(tmp_path, case, [(((-900, -900), (1500, -900), (-900, 1500)), 5),
                                                 (((20.5, 20.5), (70.2, 30.1), (35.3, 60.8)), 2)])
    if case == "two_shapes":
        obj = tmp_path / "sphere.obj"
        _write_uv_sphere(obj, (0.0, 0.0, 2.0), 0.5)
        (tmp_path / "two_shapes.csv").write_text(TWO_SHAPES_CSV)
        return ["--objs", str(obj), "--csv", str(tmp_path / "two_shapes.csv"), "--mask", "--depth"]
    if case == "tile_edges":
        # Boxes across the tile edges at x = 64 and y = 64, and a thin
        # triangle whose box spans all four tiles (row ranges).
        assert raster.TILE == 64
        return _pixel_triangles(tmp_path, case, [(((55.3, 58.3), (75.7, 61.2), (60.1, 70.6)), 2),
                                                 (((63.5, 20.2), (64.5, 20.2), (64.0, 79.5)), 3),
                                                 (((2.3, 75.2), (93.1, 3.7), (93.9, 4.6)), 2.5)])
    if case == "uv_sphere":
        obj = tmp_path / "sphere.obj"
        _write_uv_sphere(obj, SCENE.center_start, SCENE.sphere_radius)
        return ["--objs", str(obj), "--csv", csv, "--mask", "--depth"]
    if case == "subject":
        return ["--objs", *map(str, objs), "--csv", csv, "--mask", "--depth", "--headless"]
    if case == "obj_syntax":
        obj = tmp_path / "syntax.obj"
        obj.write_bytes(OBJ_SYNTAX.replace("\n", "\r\n").encode())
        return ["--objs", str(obj), "--csv", csv, "--depth", "--mask"]
    if case == "clipping":
        return _clipping_case(tmp_path)
    if case == "subsets":
        sphere = tmp_path / "sphere.obj"  # positions follow the sorted paths, not the argument order
        _write_uv_sphere(sphere, (0.1, 0.0, 0.05), 0.25)
        return ["--objs", *map(str, objs[::-1]), str(sphere), "--csv", csv, "--mask", "--scale", "1.1",
                "--cameras", "Cam005", "Cam002", "--frames", "0", "2"]
    raise ValueError(case)


RENDER_CASES = ["uv_sphere", "subject", "obj_syntax", "clipping", "subsets", "threshold_boxes", "whole_image",
                "two_shapes", "tile_edges"]


@pytest.mark.parametrize("case", RENDER_CASES)
def test_renderer_writes_the_native_tools_masks_and_depths(case, native_renderer, scene, tmp_path):
    native, port = _render_both(native_renderer, tmp_path, _case_args(case, scene, tmp_path))
    assert native and port.keys() == native.keys()
    differ = [name for name in native if port[name] != native[name]]
    assert not differ, differ
    masks = [name for name in native if name.suffix == ".png"]
    assert any(np.frombuffer(native[name], np.uint8).any() for name in masks)
    if case == "subsets":
        assert sorted(map(str, native)) == [f"masks/{cam}/{cam}_mask{frame:06d}.png"
                                            for cam in ("Cam002", "Cam005") for frame in (0, 2)]
    if case == "whole_image":
        assert all(np.frombuffer(native[name], np.uint8).all() for name in masks)


def test_renderer_masks_match_the_analytic_masks(scene, tmp_path):
    data_dir, objs = scene
    assert mesh_renderer.main(["--objs", *map(str, objs), "--csv", str(data_dir / "calibration.csv"),
                               "--output", str(tmp_path), "--mask", "--device", "cpu"]) == 0
    for cam in make_cameras(SCENE):
        for frame in range(SCENE.num_frames):
            name = f"{cam.name}/{cam.name}_mask{frame:06d}.png"
            got = image_io.decode_png((tmp_path / "masks" / name).read_bytes())[..., 0] > 0
            truth = image_io.decode_png((data_dir / "masks" / name).read_bytes())[..., 0] > 0
            assert got.shape == (cam.height, cam.width)
            iou = (got & truth).sum() / max((got | truth).sum(), 1)
            assert iou >= MASK_IOU_MIN, f"{name}: IoU {iou:.4f}"


def test_renderer_cli_runs_as_a_module(native_renderer, scene, tmp_path):
    """`python -m humanrf_torch.toolbox.mesh_renderer ... --device cpu`."""
    args = _case_args("uv_sphere", scene, tmp_path)
    res = subprocess.run([sys.executable, "-m", "humanrf_torch.toolbox.mesh_renderer", *args, "--output",
                          str(tmp_path / "port"), "--device", "cpu"], cwd=REPO, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr
    assert res.stdout == f"Rendering animation at frame: 0 ({2 * 24 * 48} tris)\n"
    subprocess.run([str(native_renderer), *args, "--output", str(tmp_path / "native")], check=True,
                   capture_output=True)
    assert _outputs(tmp_path / "port") == _outputs(tmp_path / "native")


@pytest.mark.parametrize("args, message", [
    (["--nope"], "unknown argument: --nope"),
    ([], "usage"),
    (["--objs", "a.obj", "--csv", "c.csv"], "usage"),
    (["--objs", "a.obj", "--csv", "c.csv", "--output", "o"], "nothing to do"),
    (["--alembic", "mesh.abc", "--csv", "c.csv", "--output", "o", "--mask"], "extract to OBJs first"),
], ids=["unknown", "empty", "no-output", "no-mask-or-depth", "alembic"])
def test_renderer_bad_arguments(args, message, native_renderer, capsys):
    native = subprocess.run([str(native_renderer), *args], capture_output=True, text=True)
    assert native.returncode == 2 and message in native.stderr
    assert mesh_renderer.main(args) == 2
    assert message in capsys.readouterr().err


def test_rasterize_checks_its_inputs_and_never_falls_back():
    v, f = torch.zeros((3, 3)), torch.tensor([[0, 1, 2]], dtype=torch.int32)
    with pytest.raises(ValueError, match="outside"):
        raster.rasterize(v, f + 1, [])
    with pytest.raises(TypeError):
        raster.rasterize(v.double(), f, [])
    with pytest.raises(ValueError, match="cuda or cpu"):
        raster.rasterize(v.to("meta"), f.to("meta"), [])
    with pytest.raises(ValueError, match="outside"):
        raster.rasterize(v, f - 1, [])


def test_camera_params_lay_out_pixels_and_tiles(tmp_path):
    """Two shapes in one call: each image's pixel offset, its 64-pixel tiles
    across and down (the last ones partial) and its first tile."""
    (tmp_path / "c.csv").write_text(TWO_SHAPES_CSV + "CamS,130,64,0,0,0,0,0,0,1,1,0.5,0.5\n")
    params = raster.CameraParams.build(mesh_io.read_calibration_f32(tmp_path / "c.csv"), "cpu")
    assert params.ints.tolist() == [[96, 80, 0, 2, 2, 0], [80, 96, 7680, 2, 2, 4], [130, 64, 15360, 3, 1, 8]]
    assert (params.total, params.tiles, params.max_tiles) == (15360 + 130 * 64, 11, 4)
    assert params.sizes == [(80, 96), (96, 80), (64, 130)]


@pytest.mark.parametrize("case", ["subject", "tile_edges"])
def test_bin_plain_lists_each_drawn_triangle_in_the_tiles_of_its_box(case, scene, tmp_path):
    """`bin_plain` (the tile lists the kernel is held to) against a loop over
    the faces: a face is listed in a tile exactly when the tool draws it in
    that camera and its box touches the tile; and every fragment of the
    plain depth pass lies in a tile that lists its face."""
    args = _case_args(case, scene, tmp_path)
    cameras = mesh_io.read_calibration_f32(args[args.index("--csv") + 1])
    vertices, faces = (torch.from_numpy(a) for a in mesh_io.load_obj(args[1]))
    params = raster.CameraParams.build(cameras, "cpu")
    proj = raster.project_plain(vertices, params, 1.0)
    bins = raster.bin_plain(proj, faces, params)
    offsets, entries = bins.offsets, bins.entries
    setup = raster.setup_plain(proj, faces, params)
    expected = [[] for _ in range(params.tiles)]
    for c, (_, across, _, base) in enumerate(params.ints[:, 2:].tolist()):
        for f in torch.nonzero(setup["valid"][c]).flatten().tolist():
            box = [int(setup[k][c, f]) >> raster.TILE_LOG2 for k in ("minx", "maxx", "miny", "maxy")]
            for ty in range(box[2], box[3] + 1):
                for tx in range(box[0], box[1] + 1):
                    expected[base + ty * across + tx].append(f)
    got = [entries[offsets[t]:offsets[t + 1]].tolist() for t in range(params.tiles)]
    assert got == expected and sum(map(len, got)) > 0
    crowded = [len(faces_t) > raster.CHUNK for faces_t in got]
    assert bins.slots.tolist() == [sum(crowded[:t]) for t in range(params.tiles)]
    assert (bins.crowded, bins.most) == (sum(crowded), max(map(len, got)))
    listed = {(t, f) for t, faces_t in enumerate(got) for f in faces_t}
    for c, cam in enumerate(cameras):
        buf, _ = raster.depth_buffer_plain(proj[c:c + 1], faces, raster.CameraParams.build([cam], "cpu"))
        drawn = torch.nonzero(torch.isfinite(buf)).flatten()
        assert drawn.numel() > 0
        y, x = drawn // cam.width, drawn % cam.width
        tiles = params.ints[c, 5] + (y >> raster.TILE_LOG2) * params.ints[c, 3] + (x >> raster.TILE_LOG2)
        assert all(any((t, f) in listed for f in range(faces.shape[0])) for t in set(tiles.tolist()))


# A mirror of the kernel's row ranges (mesh_raster.cu: row_ranges,
# band_extent, row_range) in float32 numpy, to hold the rule that lets a
# warp skip pixels: every pixel the exact float32 test accepts lies within
# its row's range.


def _row_ranges(x, y):
    f = np.float32
    x, y = x.astype(f), y.astype(f)
    S = max(x.max() - x.min(), y.max() - y.min()) + f(2)
    R = np.abs(np.concatenate([x, y])).max()
    area = abs((x[1] - x[0]) * (y[2] - y[0]) - (x[2] - x[0]) * (y[1] - y[0]))
    length = min(np.hypot(x[(i + 1) % 3] - x[i], y[(i + 1) % 3] - y[i]) for i in range(3))
    on = bool(S < 2.0**22 and area >= S * S * f(2.0**-12))
    return x, y, (f(1) + S * S * f(2.0**-16) / length * f(1.001) + R * f(2.0**-16) if on else None)


def _row_range(x, y, m, lo, hi, x0, x1):
    f = np.float32
    xs = []
    for i in range(3):
        if f(lo) + f(0.5) - m <= y[i] <= f(hi) + f(0.5) + m:
            xs.append(x[i])
        j = (i + 1) % 3
        for yb in (f(lo) + f(0.5) - m, f(hi) + f(0.5) + m):
            if y[i] != y[j] and (yb - y[i]) * (yb - y[j]) <= 0:
                xs.append(x[i] + (yb - y[i]) * ((x[j] - x[i]) / (y[j] - y[i])))
    if not xs:
        return None
    start = max(int(np.ceil(min(xs) - m - f(0.5))), x0)
    stop = min(int(np.floor(max(xs) + m - f(0.5))), x1)
    return (start, stop) if start <= stop else None


def _drawn_pixels(corners, width, height):
    """The tool's test over a triangle's whole box in float32 → (x, y) of
    every accepted pixel, and the box."""
    (ax, ay), (bx, by), (dx, dy) = corners.astype(np.float32)
    minx, maxx = max(0, int(np.floor(min(ax, bx, dx)))), min(width - 1, int(np.ceil(max(ax, bx, dx))))
    miny, maxy = max(0, int(np.floor(min(ay, by, dy)))), min(height - 1, int(np.ceil(max(ay, by, dy))))
    with np.errstate(all="ignore"):
        area = (bx - ax) * (dy - ay) - (dx - ax) * (by - ay)
        inv = np.float32(1) / area
        yy, xx = np.mgrid[miny:maxy + 1, minx:maxx + 1]
        pxc, pyc = xx.astype(np.float32) + np.float32(0.5), yy.astype(np.float32) + np.float32(0.5)
        w0 = ((bx - pxc) * (dy - pyc) - (dx - pxc) * (by - pyc)) * inv
        w1 = ((dx - pxc) * (ay - pyc) - (ax - pxc) * (dy - pyc)) * inv
        w2 = (np.float32(1) - w0) - w1
    keep = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
    return xx[keep], yy[keep], (minx, maxx, miny, maxy)


def _thin_triangles(rng, count, width, height):
    """Slivers and thin wedges of 50–900 pixels, 0.02–6 pixels wide, at any
    angle and sub-pixel position; wedges whose far corner lies 5,000–40,000
    pixels off the image (where float32 rounding is coarsest); a few fat
    triangles."""
    out = []
    for i in range(count):
        start = rng.uniform((0, 0), (width, height))
        angle, length, wide = rng.uniform(0, 2 * np.pi), rng.uniform(50, 900), rng.uniform(0.02, 6)
        along, across = np.array([np.cos(angle), np.sin(angle)]), np.array([-np.sin(angle), np.cos(angle)])
        end = start + length * along
        if i % 8 == 7:  # fat
            out.append(np.stack([start, end, start + rng.uniform(0.3, 1) * length * across]))
        elif i % 4 == 3:  # far
            wide = rng.uniform(2, 40)
            out.append(np.stack([start + rng.uniform(5000, 40000) * along, start + 0.5 * wide * across,
                                 start - 0.5 * wide * across]))
        elif i % 2:  # a wedge: one far corner, a short edge
            out.append(np.stack([start, end + 0.5 * wide * across, end - 0.5 * wide * across]))
        else:  # a strip's half
            out.append(np.stack([start, end, start + wide * across + rng.uniform(-1, 1) * along]))
    return out


def _subject_thin_triangles(cfg, count, tmp_path):
    """The r4 subject's triangles with boxes above SMALL_BOX in two cameras
    of `cfg` (its rods' sides), in pixels."""
    cams = make_cameras(cfg)
    write_calibration_csv([cams[0], cams[len(cams) // 2]], tmp_path / "rig.csv")
    params = raster.CameraParams.build(mesh_io.read_calibration_f32(tmp_path / "rig.csv"), "cpu")
    vertices, faces = subject_mesh(cfg, 0)
    out = []
    for proj in raster.project_plain(torch.from_numpy(vertices), params, 1.0):
        corners = proj[torch.from_numpy(faces).long()][..., :2]
        box = (corners.amax(1) - corners.amin(1) + 2).prod(-1)
        big = torch.nonzero(box > raster.SMALL_BOX).flatten()
        out += [corners[i].numpy() for i in big[torch.randperm(len(big), generator=torch.Generator().manual_seed(0))
                                               [:count]]]
    return out


@pytest.mark.parametrize("case", ["random", "subject_748", "subject_12mp"])
def test_row_ranges_hold_every_pixel_the_exact_test_draws(case, tmp_path):
    if case == "random":
        width, height = 1024, 768
        tris = _thin_triangles(np.random.default_rng(3), 128, width, height)
    else:
        size = {"subject_748": (748, 748), "subject_12mp": (4112, 3008)}[case]
        cfg = dataclasses.replace(R4_SCENE, num_cameras=8, width=size[0], height=size[1])
        width, height = size
        tris = _subject_thin_triangles(cfg, 24, tmp_path)
    on = pruned = 0
    for corners in tris:
        xs, ys, (minx, maxx, miny, maxy) = _drawn_pixels(np.asarray(corners, np.float32), width, height)
        if minx > maxx or miny > maxy:
            continue
        x, y, m = _row_ranges(*np.asarray(corners, np.float32).T)
        if m is None:
            continue
        on += 1
        kept = 0
        for row in range(miny, maxy + 1):
            span = _row_range(x, y, m, row, row, minx, maxx)
            drawn = xs[ys == row]
            if span is None:
                assert drawn.size == 0, (corners, row)
                continue
            kept += span[1] - span[0] + 1
            assert drawn.size == 0 or (span[0] <= drawn.min() and drawn.max() <= span[1]), (corners, row, span)
        pruned += kept < (maxx - minx + 1) * (maxy - miny + 1) / 4
    assert on >= len(tris) // 2 and pruned >= on // 2, (on, pruned, len(tris))


# --------------------------------------------------------------- host math


@pytest.fixture(scope="module")
def native_rotation(tmp_path_factory):
    """The native tool's own `rotation_from_axisangle`, compiled into a
    harness that prints each matrix in hex."""
    return _build(tmp_path_factory, "rotation", NATIVE / "mesh_renderer" / "main.cpp", prelude="""
#define main mesh_renderer_main
#include "SOURCE"
#undef main
int main(int argc, char** argv) {
    for (int i = 1; i + 2 < argc; i += 3) {
        Mat3 r = rotation_from_axisangle(std::stof(argv[i]), std::stof(argv[i + 1]), std::stof(argv[i + 2]));
        for (float m : r.m) std::printf("%a ", m);
        std::printf("\\n");
    }
}
""")


def test_rotation_is_the_native_tools_float32_rodrigues(native_rotation, scene):
    """Every camera of the scene and of the r4 and 160-camera rigs, and random
    axis-angles: the port's matrix (float32, libm's cosf/sinf) equals the
    native tool's bit for bit."""
    data_dir, _ = scene
    rows = [line.split(",")[3:6] for line in (data_dir / "calibration.csv").read_text().splitlines()[1:]]
    for cfg in (R4_SCENE, dataclasses.replace(R4_SCENE, num_cameras=160)):
        rows += [[repr(float(v)) for v in cam.rotation_axisangle] for cam in make_cameras(cfg)]
    rng = np.random.default_rng(0)
    rows += [[repr(float(v)) for v in row] for row in rng.uniform(-4, 4, (200, 3)).astype(np.float32)]
    rows.append(["0", "0", "0"])
    out = subprocess.run([str(native_rotation), *(v for row in rows for v in row)], capture_output=True, text=True,
                         check=True).stdout.splitlines()
    assert len(out) == len(rows)
    for row, line in zip(rows, out):
        native = np.array([float.fromhex(v) for v in line.split()], dtype=np.float32).reshape(3, 3)
        port = mesh_io.rotation_from_axisangle_f32(*(mesh_io.strtof(v.encode()) for v in row))
        assert port.dtype == np.float32 and port.tobytes() == native.tobytes(), row


def _halfway_literals(count: int) -> list:
    """Decimal literals just above and below exact midpoints between two
    float32: float64 rounds each to the midpoint itself, so parsing through
    float64 and rounding again can land on the wrong side."""
    rng = np.random.default_rng(1)
    lows = rng.uniform(-100, 100, count).astype(np.float32)
    out = []
    with localcontext(prec=80):
        for low in lows:
            high = np.nextafter(low, np.float32(np.inf) if low > 0 else np.float32(-np.inf))
            mid = (Decimal(float(low)) + Decimal(float(high))) / 2
            out += [format(mid + Decimal("1e-40"), "f"), format(mid - Decimal("1e-40"), "f")]
    return out


def test_float_parsing_rounds_once_as_strtof():
    literals = _halfway_literals(50) + ["0.1", "-0", "1e-45", "1.5e-40", "3.4028235e38", "3.40282357e38",
                                        "-inf", "123456789", "0.30000001192092896"]
    tokens = np.array([s.encode() for s in literals])
    parsed = mesh_io.parse_f32(tokens)
    expected = np.array([mesh_io.strtof(s.encode()) for s in literals], dtype=np.float32)
    assert parsed.tobytes() == expected.tobytes()
    # The literals are hard: rounding twice gets some of them wrong.
    with np.errstate(over="ignore"):
        assert (tokens.astype(np.float64).astype(np.float32) != expected).any()


def test_load_obj_reads_the_same_mesh_as_the_native_tool(tmp_path):
    """The syntax OBJ's faces, fan-triangulated, with relative indices."""
    obj = tmp_path / "syntax.obj"
    obj.write_text(OBJ_SYNTAX)
    vertices, faces = mesh_io.load_obj(obj)
    assert vertices.shape == (10, 3) and vertices.dtype == np.float32
    np.testing.assert_array_equal(vertices[4], np.float32([0.0, -0.2, -0.3]))
    # The last line is no face: "f" and a tab (the tool wants "f ").
    assert faces.tolist() == [[0, 1, 2], [0, 2, 3], [4, 5, 6], [4, 6, 7], [4, 7, 8], [8, 9, 2]]


def test_pfm_round_trip(tmp_path):
    depth = np.random.default_rng(2).uniform(0, 5, (7, 11)).astype(np.float32)
    mesh_io.write_pfm(tmp_path / "d.pfm", depth)
    data = (tmp_path / "d.pfm").read_bytes()
    assert data.startswith(b"Pf\n11 7\n-1.0\n") and data[-44:] == depth[0].tobytes()
    np.testing.assert_array_equal(mesh_io.read_pfm(tmp_path / "d.pfm"), depth)


# --------------------------------------------------------------- extractor


def _tetra(offset):
    verts = np.asarray([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=np.float32) + np.float32(offset)
    return verts, np.full(4, 3, np.int32), np.asarray([0, 2, 1, 0, 1, 3, 0, 3, 2, 1, 2, 3], dtype=np.int32)


def _archive(case: str, scene, tmp_path: Path) -> Path:
    abc = tmp_path / f"{case}.abc"
    if case == "tetra_sequence":
        return write_polymesh_abc(abc, [_tetra((0.0, 0.0, 0.1 * i)) for i in range(3)], mesh_name="person")
    if case == "varying_topology":
        quad = (np.float32([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]]), np.int32([4]), np.int32([0, 3, 2, 1]))
        return write_polymesh_abc(abc, [_tetra((0, 0, 0)), quad])
    if case == "empty_frame":
        empty = (np.zeros((0, 3), np.float32), np.zeros(0, np.int32), np.zeros(0, np.int32))
        return write_polymesh_abc(abc, [_tetra((0, 0, 0)), empty, _tetra((0.5, 0, 0))])
    if case == "number_formats":
        verts = np.float32([[-0.0, 1e-7, 1e10], [123456.7, -2.5e-5, 3.4028235e38], [0.1, 100000, 1e6],
                            [np.inf, -np.inf, 7], [np.nan, -np.nan, 0.5]])
        return write_polymesh_abc(abc, [(verts, np.int32([4, 3]), np.int32([0, 1, 2, 3, 3, 2, 1]))])
    if case == "objs_to_abc":
        return objs_to_abc(scene[1], abc, mesh_name="subject")
    raise ValueError(case)


@pytest.mark.parametrize("case", ["tetra_sequence", "varying_topology", "empty_frame", "number_formats",
                                  "objs_to_abc"])
def test_extractor_writes_the_native_tools_obj_files(case, native_extractor, scene, tmp_path):
    abc = _archive(case, scene, tmp_path)
    native = subprocess.run([str(native_extractor), "--alembic", str(abc), "--output", str(tmp_path / "native")],
                            capture_output=True, text=True)
    port = subprocess.run([sys.executable, "-m", "humanrf_torch.toolbox.alembic_extractor", "--alembic", str(abc),
                           "--output", str(tmp_path / "port")], cwd=REPO, capture_output=True, text=True)
    assert native.returncode == port.returncode == 0, (native.stderr, port.stderr)
    assert port.stdout == native.stdout
    names = sorted(p.name for p in (tmp_path / "native").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    if case == "empty_frame":
        assert names == ["Frame000000.obj", "Frame000002.obj"]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "native" / name).read_bytes(), name


# OBJ text that the writers' line parser (str.splitlines, str.split, float,
# int) reads: leading blanks, tabs and form feeds, CR, unit separators,
# slashes, signs, underscores, inf and nan, vt/vn lines, a bare "f", a
# vertical tab splitting a line, and faces of 1 to 5 corners.
WRITER_OBJS = {
    "syntax": ("# c\n  v\t1.5  -2e-3 3_0 extra\r\nvt 0 0\nvn 0 0 1\nv +.5 1. -0\n\x0cv 1 1 1\x1f\n"
               "f 1/1/1 2//2 3/3 \t\nf -1 -2 -3 1_0\nf\nf 3 2 1\x0b f 1 2 3\nv inf nan 7\ng x\nf 4 3 2 1 5\nf 2\n"),
}


@pytest.mark.parametrize("case", sorted(WRITER_OBJS))
def test_objs_to_abc_reads_obj_text_as_the_jax_writer(case, tmp_path):
    from humanrf_tpu.toolbox.write_alembic import objs_to_abc as jax_objs_to_abc

    obj = tmp_path / "frame.obj"
    obj.write_bytes(WRITER_OBJS[case].encode())
    jax = jax_objs_to_abc([obj], tmp_path / "jax.abc").read_bytes()
    assert objs_to_abc([obj], tmp_path / "port.abc").read_bytes() == jax


@pytest.mark.parametrize("case", ["garbage", "truncated", "no_top_object"])
def test_extractor_rejects_malformed_archives(case, native_extractor, tmp_path, capsys):
    abc = tmp_path / "bad.abc"
    if case == "garbage":
        abc.write_bytes(b"not an ogawa file at all")
    else:
        data = write_polymesh_abc(tmp_path / "good.abc", [_tetra((0, 0, 0))]).read_bytes()
        if case == "truncated":
            data = data[: len(data) // 2]
        else:  # a root group of two children
            data = data[:8] + len(data).to_bytes(8, "little") + data[16:] + (2).to_bytes(8, "little") + bytes(16)
        abc.write_bytes(data)
    native = subprocess.run([str(native_extractor), "--alembic", str(abc), "--output", str(tmp_path / "o")],
                            capture_output=True, text=True)
    assert native.returncode == 1 and native.stderr.startswith("error: ")
    assert alembic_extractor.main(["--alembic", str(abc), "--output", str(tmp_path / "o")]) == 1
    err = capsys.readouterr().err
    assert err.startswith("error: ")
    if case != "truncated":  # the first bad read names the same place
        assert err == native.stderr


@pytest.mark.parametrize("args", [["--nope"], [], ["--alembic", "a.abc"]], ids=["unknown", "empty", "no-output"])
def test_extractor_bad_arguments(args, native_extractor, capsys):
    native = subprocess.run([str(native_extractor), *args], capture_output=True, text=True)
    assert native.returncode == 2
    assert alembic_extractor.main(args) == 2
    assert capsys.readouterr().err == native.stderr


# -------------------------------------------------------------------- card


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["subject", *RENDER_CASES[5:], "clipping"])
def test_kernels_match_plain_on_card(case, cuda_device, scene, tmp_path):
    """Each kernel against its plain version on the card, bit for bit: the
    projections, the tile lists (each tile's faces in any order), and the
    masks and depths of `mesh_raster`; the launch counts of one
    `rasterize`."""
    args = _case_args(case, scene, tmp_path)
    cameras = mesh_io.read_calibration_f32(args[args.index("--csv") + 1])
    obj = args[args.index("--objs") + 1 if case != "subject" else args.index("--csv") - 1]
    vertices, faces = (torch.from_numpy(a).to(cuda_device) for a in mesh_io.load_obj(obj))
    params = raster.CameraParams.build(cameras, cuda_device)
    raster.reset_launches()
    views = raster.rasterize(vertices, faces, cameras, 1.1)
    torch.cuda.synchronize()
    assert raster.launches == {"project": 1, "bin": 2, "raster": 1}
    proj = raster.launch_project(vertices, params, 1.1)
    plain_proj = raster.project_plain(vertices, params, 1.1)
    assert torch.equal(proj.view(torch.int32), plain_proj.view(torch.int32))
    bins, plain_bins = raster.launch_bin(proj, faces, params), raster.bin_plain(proj, faces, params)
    tile = torch.repeat_interleave(torch.arange(params.tiles, device=cuda_device),
                                   (bins.offsets[1:] - bins.offsets[:-1]).long())
    canonical = torch.sort(tile * faces.shape[0] + bins.entries.long())[0] % faces.shape[0]
    assert torch.equal(bins.offsets, plain_bins.offsets) and torch.equal(canonical.int(), plain_bins.entries)
    assert torch.equal(bins.slots, plain_bins.slots)
    assert (bins.crowded, bins.most) == (plain_bins.crowded, plain_bins.most)
    buf, fragments = raster.depth_buffer_plain(proj, faces, params)
    plain_mask, plain_depth = raster.resolve(buf)
    assert int(fragments.sum()) > 0
    mask, depth = raster.launch_raster(proj, faces, params, bins)
    assert torch.equal(mask, plain_mask) and torch.equal(depth.view(torch.int32), plain_depth.view(torch.int32))
    for (mask, depth), (plain_m, plain_d) in zip(views, raster.rasterize_plain(vertices, faces, cameras, 1.1)):
        assert torch.equal(mask, plain_m) and torch.equal(depth.view(torch.int32), plain_d.view(torch.int32))


@pytest.mark.cuda
def test_native_renderer_time_per_view_at_r4_size(cuda_device, native_renderer, tmp_path):
    """The native C++ tool's wall time per view on this machine's host at
    the r4 scene's full size (12 cameras, 748², the subject of frame 0,
    109,824 triangles), beside the port's CLI on the card; printed (run with
    -s), and the two outputs held equal."""
    cams = make_cameras(R4_SCENE)
    write_calibration_csv(cams, tmp_path / "calibration.csv")
    mesh_io.write_obj(tmp_path / "Frame000000.obj", *subject_mesh(R4_SCENE, 0))
    args = ["--objs", str(tmp_path / "Frame000000.obj"), "--csv", str(tmp_path / "calibration.csv"), "--mask",
            "--depth"]
    times = {}
    for name, run in (("native", lambda out: subprocess.run([str(native_renderer), *args, "--output", out],
                                                            check=True, capture_output=True)),
                      ("port", lambda out: mesh_renderer.main([*args, "--output", out, "--device", "cuda"]))):
        run(str(tmp_path / f"{name}_warm"))
        t0 = time.perf_counter()
        run(str(tmp_path / name))
        times[name] = (time.perf_counter() - t0) / len(cams)
    print(f"\nr4 size, 12 views of 748², 109,824 triangles, files written: native mesh_renderer (g++ -O2, "
          f"{os.cpu_count()} host threads) {times['native']:.4f} s per view; the port's CLI on "
          f"{torch.cuda.get_device_name(0)} {times['port']:.4f} s per view")
    assert _outputs(tmp_path / "native") == _outputs(tmp_path / "port")
