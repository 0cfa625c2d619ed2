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


def _case_args(case: str, scene, tmp_path: Path) -> list:
    data_dir, objs = scene
    csv = str(data_dir / "calibration.csv")
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


@pytest.mark.parametrize("case", ["uv_sphere", "subject", "obj_syntax", "clipping", "subsets"])
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
def test_kernels_match_plain_on_card(cuda_device, scene):
    """mesh_project and mesh_raster against their plain versions on the
    card, bit for bit, and the CLI's files against the plain CLI's."""
    data_dir, objs = scene
    cameras = mesh_io.read_calibration_f32(data_dir / "calibration.csv")
    vertices, faces = (torch.from_numpy(a).to(cuda_device) for a in mesh_io.load_obj(objs[1]))
    params = raster.CameraParams.build(cameras, cuda_device)
    raster.reset_launches()
    proj = raster.launch_project(vertices, params, 1.1)
    buf = raster.launch_raster(proj, faces, params)
    torch.cuda.synchronize()
    assert raster.launches == {"project": 1, "raster": 1}
    assert torch.equal(proj.view(torch.int32), raster.project_plain(vertices, params, 1.1).view(torch.int32))
    plain, fragments = raster.depth_buffer_plain(proj, faces, params)
    assert torch.equal(buf.view(torch.int32), plain.view(torch.int32)) and int(fragments.sum()) > 0


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
