"""The port imports none of JAX, flax, OpenCV, PyYAML or msgpack, and nothing
of the JAX package: it needs only numpy, scipy and torch, and keeps its own
copies of the JAX package's framework-free flag parser, configs and camera
presets (held equal by `test_torch_configs.py`). The Blender exporter runs
inside Blender only (it exits when `bpy` is missing), so its imports are
read from its source."""
import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import humanrf_torch

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "cv2", "yaml", "msgpack", "humanrf_tpu")
BLENDER_ONLY = "humanrf_torch.toolbox.export_blender"
NEW_MODULES = {
    "humanrf_torch.data.trajectory", "humanrf_torch.data.download_manager", "humanrf_torch.core.morphology",
    "humanrf_torch.utils.summary", "humanrf_torch.utils.profiling", "humanrf_torch.toolbox.import_dfa",
    "humanrf_torch.toolbox.generate_occupancy_grids_from_masks", "humanrf_torch.toolbox.export_colmap",
    "humanrf_torch.toolbox.export_ngp", "humanrf_torch.toolbox.write_alembic", BLENDER_ONLY,
    "humanrf_torch.parallel.mesh", "humanrf_torch.parallel.fsdp", "humanrf_torch.parallel.launch",
    "humanrf_torch.parallel.collectives", "humanrf_torch.parallel.feed", "humanrf_torch.parallel.harness",
    "humanrf_torch.ops.rasterize", "humanrf_torch.toolbox.mesh_io", "humanrf_torch.toolbox.mesh_renderer",
    "humanrf_torch.toolbox.alembic_extractor",
    *(f"humanrf_torch.protocol.{name}" for name in (
        "validation_report", "common", "supervisor", "full_schedule", "finish_phases", "quality_at_capacity",
        "multiseg", "drift_ablation", "parallax_probe", "throughput_probe", "metric_style", "bank", "chain")),
}


def _modules():
    names = [
        m.name
        for m in pkgutil.walk_packages(humanrf_torch.__path__, prefix="humanrf_torch.")
    ]
    return ["humanrf_torch", *names]


def _run(lines):
    code = "\n".join([
        "import sys",
        *(f"sys.modules[{name!r}] = None" for name in BLOCKED),
        *lines,
        "leaked = [m for m in sys.modules if m.split('.')[0] == 'humanrf_tpu' and sys.modules[m] is not None]",
        "assert not leaked, leaked",
    ])
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)


def test_every_module_imports_without_forbidden_packages():
    modules = _modules()
    assert {"humanrf_torch.ops.fused_interp", "humanrf_torch.ops.field_interp", "humanrf_torch.ops.sampling",
            "humanrf_torch.train.trainer",
            "humanrf_torch.convert", "humanrf_torch.run", "humanrf_torch.data.loader", "humanrf_torch.configs.args"} <= set(modules)
    assert NEW_MODULES <= set(modules)
    importable = [m for m in modules if m != BLENDER_ONLY]
    result = _run(["import importlib", *(f"importlib.import_module({m!r})" for m in importable), "print('all imported')"])
    assert result.returncode == 0 and result.stdout.strip().endswith("all imported"), result.stderr


def test_the_blender_exporter_imports_only_blender_the_stdlib_numpy_and_the_ports_camera():
    tree = ast.parse((REPO / "humanrf_torch" / "toolbox" / "export_blender.py").read_text())
    imported = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            imported |= {alias.name for alias in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported.add(node.module)
    assert imported == {"bpy", "sys", "argparse", "math", "os", "pathlib", "numpy", "bpy_extras.image_utils",
                        "mathutils", "humanrf_torch.core.camera"}


def test_the_cli_parses_its_configs_without_forbidden_packages():
    """`--config NAME` imports humanrf_torch.configs.NAME, a list of flags."""
    result = _run([
        "from humanrf_torch.run import check_ported",
        "from humanrf_torch.configs.args import parse_args",
        "check_ported(parse_args(['--config', 'example_synthetic']))",
        "for name in ('example_humanrf', 'example_humanrf_tpu'):",
        "    parse_args(['--config', name])",
    ])
    assert result.returncode == 0, result.stderr


def test_chip_smoke_imports_nothing_of_jax():
    result = _run(["import chip_smoke"])
    assert result.returncode == 0, result.stderr
