"""The port imports none of JAX, flax, OpenCV, PyYAML or msgpack, and nothing
of the JAX package: it needs only numpy, scipy and torch, and keeps its own
copies of the JAX package's framework-free flag parser, configs and camera
presets (held equal by `test_torch_configs.py`)."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import humanrf_torch

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "cv2", "yaml", "msgpack", "humanrf_tpu")


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
    assert {"humanrf_torch.ops.fused_interp", "humanrf_torch.ops.field_interp", "humanrf_torch.train.trainer",
            "humanrf_torch.convert", "humanrf_torch.run", "humanrf_torch.data.loader", "humanrf_torch.configs.args"} <= set(modules)
    result = _run(["import importlib", *(f"importlib.import_module({m!r})" for m in modules)])
    assert result.returncode == 0, result.stderr


def test_the_cli_parses_its_configs_without_forbidden_packages():
    """`--config NAME` imports humanrf_torch.configs.NAME, a list of flags."""
    result = _run([
        "from humanrf_torch.run import check_ported",
        "from humanrf_torch.configs.args import parse_args",
        "check_ported(parse_args(['--config', 'example_synthetic', '--tpu.sampling', 'proposal']))",
        "for name in ('example_humanrf', 'example_humanrf_tpu'):",
        "    parse_args(['--config', name])",
    ])
    assert result.returncode == 0, result.stderr


def test_chip_smoke_imports_nothing_of_jax():
    result = _run(["import chip_smoke"])
    assert result.returncode == 0, result.stderr
