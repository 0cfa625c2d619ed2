"""The port imports none of JAX, flax, OpenCV, PyYAML or msgpack: the GPU
machine it runs on has no JAX package, and the port needs only numpy and
torch."""
import pkgutil
import subprocess
import sys
from pathlib import Path

import humanrf_torch

REPO = Path(__file__).resolve().parent.parent
BLOCKED = ("jax", "jaxlib", "flax", "cv2", "yaml", "msgpack")


def _modules():
    names = [
        m.name
        for m in pkgutil.walk_packages(humanrf_torch.__path__, prefix="humanrf_torch.")
    ]
    return ["humanrf_torch", *names]


def test_every_module_imports_without_forbidden_packages():
    modules = _modules()
    assert {"humanrf_torch.ops.fused_interp", "humanrf_torch.train.trainer", "humanrf_torch.convert"} <= set(modules)
    code = "\n".join([
        "import sys",
        *(f"sys.modules[{name!r}] = None" for name in BLOCKED),
        "import importlib",
        *(f"importlib.import_module({m!r})" for m in modules),
        "leaked = [m for m in sys.modules if m.split('.')[0] == 'humanrf_tpu']",
        "assert not leaked, leaked",
    ])
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr


def test_chip_smoke_imports_nothing_of_jax():
    code = "\n".join([
        "import sys",
        *(f"sys.modules[{name!r}] = None" for name in BLOCKED),
        "sys.modules['humanrf_tpu'] = None",
        "import chip_smoke",
    ])
    result = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr
