"""Build a CUDA source of `humanrf_torch/csrc/` into a shared library and load it.

Each `csrc/<name>.cu` exposes a plain C interface. It is compiled with `nvcc`
for Hopper (`sm_90a`) into `humanrf_torch/build/` at first use and loaded
with `ctypes`; no PyTorch headers are involved, so a build takes seconds. The
library's file name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.

Nothing here runs at import time: a machine without `nvcc` (the CPU test
environment) can import every module of the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


@dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an up-to-date library was found on disk
    ptxas_log: str


_LOADED: Dict[str, BuiltLibrary] = {}


def find_nvcc() -> str:
    """nvcc from $CUDA_HOME, /usr/local/cuda or PATH; raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


def library_path(name: str) -> Path:
    src = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load_library(name: str) -> BuiltLibrary:
    """Compile `csrc/<name>.cu` if needed and return the loaded library."""
    if name in _LOADED:
        return _LOADED[name]
    out = library_path(name)
    build_seconds, log = 0.0, ""
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) for {name}.cu:\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    built = BuiltLibrary(ctypes.CDLL(str(out)), out, build_seconds, log)
    _LOADED[name] = built
    return built
