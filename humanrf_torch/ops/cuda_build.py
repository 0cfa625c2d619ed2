"""Build a source of `humanrf_torch/csrc/` into a shared library and load it.

Each source exposes a plain C interface and is compiled into
`humanrf_torch/build/` at first use and loaded with `ctypes`; no PyTorch
headers are involved, so a build takes seconds. Two routes:

- `csrc/<name>.cu`, the CUDA kernels: `nvcc` for Hopper (`sm_90a`);
- `csrc/<name>.c`, host code (the image codec): the system C compiler.

The library's file name carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. A failed build
raises; nothing falls back.

Nothing here runs at import time: a machine without `nvcc` (the CPU test
environment) can import every module of the package.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Tuple

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
CC_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c99")


@dataclass
class BuiltLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when an up-to-date library was found on disk
    ptxas_log: str


_LOADED: Dict[Tuple[str, Tuple[str, ...]], BuiltLibrary] = {}
# One lock per library, so that loader threads asking for the codec at once
# build it once, while different libraries build side by side.
_LOCKS: Dict[Tuple[str, Tuple[str, ...]], threading.Lock] = {}
_LOCKS_LOCK = threading.Lock()


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


def find_cc() -> str:
    """The system C compiler ($CC, cc, gcc or clang); raises when there is none."""
    for c in (os.environ.get("CC"), "cc", "gcc", "clang"):
        if c and shutil.which(c):
            return shutil.which(c)
    raise RuntimeError("no C compiler found (set CC or put cc on PATH)")


def _route(name: str):
    """→ (source path, compiler command without output and source)."""
    if (CSRC_DIR / f"{name}.cu").exists():
        return CSRC_DIR / f"{name}.cu", lambda: [find_nvcc(), *NVCC_FLAGS]
    return CSRC_DIR / f"{name}.c", lambda: [find_cc(), *CC_FLAGS]


def library_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    src, _ = _route(name)
    flags = (*(NVCC_FLAGS if src.suffix == ".cu" else CC_FLAGS), *(f"-D{d}" for d in defines))
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def load_library(name: str, defines: Tuple[str, ...] = ()) -> BuiltLibrary:
    """Compile `csrc/<name>.cu` (nvcc) or `csrc/<name>.c` (cc) if needed and
    return the loaded library. `defines` (`"NAME=value"`, for measuring a
    variant of a kernel) are passed to the compiler as `-D` flags."""
    key = (name, tuple(defines))
    with _LOCKS_LOCK:
        lock = _LOCKS.setdefault(key, threading.Lock())
    with lock:
        if key in _LOADED:
            return _LOADED[key]
        src, compiler = _route(name)
        out = library_path(name, key[1])
        build_seconds, log = 0.0, ""
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [*compiler(), *(f"-D{d}" for d in key[1]), "-o", str(tmp), str(src)]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            build_seconds = time.perf_counter() - t0
            log = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(f"{cmd[0]} failed ({proc.returncode}) for {src.name}:\n{log}")
            os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
        built = BuiltLibrary(ctypes.CDLL(str(out)), out, build_seconds, log)
        _LOADED[key] = built
        return built
