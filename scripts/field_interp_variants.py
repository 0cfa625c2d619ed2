#!/usr/bin/env python3
"""Time variants of the `field_interp` kernels on one NVIDIA Hopper GPU.

A variant is a set of the tuning macros of `humanrf_torch/csrc/field_interp.cu`
(`FIELD_INTERP_BWD_RUN`: the consecutive samples a backward thread owns,
whose repeated corners it sums in registers; `FIELD_INTERP_MIN_BLOCKS`: the
blocks per SM that ptxas must fit in registers). Each variant is built as
its own library, checked against the plain versions (the forward to 1e-5 of
the scale, the backward against the plain sums in fp64, as `chip_smoke.py`
holds them) and timed, forward and backward, at the r4 grid and vector
shapes of `chip_smoke.py`, at uniform random positions and at real ones
(phase 5's step-0 field query, captured as `chip_smoke.py` does). Each
variant is timed twice, in turns (first to last, then last to first).

Usage: python3 scripts/field_interp_variants.py "FIELD_INTERP_BWD_RUN=1" \
           "FIELD_INTERP_BWD_RUN=8,FIELD_INTERP_MIN_BLOCKS=3" ...
(no argument: the defaults alone)
"""
from __future__ import annotations

import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import chip_smoke as cs  # noqa: E402
from humanrf_torch.ops import field_interp as fli  # noqa: E402
from humanrf_torch.ops.cuda_build import load_library  # noqa: E402
from humanrf_torch.view_inputs import load_train_inputs, load_view_inputs  # noqa: E402


def main(variants) -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: this script runs only on a GPU")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"device: {smi}", flush=True)
    defines = {v: tuple(d for d in v.split(",") if d) for v in variants}
    with ThreadPoolExecutor(len(variants)) as pool:
        libs = dict(zip(variants, pool.map(lambda v: load_library("field_interp", defines[v]), variants)))
    for v, lib in libs.items():
        print(f"{v or 'defaults'}: " + "; ".join(k for k in cs.ptxas_summary(lib.ptxas_log) if "<8,4,1>" in k
                                                   or "<2,8,1>" in k), flush=True)
    view = load_view_inputs(cs.RUN_DIR / "torch_view_inputs.npz", device)
    real = cs.capture_real_xyzt(device, view, load_train_inputs(cs.RUN_DIR / "torch_train_inputs.npz", device))
    rng = np.random.default_rng(0)
    positions = {"random": torch.tensor(rng.uniform(0, 1, (262_144, 4)).astype(np.float32), device=device),
                 "real": real.contiguous()}
    for name, spec, P, F, T in cs.field_shapes(view)[:2]:
        tables = torch.tensor(rng.normal(size=(P, F, T)).astype(np.float32), device=device)
        for where, xyzt in positions.items():
            N = xyzt.shape[0]
            g = torch.tensor(rng.normal(size=(P, F, N)).astype(np.float32), device=device)
            calls = {"fwd": lambda: fli._launch_fwd(tables, xyzt, spec), "bwd": lambda: fli._launch_bwd(g, xyzt, spec, T)}
            refs = {"fwd": fli.field_interp_plain(tables, xyzt, spec),
                    "bwd": fli.field_interp_bwd_plain(g.double(), xyzt, spec, T)}
            for direction, call in calls.items():
                times = {}
                for turn in (variants, variants[::-1]):
                    for v in turn:
                        with mock.patch.object(fli, "load_library", lambda *_: libs[v]):
                            out = call()
                            scaled = float((out.double() - refs[direction]).abs().max() / refs[direction].abs().max())
                            if not scaled < cs.KERNEL_TOL:
                                raise AssertionError(f"{v} disagrees at {direction} {name}, {where}: {scaled:.3e}")
                            times.setdefault(v, []).append(cs.time_ms(call))
                print(f"{direction} {name} ({where} positions, N={N}): " + "; ".join(
                    f"{v or 'defaults'}: {np.mean(t):.4f} ms ({', '.join(f'{x:.4f}' for x in t)})"
                    for v, t in times.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:] or [""]))
