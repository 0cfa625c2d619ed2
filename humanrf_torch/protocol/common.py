"""Shared plumbing of the protocol drivers (`scripts/driver_common.py`'s
counterpart): where runs and banked checkpoints live, the detailed synthetic
scene, its parameter-keyed cache, and the supervised CLI command. The port
has no compile cache to set up: its kernels build at first use into
`humanrf_torch/build/`."""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
from pathlib import Path

from humanrf_torch.core.synthetic import GENERATOR_VERSION, SyntheticSceneConfig, generate_synthetic_dataset
from humanrf_torch.protocol import supervisor
from humanrf_torch.r4 import R4_SCENE

REPO = Path(__file__).resolve().parents[2]
# Default roots of the drivers' scenes and workspaces (listed in .gitignore).
RUNS = REPO / "protocol_runs"
# The JAX package's 50k-step r4 run: best.ckpt is step 17,500.
R4_RUN = REPO / "runs_evidence" / "r4_full_schedule_748"

# Flags on which a port driver's command differs from the JAX driver's:
# the JAX drivers leave the device to the accelerator default, the port's
# name the card or the CPU. `multiseg` adds its device count and sharding.
MOOT_FLAGS = ("--device",)


def cli_command(flags) -> list:
    """The port's CLI as a command: `python -m humanrf_torch.run <flags>`."""
    return [sys.executable, "-m", "humanrf_torch.run", *flags]


def detail_scene(width: int, height: int, frames: int, travel: float) -> SyntheticSceneConfig:
    """The r4 scene's subject and rig (12 cameras, texture frequency 30, 12
    rods, a 128³ grid) at width × height over `frames` frames, the centre
    moving `travel` along z."""
    return dataclasses.replace(R4_SCENE, width=width, height=height, num_frames=frames,
                               center_start=(0.0, 0.0, -travel / 2), center_end=(0.0, 0.0, travel / 2))


def write_scene(root: Path, cfg: SyntheticSceneConfig, device: str) -> None:
    generate_synthetic_dataset(root, cfg, device=device)


def ensure_scene(scene: Path, meta: dict, generate, stale_dirs: tuple = ()) -> bool:
    """Generate the scene via `generate(scene)` unless an existing one carries
    an exactly matching scene_meta.json stamp.

    On regeneration, `stale_dirs` (run workspaces with `--training.checkpoint
    latest` state) are removed too: resuming a checkpoint trained on a
    deleted scene would mix scenes in the reported metrics, or crash on a
    segment or table shape mismatch. Returns True if generated.

    The stamp includes the generator's GENERATOR_VERSION, so a change of
    the renderer (which alters pixels without touching any caller's
    parameter) also invalidates the caches made before it."""
    meta = {**meta, "generator_version": GENERATOR_VERSION}
    meta_path = scene / "scene_meta.json"
    cached = (
        (scene / "SynthActor").exists()
        and meta_path.exists()
        and json.loads(meta_path.read_text()) == meta
    )
    if cached:
        return False
    shutil.rmtree(scene, ignore_errors=True)
    for d in stale_dirs:
        shutil.rmtree(d, ignore_errors=True)
    generate(scene)
    meta_path.write_text(json.dumps(meta))
    return True


def supervise_cli(cmd, log: Path, device: str, **kwargs) -> tuple:
    """`supervisor.supervise` of a CLI command from the repository's root,
    probing the card before each launch unless the run is on the CPU →
    (rc, restarts)."""
    on_card = device != "cpu"
    return supervisor.supervise(cmd, log, dict(os.environ), REPO, probe_first=on_card,
                                probe=supervisor.card_alive if on_card else (lambda: True), **kwargs)
