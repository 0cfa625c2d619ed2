"""Bank a protocol run's small artifacts into `runs_evidence/`
(`scripts/bank_schedule_evidence.py` and `scripts/bank_r5_evidence.py`).

Copies, from anywhere under a run's root except its scene, the reports
(validation.txt, result.json, phases_result.json, results.json,
metrics.csv, averages.csv, config.yaml), the last 80 lines of every *.log,
and at most three PNGs per workspace (the first evaluated test frames, then
the last validation comparison), keeping their paths relative to the root.
It banks no checkpoint: the tree must stay small enough to copy.

    python -m humanrf_torch.protocol.bank --root protocol_runs/full_schedule --name full_schedule_dense_2500
        [--dest runs_evidence]

writes into <dest>/h100_<name>/.
"""
from __future__ import annotations

import argparse
import shutil
from pathlib import Path

from humanrf_torch.protocol import common

REPORTS = ("validation.txt", "result.json", "phases_result.json", "results.json", "metrics.csv", "averages.csv",
           "config.yaml")
LOG_TAIL_LINES = 80
MAX_IMAGES = 3


def workspace_images(ws: Path) -> list:
    """Up to MAX_IMAGES PNGs of a workspace: its first evaluated test frames,
    then its last validation comparison."""
    tests = sorted((ws / "results" / "test_frames").glob("*.png"))
    comparisons = sorted((ws / "validation").glob("*_comparison.png"))
    return (tests[: MAX_IMAGES - 1] + comparisons[-1:])[:MAX_IMAGES] if comparisons else tests[:MAX_IMAGES]


def bank(root: Path, dest: Path) -> list:
    """Copy `root`'s small artifacts into `dest` → the files written."""
    written = []

    def put(rel: Path, src: Path | None = None, text: str | None = None) -> None:
        target = dest / rel
        target.parent.mkdir(parents=True, exist_ok=True)
        if text is None:
            shutil.copyfile(src, target)
        else:
            target.write_text(text)
        written.append(target)

    for path in sorted(p for p in root.rglob("*") if p.is_file()):
        rel = path.relative_to(root)
        if "scene" in rel.parts:
            continue
        if path.name in REPORTS:
            put(rel, path)
        elif path.suffix == ".log":
            tail = path.read_text(errors="replace").splitlines()[-LOG_TAIL_LINES:]
            put(rel.with_name(f"{path.stem}_log_tail.txt"), text="\n".join(tail) + "\n")
        if path.name == "validation.txt":
            for image in workspace_images(path.parent):
                put(image.relative_to(root), image)
    return written


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, required=True, help="a driver's --root")
    ap.add_argument("--name", required=True, help="the run's name: files go to <dest>/h100_<name>")
    ap.add_argument("--dest", type=Path, default=common.REPO / "runs_evidence")
    args = ap.parse_args(argv)
    written = bank(args.root, args.dest / f"h100_{args.name}")
    for path in written:
        print(f"  banked {path}")
    return written


if __name__ == "__main__":
    main()
