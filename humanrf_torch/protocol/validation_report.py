"""A workspace's validation.txt as blocks: the trainer appends a `Step: N`
header, then one `image_id: i --- psnr=X ssim=Y ...` line per image.
Counterpart of `scripts/validation_report.py`; the one parser of the drivers'
reports, so a change of the trainer's format cannot reach one driver and
miss another."""
from __future__ import annotations

import re
from pathlib import Path


def parse_validation_blocks(ws: Path) -> list[dict]:
    """→ [{step, psnr: [..], ssim: [..]}, ...] in file order; [] if absent."""
    path = Path(ws) / "validation.txt"
    if not path.exists():
        return []
    blocks = []
    for block in path.read_text().split("Step: ")[1:]:
        lines = block.splitlines()
        # A watchdog or deadline kill can cut the file mid-append ("Step: "
        # with no number): skip that block, the report of a partial run
        # must not crash on it.
        if not lines or not lines[0].strip().isdigit():
            continue
        blocks.append(
            {
                "step": int(lines[0].strip()),
                "psnr": [float(m.group(1)) for ln in lines[1:] if (m := re.search(r"psnr=([\d.]+)", ln))],
                "ssim": [float(m.group(1)) for ln in lines[1:] if (m := re.search(r"ssim=([\d.]+)", ln))],
            }
        )
    return blocks


def block_means(blocks: list[dict]) -> list[dict]:
    """Each block's mean PSNR and SSIM (the protocol table's rows)."""
    out = []
    for b in blocks:
        if not b["psnr"]:
            continue
        out.append(
            {
                "step": b["step"],
                "psnr": round(sum(b["psnr"]) / len(b["psnr"]), 3),
                "ssim": round(sum(b["ssim"]) / max(len(b["ssim"]), 1), 4),
                "n_images": len(b["psnr"]),
            }
        )
    return out


def best_block(blocks: list[dict]) -> dict:
    """The block of best mean PSNR (the reference's best-checkpoint rule) and
    the last validated step. {} only when no block was parsed; blocks
    without metrics still report last_val_step, so a run cut off after a
    header differs from one that never validated."""
    if not blocks:
        return {}
    rows = block_means(blocks)
    if not rows:
        return {
            "psnr": 0.0,
            "ssim": 0.0,
            "at_step": None,
            "n_val_images": 0,
            "last_val_step": blocks[-1]["step"],
        }
    best = max(rows, key=lambda r: r["psnr"])
    return {
        "psnr": best["psnr"],
        "ssim": best["ssim"],
        "at_step": best["step"],
        "n_val_images": best["n_images"],
        "last_val_step": rows[-1]["step"],
    }
