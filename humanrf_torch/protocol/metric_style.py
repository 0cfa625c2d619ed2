"""The r4 run's validation-to-test gap split into the metrics' definition and
the view (`scripts/metric_style_decomposition.py`).

The trainer's validation reports unmasked ROI PSNR (background pixels
included, `Trainer._evaluate_one_image`); the evaluate phase reports masked
PSNR (foreground only, `evaluation/evaluate.py`, the reference protocol's).
The two were never comparable. This computes both styles on the same test
renders (the evaluate phase's Cam012 frames), which isolates the metric's
part of the gap; `parallax_probe` gives the PSNR-against-angle curve for the
rest.

    python -m humanrf_torch.protocol.metric_style [--results <ws>/results/test_frames] [--scene <scene>/SynthActor/Sequence1/1x]
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from humanrf_torch.core import image_io
from humanrf_torch.evaluation.metrics import bounding_rect, compute_psnr
from humanrf_torch.protocol import common

_SCHEDULE = common.RUNS / "full_schedule"


def decompose(results: Path, scene: Path, camera: str = "Cam012") -> dict:
    """Both PSNR styles over the camera's renders → {n, psnr_roi, psnr_masked, delta}."""
    roi, masked = [], []
    for p in sorted(results.glob(f"{camera}_rgb*.png")):
        frame = int(p.stem.split("rgb")[1])
        gt_c = list((scene / "rgbs" / camera).glob(f"*{frame:06d}*"))
        mask_c = list((scene / "masks" / camera).glob(f"*{frame:06d}*"))
        if not gt_c or not mask_c:
            continue
        pred = image_io.imread(p)[..., ::-1].astype(np.float64) / 255
        gt = image_io.imread(gt_c[0])[..., ::-1].astype(np.float64) / 255
        mask = image_io.imread(mask_c[0])[..., 0:1]
        gt_black = gt * (mask > 0)  # validation composites the ground truth on black
        x, y, w, h = bounding_rect(mask)
        pr, gr, mr = pred[y : y + h, x : x + w], gt_black[y : y + h, x : x + w], mask[y : y + h, x : x + w]
        roi.append(compute_psnr(pr, gr))
        masked.append(compute_psnr(pr, gr, mask=mr))
    if not roi:
        raise SystemExit(f"no comparable frames under {results}")
    return {"n": len(roi), "psnr_roi": float(np.mean(roi)), "psnr_masked": float(np.mean(masked)),
            "delta": float(np.mean(roi) - np.mean(masked))}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--results", type=Path, default=_SCHEDULE / "workspace" / "results" / "test_frames")
    ap.add_argument("--scene", type=Path, default=_SCHEDULE / "scene" / "SynthActor" / "Sequence1" / "1x")
    ap.add_argument("--camera", default="Cam012")
    args = ap.parse_args(argv)
    r = decompose(args.results, args.scene, args.camera)
    print(f"n={r['n']} frames ({args.camera})")
    print(f"ROI (val-style)      PSNR: {r['psnr_roi']:.2f} dB")
    print(f"masked (eval-style)  PSNR: {r['psnr_masked']:.2f} dB")
    print(f"metric-style delta:        {r['delta']:.2f} dB")
    return r


if __name__ == "__main__":
    main()
