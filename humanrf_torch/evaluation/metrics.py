"""Quality metrics: masked PSNR, SSIM, LPIPS.

Counterpart of `humanrf_tpu/evaluation/metrics.py`, with the same numbers:

- `compute_psnr` and `compute_ssim` are the same float64 numpy/scipy code
  (SSIM is skimage's default algorithm: uniform 7×7 window, K1 = 0.01,
  K2 = 0.03, sample covariance, mean over channels);
- `LpipsModel` is LPIPS-v0.1 (AlexNet features → unit-normalise → squared
  difference → 1×1 linear heads → spatial mean → sum) with `F.conv2d` and
  `F.max_pool2d`. It reads pretrained weights from the JAX package's path
  (`HUMANRF_TPU_LPIPS_WEIGHTS`, else ~/.cache/humanrf_tpu/lpips_alex.npz)
  when the file exists, and otherwise draws the same seeded random weights,
  reported as `lpips_randfeat`: a proxy, never named "lpips";
- `lpips_convert_weights` writes that file from the pip `lpips` package's
  pretrained AlexNet, the JAX package's converter's npz;
- `bounding_rect` is `cv2.boundingRect` of a mask's non-zero pixels.
"""
from __future__ import annotations

import os
import warnings
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


# --------------------------------------------------------------------- PSNR


def compute_psnr(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray | None = None) -> float:
    """Per-pixel channel-mean MSE, restricted to mask > 0 pixels, then
    −10·log10 of its mean."""
    mse = np.square(pred.astype(np.float64) - gt.astype(np.float64)).mean(axis=-1).reshape(-1)
    if mask is not None:
        mse = mse[np.asarray(mask).reshape(-1) > 0]
    return float(-10.0 * np.log10(mse.mean()))


def bounding_rect(mask: np.ndarray) -> Tuple[int, int, int, int]:
    """(x, y, w, h) of the smallest box holding every non-zero pixel of a
    2-D (or (H, W, 1)) mask; (0, 0, 0, 0) for an empty one."""
    mask = np.asarray(mask).reshape(mask.shape[0], mask.shape[1])
    rows, cols = np.nonzero(mask.any(axis=1))[0], np.nonzero(mask.any(axis=0))[0]
    if rows.size == 0:
        return 0, 0, 0, 0
    return int(cols[0]), int(rows[0]), int(cols[-1] - cols[0] + 1), int(rows[-1] - rows[0] + 1)


# --------------------------------------------------------------------- SSIM


def compute_ssim(im1: np.ndarray, im2: np.ndarray, data_range: float = 1.0, win_size: int = 7) -> float:
    """skimage.metrics.structural_similarity(channel_axis=2). An ROI smaller
    than the window shrinks the window to the largest odd size that fits,
    with a warning; one under 3 px is edge-padded to 3 px first."""
    from scipy.ndimage import uniform_filter

    im1 = np.asarray(im1, dtype=np.float64)
    im2 = np.asarray(im2, dtype=np.float64)
    assert im1.ndim == 3, "expected HWC"

    min_dim = min(im1.shape[0], im1.shape[1])
    if min_dim < 3:
        pad = ((0, max(3 - im1.shape[0], 0)), (0, max(3 - im1.shape[1], 0)), (0, 0))
        im1 = np.pad(im1, pad, mode="edge")
        im2 = np.pad(im2, pad, mode="edge")
        min_dim = 3
    if min_dim < win_size:
        shrunk = min_dim if min_dim % 2 == 1 else min_dim - 1
        warnings.warn(f"SSIM ROI {im1.shape[:2]} smaller than win_size={win_size}; using {shrunk}")
        win_size = shrunk

    C1 = (0.01 * data_range) ** 2
    C2 = (0.03 * data_range) ** 2
    NP = win_size**2
    cov_norm = NP / (NP - 1)

    ssims = []
    pad = (win_size - 1) // 2
    for c in range(im1.shape[2]):
        x, y = im1[..., c], im2[..., c]
        ux = uniform_filter(x, size=win_size, mode="reflect")
        uy = uniform_filter(y, size=win_size, mode="reflect")
        uxx = uniform_filter(x * x, size=win_size, mode="reflect")
        uyy = uniform_filter(y * y, size=win_size, mode="reflect")
        uxy = uniform_filter(x * y, size=win_size, mode="reflect")
        vx = cov_norm * (uxx - ux * ux)
        vy = cov_norm * (uyy - uy * uy)
        vxy = cov_norm * (uxy - ux * uy)

        A1, A2 = 2 * ux * uy + C1, 2 * vxy + C2
        B1, B2 = ux**2 + uy**2 + C1, vx + vy + C2
        S = (A1 * A2) / (B1 * B2)
        ssims.append(S[pad:-pad, pad:-pad].mean() if pad > 0 else S.mean())
    return float(np.mean(ssims))


# -------------------------------------------------------------------- LPIPS

# AlexNet feature extractor: (out_ch, kernel, stride, pad, maxpool_before).
_ALEX_LAYERS = [
    (64, 11, 4, 2, False),
    (192, 5, 1, 2, True),
    (384, 3, 1, 1, True),
    (256, 3, 1, 1, False),
    (256, 3, 1, 1, False),
]
# LPIPS input normalisation (lpips.LPIPS scaling_layer constants).
_LPIPS_SHIFT = np.array([-0.030, -0.088, -0.188], dtype=np.float32)
_LPIPS_SCALE = np.array([0.458, 0.448, 0.450], dtype=np.float32)


def _default_weights_path() -> Path:
    env = os.environ.get("HUMANRF_TPU_LPIPS_WEIGHTS")
    if env:
        return Path(env)
    return Path.home() / ".cache" / "humanrf_tpu" / "lpips_alex.npz"


def lpips_convert_weights(out_path: Path | None = None) -> Path:
    """Convert the pretrained weights of the pip `lpips` package (LPIPS-v0.1,
    AlexNet) into the npz that `LpipsModel` reads: `conv{i}_w`, `conv{i}_b`
    for the five convolutions in order and `lin{i}_w` for the five linear
    heads (their 1×1 weights flattened). Needs `lpips` installed."""
    import lpips as lpips_pkg  # optional dependency

    model = lpips_pkg.LPIPS(net="alex", version="0.1")
    arrays = {}
    convs = [m for part in (model.net.slice1, model.net.slice2, model.net.slice3, model.net.slice4,
                            model.net.slice5) for m in part if isinstance(m, torch.nn.Conv2d)]
    for i, conv in enumerate(convs):
        arrays[f"conv{i}_w"] = conv.weight.detach().numpy()
        arrays[f"conv{i}_b"] = conv.bias.detach().numpy()
    for i, lin in enumerate(model.lins):
        arrays[f"lin{i}_w"] = lin.model[-1].weight.detach().numpy()[:, :, 0, 0].reshape(-1)
    out_path = out_path or _default_weights_path()
    out_path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out_path, **arrays)
    return out_path


class LpipsModel:
    """LPIPS-v0.1 (AlexNet) in torch, on `device` (the card by default, as
    the JAX package runs it jitted on its accelerator)."""

    # Below this size AlexNet's stride-4 conv and two pools leave empty
    # feature maps; smaller ROIs are edge-padded up to it.
    MIN_SIZE = 64

    def __init__(self, weights: Dict[str, np.ndarray], is_pretrained: bool, device="cuda"):
        self.device = torch.device(device)
        self.weights = {k: torch.tensor(np.asarray(v, dtype=np.float32), device=self.device) for k, v in weights.items()}
        self.is_pretrained = is_pretrained
        self.metric_name = "lpips" if is_pretrained else "lpips_randfeat"

    @classmethod
    def load_or_init(cls, device="cuda") -> "LpipsModel":
        """The pretrained weights where the JAX package looks for them, else
        its seeded random features ('lpips_randfeat'), on `device`."""
        path = _default_weights_path()
        if path.exists():
            return cls(dict(np.load(path)), is_pretrained=True, device=device)
        rng = np.random.default_rng(0)
        weights = {}
        in_ch = 3
        for i, (out_ch, k, _, _, _) in enumerate(_ALEX_LAYERS):
            std = np.sqrt(2.0 / (in_ch * k * k))
            weights[f"conv{i}_w"] = (std * rng.standard_normal((out_ch, in_ch, k, k))).astype(np.float32)
            weights[f"conv{i}_b"] = np.zeros(out_ch, dtype=np.float32)
            weights[f"lin{i}_w"] = np.abs(rng.standard_normal(out_ch)).astype(np.float32) / out_ch
            in_ch = out_ch
        return cls(weights, is_pretrained=False, device=device)

    @torch.no_grad()
    def __call__(self, pred: np.ndarray, gt: np.ndarray) -> float:
        """pred, gt: (H, W, 3) in [0, 1]."""
        pred, gt = np.asarray(pred), np.asarray(gt)
        h, w = pred.shape[:2]
        if h < self.MIN_SIZE or w < self.MIN_SIZE:
            pad = ((0, max(self.MIN_SIZE - h, 0)), (0, max(self.MIN_SIZE - w, 0)), (0, 0))
            pred = np.pad(pred, pad, mode="edge")
            gt = np.pad(gt, pad, mode="edge")
        x, y = (torch.tensor(np.asarray(a, dtype=np.float32), device=self.device).permute(2, 0, 1)[None] * 2.0 - 1.0
                for a in (pred, gt))
        # cuDNN convolves in TF32 by default, which moves the metric by ~6e-5
        # relative on the card; in fp32 it is the CPU's value to ~1e-7.
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark, deterministic=cudnn.deterministic,
                         allow_tf32=False):
            return float(_lpips_forward(self.weights, x, y))


def _alex_features(weights, x: torch.Tensor) -> List[torch.Tensor]:
    """x: (N, 3, H, W) in [-1, 1] → the 5 post-ReLU feature maps."""
    shift = torch.tensor(_LPIPS_SHIFT, device=x.device).reshape(1, 3, 1, 1)
    scale = torch.tensor(_LPIPS_SCALE, device=x.device).reshape(1, 3, 1, 1)
    h = (x - shift) / scale
    feats = []
    for i, (_, _, stride, pad, pool_before) in enumerate(_ALEX_LAYERS):
        if pool_before:
            h = F.max_pool2d(h, kernel_size=3, stride=2)
        h = F.relu(F.conv2d(h, weights[f"conv{i}_w"], weights[f"conv{i}_b"], stride=stride, padding=pad))
        feats.append(h)
    return feats


def _lpips_forward(weights, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    total = 0.0
    for i, (a, b) in enumerate(zip(_alex_features(weights, x), _alex_features(weights, y))):
        a = a / torch.sqrt((a * a).sum(1, keepdim=True) + 1e-10)
        b = b / torch.sqrt((b * b).sum(1, keepdim=True) + 1e-10)
        lin = weights[f"lin{i}_w"].reshape(1, -1, 1, 1)
        total = total + (((a - b) ** 2) * lin).sum(1).mean()
    return total
