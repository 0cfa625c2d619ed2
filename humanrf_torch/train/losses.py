"""Training losses.

Counterpart of `humanrf_tpu/train/losses.py`:

- Huber (δ = 0.01) photometric loss, `torch.nn.HuberLoss` semantics;
- the BCE mask loss with the reference's `clamp(p, 0, 1)` + `log(x + 1e-10)`
  value and gradient, as a `torch.autograd.Function` (the JAX `custom_vjp`);
- `masked_mean`, the mean over the rows a mask keeps, on one device or over
  the ranks of a process group.
"""
from __future__ import annotations

import torch

from humanrf_torch.parallel.collectives import all_reduce_


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float = 0.01) -> torch.Tensor:
    """Elementwise Huber."""
    err = pred - target
    abs_err = err.abs()
    return torch.where(abs_err <= delta, 0.5 * err * err, delta * (abs_err - 0.5 * delta))


class _BCELoss(torch.autograd.Function):
    """Forward: the clipped logs. Backward: the torch-autograd gradient of
    `-t·log(p+1e-10) - (1-t)·log(1-p+1e-10)` after clamp(p, 0, 1), with the
    guard folded into the denominators,

        dL/dp = -t / max(p, 1e-10) + (1 - t) / max(1 - p, 1e-10),  0 outside [0, 1].

    At a saturated ray (p == 1.0 in fp32, target 0) that is ~1e10: the
    restoring force that keeps density from ratcheting into opaque
    saturation (the JAX package's `_bce_bwd` says what removing it did).
    No gradient reaches the target.
    """

    @staticmethod
    def forward(ctx, pred, target):
        ctx.save_for_backward(pred, target)
        p = pred.clamp(0.0, 1.0)
        return -(target * torch.log(p.clamp(1e-10, 1.0)) + (1.0 - target) * torch.log((1.0 - p).clamp(1e-10, 1.0)))

    @staticmethod
    def backward(ctx, g):
        pred, target = ctx.saved_tensors
        p = pred.clamp(0.0, 1.0)
        grad_p = -target / p.clamp(min=1e-10) + (1.0 - target) / (1.0 - p).clamp(min=1e-10)
        grad_p = torch.where((pred >= 0.0) & (pred <= 1.0), grad_p, 0.0)
        return g * grad_p, None


def bce_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Elementwise binary cross-entropy (see `_BCELoss`)."""
    return _BCELoss.apply(pred, target)


class _GroupMean(torch.autograd.Function):
    """The value num_global / den_global, the gradient of num_local / den_global.

    Summed over the ranks, the local gradients are then the gradient of the
    mean over the whole batch: the JAX package's `psum` of numerator and
    denominator inside `shard_map`. `den` is a count and takes no gradient."""

    @staticmethod
    def forward(ctx, num, totals):
        den = totals[1].clamp(min=1.0)
        ctx.save_for_backward(den)
        return totals[0] / den

    @staticmethod
    def backward(ctx, g):
        (den,) = ctx.saved_tensors
        return g / den, None


def masked_mean(values: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise mean over the rows where `mask` is True: the static-shape
    form of the reference's mean over a compacted ray batch. With a process
    `group`, numerator and denominator are summed over its ranks, so the
    mean is the whole batch's while each rank's gradient stays its own
    rows' (`_GroupMean`)."""
    elems_per_row = values.numel() // values.shape[0]
    m = mask.reshape(mask.shape[0], *([1] * (values.dim() - 1))).to(values.dtype)
    num = (values * m).sum()
    den = mask.to(values.dtype).sum() * elems_per_row
    if group is None:
        return num / den.clamp(min=1.0)
    return _GroupMean.apply(num, all_reduce_(torch.stack([num.detach(), den]), group))
