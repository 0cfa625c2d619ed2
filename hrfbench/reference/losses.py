"""Training losses: Huber (δ = 0.01), the clipped BCE mask loss and the masked mean."""
from __future__ import annotations

import torch


def huber_loss(pred: torch.Tensor, target: torch.Tensor, delta: float = 0.01) -> torch.Tensor:
    """Elementwise Huber."""
    err = pred - target
    abs_err = err.abs()
    return torch.where(abs_err <= delta, 0.5 * err * err, delta * (abs_err - 0.5 * delta))


class _BCELoss(torch.autograd.Function):
    """Forward: the clipped logs. Backward: the gradient of
    `-t·log(p+1e-10) - (1-t)·log(1-p+1e-10)` after clamp(p, 0, 1), with the
    guard folded into the denominators, 0 outside [0, 1]; none to the target."""

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
    return _BCELoss.apply(pred, target)


def masked_mean(values: torch.Tensor, mask: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise mean over the rows where `mask` is True (one device: `group` must be None)."""
    if group is not None:
        raise ValueError("the reference runs on one device")
    elems_per_row = values.numel() // values.shape[0]
    m = mask.reshape(mask.shape[0], *([1] * (values.dim() - 1))).to(values.dtype)
    num = (values * m).sum()
    den = mask.to(values.dtype).sum() * elems_per_row
    return num / den.clamp(min=1.0)
