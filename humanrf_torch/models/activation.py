"""Numerically safe activations.

Counterpart of `humanrf_tpu/models/activation.py`: `truncated_exp` is exp(x)
in float32 with the input clamped at +16 in the forward, and a backward that
clamps the input to [-15, 15]: g · exp(clip(x, -15, 15)). That backward is
not what autograd would derive from the forward (0 above 16, unclamped below
-15), so it is a `torch.autograd.Function`, as the JAX package's is a
`custom_vjp`. The JAX module's docstring says why both clamps matter.
"""
import torch

# exp(16) ≈ 8.9e6: far past alpha saturation, close enough to recover from.
_FWD_CLAMP = 16.0
_BWD_CLAMP = 15.0


class _TruncatedExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        x = x.float()
        ctx.save_for_backward(x)
        return torch.exp(torch.clamp(x, max=_FWD_CLAMP))

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, -_BWD_CLAMP, _BWD_CLAMP))


def truncated_exp(x: torch.Tensor) -> torch.Tensor:
    return _TruncatedExp.apply(x)
