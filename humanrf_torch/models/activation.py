"""Numerically safe activations (forward only).

Counterpart of `humanrf_tpu/models/activation.py`: `truncated_exp` is exp(x)
with the input clamped at +16 in float32. The JAX package's backward clamp
to [-15, 15] arrives with the training port.
"""
import torch

# exp(16) ≈ 8.9e6: far past alpha saturation, close enough to recover from.
_FWD_CLAMP = 16.0


def truncated_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(x.float(), max=_FWD_CLAMP))
