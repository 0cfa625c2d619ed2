"""Small bias-free MLPs.

Counterpart of `humanrf_tpu/models/mlp.py`: bias-free layers, ReLU between
them, inputs and weights in bf16, every layer's output rounded to bf16, the
last layer's output returned in fp32 (sigmoid applied there when asked). The
JAX package computes each layer as `jnp.dot(..., preferred_element_type=f32)`
followed by a bf16 cast; `_bf16_dot` computes the same. These are plain
products, left to PyTorch as the JAX package left them to XLA.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch
from torch import nn


def normal(shape, generator: torch.Generator) -> torch.Tensor:
    """N(0, 1) float32 draws from `generator`, on the generator's device."""
    return torch.randn(shape, generator=generator, device=generator.device)


def _bf16_dot(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 operands, fp32 accumulation, bf16 result.

    The product runs in fp32 on the bf16-rounded operands. A bf16 value is
    exact in fp32 and in TF32, and the product of two is exact in fp32, so the
    sum accumulates in fp32 whatever PyTorch's global matmul settings
    (`allow_tf32`, `allow_bf16_reduced_precision_reduction`) say.
    """
    return torch.matmul(h.float(), w.to(torch.bfloat16).float()).to(torch.bfloat16)


def apply_mlp(
    params: Mapping[str, torch.Tensor], x: torch.Tensor, output_activation: Optional[str] = None
) -> torch.Tensor:
    """x: (N, n_input_dims) → (N, n_output_dims), returned in fp32."""
    h = x.to(torch.bfloat16)
    n_layers = len(params)
    for i in range(n_layers):
        h = _bf16_dot(h, params[f"w{i}"])
        if i < n_layers - 1:
            h = torch.relu(h)
    h = h.float()
    if output_activation == "sigmoid":
        h = torch.sigmoid(h)
    elif output_activation is not None:
        raise ValueError(f"Unknown output activation: {output_activation}")
    return h


class MLP(nn.Module):
    """Weights `w0 .. w{n}` of shape (din, dout), the JAX layout."""

    def __init__(self, n_input_dims: int, n_output_dims: int, n_neurons: int, n_hidden_layers: int, device=None):
        super().__init__()
        dims = [n_input_dims] + [n_neurons] * n_hidden_layers + [n_output_dims]
        for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
            self.register_parameter(f"w{i}", nn.Parameter(torch.zeros((din, dout), device=device)))

    @torch.no_grad()
    def init_parameters(self, generator: torch.Generator) -> None:
        """He-normal, std √(2/din), as `humanrf_tpu/models/mlp.py::init_mlp`."""
        for w in self.parameters():
            w.copy_(normal(w.shape, generator) * (2.0 / w.shape[0]) ** 0.5)

    def forward(self, x: torch.Tensor, output_activation: Optional[str] = None) -> torch.Tensor:
        return apply_mlp(dict(self.named_parameters()), x, output_activation)
