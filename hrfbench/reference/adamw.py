"""AdamW with optax's `apply_if_finite` skip, as the port's trainer states it:

    m ← (1−b1)·g + b1·m,   v ← (1−b2)·g² + b2·v,   t ← t + 1
    p ← p − lr(t−1)·( (m / (1−b1^t)) / (√(v / (1−b2^t)) + eps) + wd·p )

with lr(t) = lr · decay^min(t / max_steps, 1); a step whose gradients hold an
inf or NaN changes nothing. b1, b2 and eps are the HumanRF release's.
"""
from __future__ import annotations

import torch


class AdamW:
    b1, b2, eps = 0.9, 0.99, 1e-15

    def __init__(self, params, lr: float, lr_decay: float, max_steps: int, weight_decay: float):
        self.params = list(params)
        self.lr, self.lr_decay, self.max_steps, self.weight_decay = lr, lr_decay, max_steps, weight_decay
        device = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        count_inc = (self.count + 1).float()
        step_size = -(self.lr * self.lr_decay ** torch.clamp(self.count.float() / self.max_steps, max=1.0))
        bc1 = 1.0 - self.b1**count_inc
        bc2 = 1.0 - self.b2**count_inc
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu_new = (1.0 - self.b1) * g + self.b1 * mu
            nu_new = (1.0 - self.b2) * g**2 + self.b2 * nu
            update = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + self.eps) + self.weight_decay * p
            p.copy_(torch.where(finite, p + step_size * update, p))
            mu.copy_(torch.where(finite, mu_new, mu))
            nu.copy_(torch.where(finite, nu_new, nu))
        self.count += finite.long()
