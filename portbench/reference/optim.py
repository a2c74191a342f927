"""Global-norm clipping, then AdamW, as optax chains them.

The update the port's trainer is configured with
(``optax.chain(clip_by_global_norm(1.0), adamw(lr, weight_decay,
mu_dtype=bfloat16))``): the gradients divided by their global norm when it
is 1 or more; mu = b1 mu + (1 - b1) g with the stored bf16 mu multiplied by
b1 rounded to bf16 and the sum kept in f32 for this step's update, then
stored in bf16; nu = b2 nu + (1 - b2) g^2 in f32; bias corrections
1 - b^t in f32; the update mu_hat / (sqrt(nu_hat) + eps) plus weight decay
times the parameter, times the learning rate. Plain torch, one tensor at a
time.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


class AdamW:
    def __init__(self, params: Dict[str, torch.Tensor], lr: float, weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, max_norm: float = 1.0):
        self.params = params
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, weight_decay, b1, b2, eps
        self.max_norm = max_norm
        self.b1_bf16 = float(torch.tensor(b1, dtype=torch.bfloat16))
        self.mu = {k: torch.zeros_like(p, dtype=torch.bfloat16) for k, p in params.items()}
        self.nu = {k: torch.zeros_like(p) for k, p in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Apply one update; returns the clipped gradients the moments got."""
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads.values()))
        scale = torch.where(norm >= self.max_norm, self.max_norm / norm, torch.ones_like(norm))
        self.t += 1
        c1 = float(np.float32(1.0) - np.float32(self.b1) ** np.float32(self.t))
        c2 = float(np.float32(1.0) - np.float32(self.b2) ** np.float32(self.t))
        clipped = {}
        for k, p in self.params.items():
            g = grads[k].float() * scale
            clipped[k] = g
            mu = self.mu[k].float() * self.b1_bf16 + (1.0 - self.b1) * g
            self.nu[k].mul_(self.b2).add_((1.0 - self.b2) * g * g)
            upd = (mu / c1) / (torch.sqrt(self.nu[k] / c2) + self.eps) + self.wd * p
            p.add_(upd, alpha=-self.lr)
            self.mu[k].copy_(mu)
        return clipped


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(t.float().norm()) for k, t in tensors.items()}


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float], leaves: List[str]) -> float:
    """max over ``leaves`` of |prog - ref| / max(ref, the median leaf's ref)."""
    med = float(np.median([ref[k] for k in leaves]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves)
