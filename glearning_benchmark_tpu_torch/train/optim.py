"""The training optimizer: global-norm clip, then AdamW, in plain torch ops.

The JAX package takes this from optax
(``optax.chain(clip_by_global_norm(1.0), adamw(schedule, weight_decay,
mu_dtype))``, ``train/trainer.py``); this module follows optax's order of
operations so that both trainers walk the same trajectory:

- clip: every gradient is divided by the global norm when that norm is not
  below ``max_norm`` (and multiplied by ``max_norm``);
- first moment ``mu = (1 - b1) g + b1 mu``: with ``mu_dtype`` bfloat16,
  optax multiplies the bf16 ``mu`` by a weakly typed ``b1``, which JAX
  rounds to bf16 first (0.9 becomes 0.8984375); inside a jitted step XLA
  then keeps the product's excess precision, so product and sum are f32.
  The port does the same (the tests hold it against the jitted optax
  update). The bias-corrected update reads that f32 sum, and only then is
  ``mu`` rounded to bf16 for storage;
- second moment in f32; bias corrections ``1 - b^count`` computed in f32;
- decoupled weight decay on every parameter (biases and LayerNorm scales
  included), added to the update before the learning rate multiplies both;
- a schedule is read at its own step count before that count is advanced.

These are elementwise passes over a few hundred thousand parameters, run
through ``torch._foreach_*``; no hand-written kernel is involved.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Union

import numpy as np
import torch

MU_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax's schedule of the same name: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine to ``end_value`` at
    step ``decay_steps`` (counted from 0, warmup included)."""
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError("warmup_cosine_decay_schedule needs decay_steps > "
                         f"warmup_steps, got {decay_steps} <= {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


def _bias_correction(decay: float, count: int) -> float:
    """1 - decay**count as optax computes it, in f32."""
    return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))


class ClippedAdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(...))`` over a
    fixed list of parameters. ``names`` are their ``state_dict`` keys, kept
    so that ``convert.py`` can lay the state out as the JAX package's
    checkpoints do."""

    def __init__(self, names: Sequence[str], params: Sequence[torch.Tensor],
                 learning_rate: Union[float, Callable[[int], float]],
                 weight_decay: float = 1e-4, mu_dtype: str = "bfloat16",
                 max_norm: float = 1.0, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        if mu_dtype not in MU_DTYPES:
            raise ValueError(f"train.mu_dtype must be one of "
                             f"{sorted(MU_DTYPES)}, got {mu_dtype!r}")
        self.names = list(names)
        self.params = list(params)
        self.schedule = learning_rate if callable(learning_rate) else None
        self.lr = None if callable(learning_rate) else float(learning_rate)
        self.weight_decay = float(weight_decay)
        self.max_norm, self.b1, self.b2, self.eps = max_norm, b1, b2, eps
        # the decay that multiplies the stored mu, rounded to mu's dtype
        self.b1_mu = float(torch.tensor(b1, dtype=MU_DTYPES[mu_dtype]))
        self.count = 0                      # Adam's step count
        self.schedule_count = 0             # the schedule's own count
        self.mu = [torch.zeros_like(p, dtype=MU_DTYPES[mu_dtype])
                   for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """Apply one update from ``grads`` (one per parameter). Returns the
        gradients' global norm before clipping, a 0-dim tensor on their
        device; nothing is read back to the host."""
        grads = [g.float() for g in grads]
        gnorm = torch.linalg.vector_norm(
            torch.stack(torch._foreach_norm(grads)))
        # below max_norm the gradients pass unchanged (g / 1 * max_norm / max_norm)
        clipped = gnorm >= self.max_norm
        denom = torch.where(clipped, gnorm, torch.ones_like(gnorm))
        grads = torch._foreach_div(grads, denom)
        factor = torch.where(clipped, torch.full_like(gnorm, self.max_norm),
                             torch.ones_like(gnorm))
        torch._foreach_mul_(grads, factor)

        self.count += 1
        mu32 = [m.float() for m in self.mu]
        torch._foreach_mul_(mu32, self.b1_mu)
        torch._foreach_add_(mu32, grads, alpha=1.0 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1.0 - self.b2)
        mu_hat = torch._foreach_div(mu32, _bias_correction(self.b1, self.count))
        denom = torch._foreach_div(self.nu, _bias_correction(self.b2, self.count))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu_hat, denom)
        torch._foreach_add_(updates, self.params, alpha=self.weight_decay)
        if self.schedule is not None:
            lr = float(np.float32(self.schedule(self.schedule_count)))
            self.schedule_count += 1
        else:
            lr = self.lr
        torch._foreach_add_(self.params, updates, alpha=-lr)
        for m, m32 in zip(self.mu, mu32):
            m.copy_(m32)
        return gnorm

    # -- state, for snapshots and checkpoints ------------------------------

    def state(self) -> dict:
        """A copy of the optimizer state (tensors cloned)."""
        return {"count": self.count, "schedule_count": self.schedule_count,
                "mu": [m.clone() for m in self.mu],
                "nu": [n.clone() for n in self.nu]}

    def load_state(self, state: dict) -> None:
        """Adopt ``state`` (as :meth:`state` returns it); moments are cast
        to this optimizer's dtypes and device."""
        self.count = int(state["count"])
        self.schedule_count = int(state.get("schedule_count", 0))
        for mine, theirs in ((self.mu, state["mu"]), (self.nu, state["nu"])):
            if len(mine) != len(theirs):
                raise ValueError(f"optimizer state holds {len(theirs)} "
                                 f"moments for {len(mine)} parameters")
            for m, t in zip(mine, theirs):
                m.copy_(t.to(device=m.device, dtype=m.dtype))
