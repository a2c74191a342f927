"""Switch-style mixture-of-experts FFN, in PyTorch.

Port of ``glearning_benchmark_tpu/models/moe.py`` ``SwitchFFN``, its
auto-dispatch path: a drop-in for the encoder's ff1 -> ReLU -> ff2 block
as dense one-hot dispatch with static shapes, no ragged gather or scatter.

    route   : softmax(router(x)) in f32 -> top-1 expert per token
    dispatch: one-hot [B, L, E, C] with a per-row capacity
              C = max(1, int(cf * L / E)), first-come by a cumsum over the
              row; tokens past capacity (and invalid ones) get no slot and
              ride the encoder's residual
    experts : [E, B, C, d] @ w1[E, d, f] + b1 -> ReLU -> dropout
              -> @ w2[E, f, d] + b2
    combine : router-probability-weighted one-hot gather back to [B, L, d]

The expert stacks keep the flax layout and names (``w1`` [E, d, f], ``b1``
[E, f], ``w2`` [E, f, d], ``b2`` [E, d], ``router``), so ``convert.py``
maps them as they are. The dispatch and combine tensors are cast to the
compute dtype where the reference casts them; the router and its softmax
stay f32.

The Switch load-balance loss ``E * sum_e(frac_e * mean_p_e)`` is returned
on training forwards: ``frac`` and ``mean_p`` are sums over every valid
token of the batch. Under data parallelism that batch is the global one,
as GSPMD computes it in the reference: with a ``shard`` the three sums are
all-reduced over its group with autograd through the reduction
(``torch.distributed.nn.functional.all_reduce``), so every rank gets the
same value; its gradient reaches each rank's own tokens. The expert-parallel
manual dispatch (``ep_manual``) comes with the EP slice.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import cheap_dropout
from ..parallel.dist import global_sum

_TRUNC_STD = 0.02        # flax truncated_normal(0.02): router, w1, w2


def _trunc(t: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    nn.init.trunc_normal_(t, mean=0.0, std=_TRUNC_STD, a=-2.0 * _TRUNC_STD,
                          b=2.0 * _TRUNC_STD, generator=generator)


class SwitchFFN(nn.Module):
    """Top-1 Switch FFN over ``n_experts`` experts of width ``d_ff``."""

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 capacity_factor: float = 1.25, p_drop: float = 0.1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if n_experts < 1:
            raise ValueError(f"n_experts must be at least 1, got {n_experts}")
        self.n_experts = n_experts
        self.capacity_factor = capacity_factor
        self.p_drop = p_drop
        self.dtype = dtype
        self.router = nn.Linear(d_model, n_experts)
        self.w1 = nn.Parameter(torch.empty(n_experts, d_model, d_ff))
        self.b1 = nn.Parameter(torch.zeros(n_experts, d_ff))
        self.w2 = nn.Parameter(torch.empty(n_experts, d_ff, d_model))
        self.b2 = nn.Parameter(torch.zeros(n_experts, d_model))
        self.reset_parameters(None)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        _trunc(self.router.weight, generator)
        nn.init.zeros_(self.router.bias)
        _trunc(self.w1, generator)
        nn.init.zeros_(self.b1)
        _trunc(self.w2, generator)
        nn.init.zeros_(self.b2)

    def forward(self, x: torch.Tensor, valid: torch.Tensor,
                seed: Optional[int] = None, shard=None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x [B, L, d] (compute dtype), valid [B, L] bool -> (out [B, L, d]
        in the compute dtype, aux loss or None). ``seed`` turns on the
        dropout of the expert hidden layer; the aux loss comes back in
        ``train()`` mode. ``shard`` (``parallel.mesh.BatchShard``) says which
        rows of the global batch these are."""
        b, l, d = x.shape
        e = self.n_experts
        cap = max(1, int(self.capacity_factor * l / e))
        vf = valid.to(torch.float32)

        logits = F.linear(x.float(), self.router.weight, self.router.bias)
        probs = torch.softmax(logits, dim=-1)                         # [B, L, E]
        top = probs.argmax(dim=-1)                                    # [B, L]
        top_p = probs.gather(-1, top[..., None])[..., 0]
        onehot = F.one_hot(top, e).to(torch.float32) * vf[..., None]
        # each token's place in its expert's queue of the row, first come
        pos = torch.cumsum(onehot, dim=1) * onehot - 1.0              # [B, L, E]
        keep = (pos >= 0) & (pos < cap)
        pos_oh = F.one_hot(pos.clamp(0, cap - 1).to(torch.int64), cap).to(torch.float32) \
            * keep[..., None].to(torch.float32)
        dispatch = onehot[..., None] * pos_oh                         # [B, L, E, C]

        aux = None
        if self.training:
            # over ALL valid tokens of the (global) batch: E when balanced
            sums = global_sum(torch.cat([onehot.sum((0, 1)),
                                         (probs * vf[..., None]).sum((0, 1)),
                                         vf.sum()[None]]), shard)
            # the reference counts in the compute dtype: a bf16 count rounds
            denom = sums[-1].to(self.dtype).float().clamp(min=1.0)
            aux = e * torch.sum((sums[:e] / denom) * (sums[e:2 * e] / denom))

        dt = self.dtype
        disp = dispatch.to(dt)
        xin = torch.einsum("blec,bld->ebcd", disp, x.to(dt))           # [E, B, C, d]
        h = torch.baddbmm(self.b1.to(dt)[:, None, :], xin.reshape(e, b * cap, d),
                          self.w1.to(dt))
        h = F.relu(h).view(e, b, cap, -1)
        if seed is not None:
            # the batch is axis 1 of [E, B, C, f]: a rank's words are strided
            h = cheap_dropout(seed, h, self.p_drop, batch_axis=1,
                              batch_offset=0 if shard is None else shard.start,
                              batch_total=None if shard is None else shard.total)
        h = torch.baddbmm(self.b2.to(dt)[:, None, :], h.reshape(e, b * cap, -1),
                          self.w2.to(dt)).view(e, b, cap, d)
        combine = (dispatch * top_p[..., None, None]).to(dt)          # [B, L, E, C]
        return torch.einsum("blec,ebcd->bld", combine, h), aux
