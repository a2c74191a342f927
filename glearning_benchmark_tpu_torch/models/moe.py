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
same value; its gradient reaches each rank's own tokens.

Expert parallelism, as the JAX package lays it out:

- auto (``parallel.expert_shards``): the parameter rule splits the expert
  stacks over 'expert' (``parallel.mesh.shard_params`` sets ``ep_axis``). A
  rank routes its 'data' rows (the router is replicated), computes its
  E/ep experts for them, and the combine is summed over 'expert'
  (``comm.psum``), where GSPMD partitions the batched matmuls in the
  reference;
- manual (``parallel.ep_manual``, ``ep_mesh``): :func:`_manual_ep_ffn`,
  the reference's ``shard_map`` body: rows shard over data x expert, the
  capacity slots go to their experts' owners and back through two
  ``all_to_all`` exchanges.

Both draw the expert hidden layer's dropout from the global [E, B, C, f]
index of each element (the rank's experts on axis 0, its rows on axis 1),
so they drop what one process drops. The reference's manual path draws a
per-device threefry Bernoulli instead (``moe.py:97-102``, ROADMAP §C).

Sequence-parallel (``seq_axis``), a rank holds a block of every row's
tokens: a token's place in its expert's queue adds the counts of the
blocks before it (all-gathered over 'seq'), the capacity is the whole
row's, and the aux sums run over 'seq' too. Each rank applies the experts
to the slots of its own tokens only (the others' slots are zero rows whose
outputs its combine never reads), so the expert weights' gradients are the
sums over the token blocks, as for every other layer.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import cheap_dropout
from ..parallel.comm import all_gather, all_to_all, psum
from ..parallel.dist import global_sum
from ..parallel.tp import dense

_TRUNC_STD = 0.02        # flax truncated_normal(0.02): router, w1, w2


def _trunc(t: torch.Tensor, generator: Optional[torch.Generator]) -> None:
    nn.init.trunc_normal_(t, mean=0.0, std=_TRUNC_STD, a=-2.0 * _TRUNC_STD,
                          b=2.0 * _TRUNC_STD, generator=generator)


def _manual_ep_ffn(mesh, x, dispatch, top_p, w1, b1, w2, b2, *, dtype, p_drop,
                   seed=None, shard=None):
    """Expert FFN with explicit all-to-all dispatch over the 'expert' axis.

    This rank's rows: x [B_loc, L, d], dispatch [B_loc, L, E, C], top_p
    [B_loc, L]; its experts: w1 [E_loc, d, f] ... The capacity slots of the
    rows go to their experts' owners (split experts, concatenate rows), the
    owners run their experts on the rows of every rank of the 'expert'
    axis, and the outputs come back (split rows, concatenate experts), as
    ``moe.py:93`` and ``:107`` exchange them. ``shard`` places the rows in
    the global batch (rows over data x expert); ``seed`` turns on the
    hidden layer's dropout."""
    if set(mesh.axis_names) != {"data", "expert"}:
        raise ValueError("manual EP dispatch needs a ('data','expert') mesh, "
                         f"got {mesh.axis_names}")
    ep = int(mesh.shape["expert"])
    dp = int(mesh.shape["data"])
    b = x.shape[0] if shard is None else shard.total
    e = dispatch.shape[2]
    if b % (dp * ep):
        raise ValueError(f"batch {b} must divide over data*expert = "
                         f"{dp}*{ep} for manual EP dispatch")
    if e % ep:
        raise ValueError(f"n_experts {e} must divide over expert_shards {ep}")
    axis = mesh.axis("expert")
    b_loc, e_loc = x.shape[0], w1.shape[0]
    cap, d = dispatch.shape[3], x.shape[2]
    xin = torch.einsum("blec,bld->ebcd", dispatch.to(dtype), x.to(dtype))  # [E, B_loc, C, d]
    xin = all_to_all(xin, axis, 0, 1)                             # [E_loc, ep*B_loc, C, d]
    rows = xin.shape[1]
    h = torch.baddbmm(b1.to(dtype)[:, None, :], xin.reshape(e_loc, rows * cap, d),
                      w1.to(dtype))
    h = F.relu(h).view(e_loc, rows, cap, -1)
    if seed is not None:
        # the rows of every rank of this 'expert' slice: one contiguous block
        start = 0 if shard is None else shard.start - axis.index * b_loc
        h = cheap_dropout(seed, h, p_drop, batch_axis=1, batch_offset=start, batch_total=b,
                          place={0: (axis.index * e_loc, e)})
    h = torch.baddbmm(b2.to(dtype)[:, None, :], h.reshape(e_loc, rows * cap, -1),
                      w2.to(dtype)).view(e_loc, rows, cap, d)
    h = all_to_all(h, axis, 1, 0)                                 # [E, B_loc, C, d]
    combine = (dispatch * top_p[..., None, None]).to(dtype)
    return torch.einsum("blec,ebcd->bld", combine, h)


class SwitchFFN(nn.Module):
    """Top-1 Switch FFN over ``n_experts`` experts of width ``d_ff``.
    ``ep_mesh`` selects the manual all-to-all dispatch; ``seq_axis`` the
    sequence-parallel routing (module docstring)."""

    ep_axis = None       # set when the expert stacks are split over 'expert'

    def __init__(self, d_model: int, d_ff: int, n_experts: int,
                 capacity_factor: float = 1.25, p_drop: float = 0.1,
                 dtype: torch.dtype = torch.float32, ep_mesh=None, seq_axis=None):
        super().__init__()
        if n_experts < 1:
            raise ValueError(f"n_experts must be at least 1, got {n_experts}")
        self.n_experts = n_experts
        self.capacity_factor = capacity_factor
        self.p_drop = p_drop
        self.dtype = dtype
        self.ep_mesh = ep_mesh
        self.seq_axis = seq_axis
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
        seq = self.seq_axis
        cap = max(1, int(self.capacity_factor * l * (1 if seq is None else seq.size) / e))
        vf = valid.to(torch.float32)

        logits = dense(self.router, x.float(), torch.float32)
        probs = torch.softmax(logits, dim=-1)                         # [B, L, E]
        top = probs.argmax(dim=-1)                                    # [B, L]
        top_p = probs.gather(-1, top[..., None])[..., 0]
        onehot = F.one_hot(top, e).to(torch.float32) * vf[..., None]
        # each token's place in its expert's queue of the row, first come
        queue = torch.cumsum(onehot, dim=1)
        if seq is not None:
            # after the tokens of the row's earlier blocks
            counts = all_gather(onehot.sum(1)[None], seq, 0)          # [s, B, E]
            queue = queue + counts[:seq.index].sum(0)[:, None, :]
        pos = queue * onehot - 1.0                                    # [B, L, E]
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
            if seq is not None:
                sums = psum(sums, seq)
            # the reference counts in the compute dtype: a bf16 count rounds
            denom = sums[-1].to(self.dtype).float().clamp(min=1.0)
            aux = e * torch.sum((sums[:e] / denom) * (sums[e:2 * e] / denom))

        dt = self.dtype
        if self.ep_mesh is not None:
            return _manual_ep_ffn(self.ep_mesh, x, dispatch, top_p, self.w1, self.b1,
                                  self.w2, self.b2, dtype=dt, p_drop=self.p_drop,
                                  seed=seed, shard=shard), aux
        e_loc, e0, ax = e, 0, self.ep_axis
        if ax is not None:      # this rank's experts of the stacks split over 'expert'
            e_loc = self.w1.shape[0]
            e0 = ax.index * e_loc
            dispatch = dispatch[:, :, e0:e0 + e_loc]
        disp = dispatch.to(dt)
        xin = torch.einsum("blec,bld->ebcd", disp, x.to(dt))           # [E, B, C, d]
        h = torch.baddbmm(self.b1.to(dt)[:, None, :], xin.reshape(e_loc, b * cap, d),
                          self.w1.to(dt))
        h = F.relu(h).view(e_loc, b, cap, -1)
        if seed is not None:
            # the batch is axis 1 of [E, B, C, f]: a rank's words are strided
            h = cheap_dropout(seed, h, self.p_drop, batch_axis=1,
                              batch_offset=0 if shard is None else shard.start,
                              batch_total=None if shard is None else shard.total,
                              place=None if ax is None else {0: (e0, e)})
        h = torch.baddbmm(self.b2.to(dt)[:, None, :], h.reshape(e_loc, b * cap, -1),
                          self.w2.to(dt)).view(e_loc, b, cap, d)
        combine = (dispatch * top_p[..., None, None]).to(dt)          # [B, L, E, C]
        out = torch.einsum("blec,ebcd->bld", combine, h)
        return (out if ax is None else psum(out, ax)), aux
