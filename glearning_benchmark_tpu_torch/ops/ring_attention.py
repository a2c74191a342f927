"""Sequence-parallel ring attention over the 'seq' axis of the mesh.

Port of ``glearning_benchmark_tpu/ops/ring_attention.py``: the body that
``shard_map`` runs on each device (``_ring_body``), run by each rank on its
own blocks. A rank holds L/s query tokens and its resident K/V block; K, V
and the key mask travel ``s - 1`` hops around the ring through
:func:`..parallel.comm.ppermute` (rank i sends to rank i - 1, so after t
hops a rank holds the block that started on rank i + t), and each block is
folded into the online-softmax state (o, m, l) in f32. Masked lanes are
forced to exact zero, and a row that attends nothing gives zeros. The
reference rotates a last time, back to the start, feeding nothing; that
hop is left out. Each ring step is plain ``torch`` products, as the
reference's are XLA einsums: no kernel runs here. Gradients come from
autograd through the products and the differentiable ``ppermute``.

Dropout drops the normalised probabilities and keeps ``l`` undropped
(``ring_attention.py:84-86``). Its mask is the flash-attention kernel's own
counter hash (``ops/flash_attention._hash_u32``) at the absolute (global
batch*head, global query row, global key column) of each element, with the
kernel's exact threshold and rescale, so a sequence-parallel run draws the
masks of the one-process run through the kernels. The reference instead
folds a threefry key per (query shard, key block) and draws
``dropout_keep_mask`` (``ring_attention.py:79-83``): its SP stream is not
its own one-device stream either (ROADMAP §C).

Semantics are the reference's: the key-padding mask alone masks (a pad
query attends the valid keys; its output reaches no readout), and packed
rows are refused where the model calls the ring.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.comm import ppermute
from ..parallel.mesh import Axis
from .flash_attention import _check_bh_offset, _hash_u32, _keep_threshold, _seed_u32

_NEG = -1e30  # large-finite mask value: exp(_NEG - _NEG) stays defined


def _ring_keep(seed: int, bh_offset: int, b: int, h: int, q_rows: torch.Tensor,
               k_cols: torch.Tensor, p_drop: float) -> torch.Tensor:
    """[b, h, lq, lk] keep mask of the flash kernel's stream at the global
    (batch*head, row, col) of this block pair."""
    idx = dict(dtype=torch.int64, device=q_rows.device)
    bh = (torch.arange(b * h, **idx) + bh_offset).view(b, h, 1, 1)
    x = _hash_u32(_seed_u32(seed), bh, q_rows.view(1, 1, -1, 1), k_cols.view(1, 1, 1, -1))
    return x >= _keep_threshold(p_drop)


def seq_block(length: int, axis: Axis) -> int:
    """Tokens a rank of the 'seq' axis holds of a row of ``length``; the
    row must split evenly (``ring_attention.py:120-121``)."""
    if length % axis.size:
        raise ValueError(f"L={length} not divisible by seq axis size {axis.size}")
    return length // axis.size


def ring_attention(axis: Axis, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   key_mask: torch.Tensor, dropout_rate: float = 0.0,
                   seed: Optional[int] = None, bh_offset: int = 0) -> torch.Tensor:
    """Attention of this rank's query block over the whole sequence.

    q, k, v [B, Ls, H, D]: this rank's contiguous block of L = Ls * s
    tokens (rank ``axis.index`` holds tokens ``index * Ls ..``); key_mask
    [B, Ls] bool (True = attend). ``dropout_rate`` > 0 with ``seed`` (an
    int32) drops probabilities by the flash kernel's stream, ``bh_offset``
    being the global batch*head index of row 0 (a data-parallel rank's
    rows). Returns [B, Ls, H, D] in q's dtype."""
    if dropout_rate > 0.0 and seed is None:
        raise ValueError("dropout_rate > 0 requires a seed")
    n, me = axis.size, axis.index
    b, lq, h, d = q.shape
    bh_offset = _check_bh_offset(bh_offset, b * h)
    scale = 1.0 / d ** 0.5
    qf = q.float()
    o = torch.zeros((b, h, lq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, lq), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, lq), dtype=torch.float32, device=q.device)
    q_rows = torch.arange(lq, device=q.device) + me * lq
    perm = [(i, (i - 1) % n) for i in range(n)]
    k_blk, v_blk, m_blk = k, v, key_mask.to(torch.uint8)
    for t in range(n):
        allow = m_blk.bool()[:, None, None, :]
        logits = torch.einsum("blhd,bshd->bhls", qf, k_blk.float()) * scale
        logits = torch.where(allow, logits, _NEG)
        new_m = torch.maximum(m, logits.amax(-1))
        # masked lanes are exact zeros (exp(_NEG - new_m) is exp(0) = 1 on a
        # row masked so far)
        p = torch.where(allow, torch.exp(logits - new_m[..., None]), 0.0)
        corr = torch.exp(m - new_m)
        l = l * corr + p.sum(-1)
        if dropout_rate > 0.0:
            # drop the normalised probabilities: the numerator only; l keeps
            # the undropped mass
            k_cols = torch.arange(lq, device=q.device) + ((me + t) % n) * lq
            keep = _ring_keep(seed, bh_offset, b, h, q_rows, k_cols, dropout_rate)
            p = torch.where(keep, p * (1.0 / (1.0 - dropout_rate)), 0.0)
        o = o * corr[..., None] + torch.einsum("bhls,bshd->bhld", p, v_blk.float())
        m = new_m
        if t < n - 1:
            k_blk = ppermute(k_blk, axis, perm)
            v_blk = ppermute(v_blk, axis, perm)
            m_blk = ppermute(m_blk, axis, perm)
    out = torch.where(l[..., None] > 0, o / l.clamp(min=1e-30)[..., None], 0.0)
    return out.permute(0, 2, 1, 3).to(q.dtype)
