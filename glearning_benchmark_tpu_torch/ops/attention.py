"""Masked multi-head attention, plain PyTorch.

Port of ``glearning_benchmark_tpu/ops/attention.py``
(``multi_head_attention``, without dropout: the dropout helpers come with
the training slice). This is the eager reference of the XLA attention
path; the model's attention goes through :mod:`.flash_attention`.
"""

from __future__ import annotations

from typing import Optional

import torch


def multi_head_attention(
    q: torch.Tensor,                          # [B, L, H, D]
    k: torch.Tensor,                          # [B, S, H, D]
    v: torch.Tensor,                          # [B, S, H, D]
    key_mask: Optional[torch.Tensor] = None,  # [B, S] True = attend
    seg: Optional[torch.Tensor] = None,       # [B, L] segment ids (0 = pad)
) -> torch.Tensor:
    """Scaled dot-product attention with key-padding or segment masking.
    Returns [B, L, H, D]. With ``seg``, tokens attend only within their own
    segment; query rows that may attend nothing emit exact zeros."""
    d = q.shape[-1]
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), dtype=q.dtype))
    logits = torch.einsum("blhd,bshd->bhls", q, k) * scale
    if seg is not None:
        allow = ((seg[:, None, :, None] == seg[:, None, None, :])
                 & (seg > 0)[:, None, None, :])
    elif key_mask is not None:
        allow = key_mask[:, None, None, :]
    else:
        allow = None
    if allow is not None:
        logits = torch.where(allow, logits, torch.finfo(logits.dtype).min)
    probs = torch.softmax(logits, dim=-1)
    if allow is not None:
        probs = torch.where(allow, probs, 0.0)
    return torch.einsum("bhls,bshd->blhd", probs, v)
