"""Masked multi-head attention and the counter-hash dropout, plain PyTorch.

Port of ``glearning_benchmark_tpu/ops/attention.py``: ``_hash1_u32``,
``hash_keep_mask``, ``cheap_dropout`` and ``multi_head_attention``. The
keep masks equal the JAX package's bit for bit for the same u32 seed: u32
arithmetic is carried in int64 tensors (``flash_attention._mul_u32``), the
word index is linearised over the whole tensor, and the four bytes of word
``w`` cover the blocked positions ``w, w + S/4, w + 2S/4, w + 3S/4`` of the
last axis. The seed is an explicit ``int``, not a framework key.
``multi_head_attention`` is the eager reference of the XLA attention path;
the model's attention goes through :mod:`.flash_attention`. The threefry
generator ``dropout_keep_mask`` is not ported (ROADMAP queue A, item 9).

``hash_dropout`` has no JAX counterpart: it stands in for flax's
``nn.Dropout`` (threefry Bernoulli masks) in the graph models, with the
same counter hash at a full 32-bit threshold, so its rate is exact and the
CPU and the GPU draw the same mask for the same seed.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .flash_attention import _U32, _keep_threshold, _mul_u32


def _hash1_u32(seed_u32: int, idx: torch.Tensor) -> torch.Tensor:
    """triple32 finaliser over a linear element index (int64 tensor holding
    u32 values)."""
    x = (_mul_u32(idx, 0x9E3779B1) + seed_u32) & _U32
    x = x ^ (x >> 16)
    x = _mul_u32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul_u32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _quantised_threshold(rate: float) -> int:
    """round(rate * 256): the u8 keep threshold. A rate that rounds to 256
    would drop everything and does not fit the byte compare: it raises."""
    thresh = int(round(rate * 256.0))
    if thresh >= 256:
        raise ValueError(f"dropout rate {rate} rounds to {thresh}/256; the "
                         "byte-quantised mask takes rates below 255.5/256")
    return thresh


def hash_keep_mask(seed_u32: int, shape, rate: float,
                   device: torch.device | str = "cpu"
                   ) -> Tuple[torch.Tensor, float]:
    """Counter-hash keep mask in the blocked-byte layout. Returns
    ``(keep bool[shape], effective_rate)`` with the rate quantised to
    ``round(rate * 256) / 256``; the caller rescales by the effective rate."""
    shape = tuple(shape)
    thresh = _quantised_threshold(rate)
    if thresh <= 0:
        return torch.ones(shape, dtype=torch.bool, device=device), 0.0
    s_last = shape[-1]
    wshape = shape[:-1] + ((s_last + 3) // 4,)
    n_words = 1
    for n in wshape:
        n_words *= n
    idx = (torch.arange(n_words, dtype=torch.int64, device=device) & _U32)
    words = _hash1_u32(int(seed_u32) & _U32, idx).view(wshape)
    keep = torch.cat([((words >> s) & 0xFF) >= thresh
                      for s in (0, 8, 16, 24)], dim=-1)
    return keep[..., :s_last], thresh / 256.0


def cheap_dropout(seed_u32: int, x: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout on activations by :func:`hash_keep_mask`: kept
    elements are divided by ``1 - p'`` in x's dtype, dropped ones are zero."""
    if _quantised_threshold(rate) <= 0:
        return x
    keep, p_eff = hash_keep_mask(seed_u32, x.shape, rate, device=x.device)
    return torch.where(keep, x / (1.0 - p_eff), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


def hash_dropout(seed_u32: int, x: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout with a full 32-bit threshold: element ``i`` of x
    (its linear index) is kept iff ``_hash1_u32(seed, i) >= rate * 2**32``,
    and kept elements are divided by ``1 - rate`` in x's dtype."""
    if rate <= 0.0:
        return x
    idx = torch.arange(x.numel(), dtype=torch.int64, device=x.device) & _U32
    keep = (_hash1_u32(int(seed_u32) & _U32, idx) >= _keep_threshold(rate)).view(x.shape)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def multi_head_attention(
    q: torch.Tensor,                          # [B, L, H, D]
    k: torch.Tensor,                          # [B, S, H, D]
    v: torch.Tensor,                          # [B, S, H, D]
    key_mask: Optional[torch.Tensor] = None,  # [B, S] True = attend
    seg: Optional[torch.Tensor] = None,       # [B, L] segment ids (0 = pad)
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,       # u32 seed of the keep mask
) -> torch.Tensor:
    """Scaled dot-product attention with key-padding or segment masking.
    Returns [B, L, H, D]. With ``seg``, tokens attend only within their own
    segment; query rows that may attend nothing emit exact zeros.
    ``dropout_rate`` with a ``dropout_seed`` drops attention probabilities
    by :func:`hash_keep_mask` over the [B, H, L, S] tensor."""
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
    if dropout_rate > 0.0 and dropout_seed is not None \
            and _quantised_threshold(dropout_rate) > 0:
        keep, p_eff = hash_keep_mask(dropout_seed, probs.shape, dropout_rate,
                                     device=probs.device)
        probs = torch.where(keep, probs / (1.0 - p_eff), 0.0)
    return torch.einsum("bhls,bshd->blhd", probs, v)
