"""Masked multi-head attention and the dropout streams, plain PyTorch.

Port of ``glearning_benchmark_tpu/ops/attention.py``: ``dropout_keep_mask``,
``_hash1_u32``, ``hash_keep_mask``, ``cheap_dropout`` and
``multi_head_attention``. The keep masks equal the JAX package's bit for
bit for the same key or u32 seed: u32 arithmetic is carried in int64
tensors (``flash_attention._mul_u32``), the word index is linearised over
the whole tensor, and the four bytes of word ``w`` cover the blocked
positions ``w, w + S/4, w + 2S/4, w + 3S/4`` of the last axis.
``dropout_keep_mask`` draws its words from threefry2x32 as
``jax.random.bits`` does with ``jax_threefry_partitionable`` (the default
of jax 0.9), from the key's two u32 words (``jax.random.key_data``), and
:func:`bernoulli` is ``jax.random.bernoulli`` on the same words (the
dropout microbench's flax-style variant); the hash helpers take an
explicit ``int`` seed. ``multi_head_attention`` is the
eager reference of the XLA attention path; the model's attention goes
through :mod:`.flash_attention` (and, sequence-parallel, through
:mod:`.ring_attention`).

Under a mesh the JAX package draws each mask over the whole global tensor,
and a device holds a block of it. The helpers here take the same view:
``batch_offset`` is the global index of this tensor's first row along
``batch_axis``, and ``batch_total`` the global batch (needed only when the
batch is not the leading axis, as in the MoE expert tensor [E, B, C, f],
whose rows of one rank are strided words of the global tensor); ``place``
gives any other axes' (offset, global size), as a sequence-parallel rank's
token block (axis 1) or an expert-parallel rank's experts (axis 0). With
one process every offset is 0 and the masks are unchanged.

``cheap_dropout`` and ``hash_dropout`` run on a CUDA tensor as one launch
of the hash-dropout kernel (:mod:`.hash_dropout`, the counterpart of the
fused XLA pass the JAX package's functions compile to), forward and
backward; on a CPU tensor as their plain versions, the int64 torch ops of
``cheap_dropout_reference`` and ``hash_dropout_reference``, which give the
same bits.

``hash_dropout`` has no JAX counterpart: it stands in for flax's
``nn.Dropout`` (threefry Bernoulli masks) in the graph models, with the
same counter hash at a full 32-bit threshold, so its rate is exact and the
CPU and the GPU draw the same mask for the same seed.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from .flash_attention import _U32, _keep_threshold, _mul_u32
from .hash_dropout import blocked_site, dropout, element_site, placement


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _U32


def threefry2x32(key: Sequence[int], x0: torch.Tensor, x1: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of the count words (x0, x1) under the key
    (k0, k1), as ``jax._src.prng._threefry2x32_lowering`` computes it."""
    k0, k1 = int(key[0]) & _U32, int(key[1]) & _U32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    rotations = ((13, 15, 26, 6), (17, 29, 16, 24))
    x0, x1 = (x0 + ks[0]) & _U32, (x1 + ks[1]) & _U32
    for i in range(5):
        for r in rotations[i % 2]:
            x0 = (x0 + x1) & _U32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _U32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _U32
    return x0, x1


def random_bits(key: Sequence[int], shape, device: torch.device | str = "cpu"
                ) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` with partitionable threefry:
    element ``i`` (row-major) is ``x0 ^ x1`` of threefry2x32 over the count
    words (i >> 32, i & 0xFFFFFFFF); u32 values in an int64 tensor."""
    n = 1
    for size in shape:
        n *= size
    idx = torch.arange(n, dtype=torch.int64, device=device)
    x0, x1 = threefry2x32(key, idx >> 32, idx & _U32)
    return (x0 ^ x1).view(tuple(shape))


def bernoulli(key: Sequence[int], p: float, shape,
              device: torch.device | str = "cpu") -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: bool[shape], True where the
    uniform f32 in [0, 1) of the element's threefry word (:func:`random_bits`;
    its top 23 bits as the mantissa of a float in [1, 2), minus 1) lies
    below the f32 of ``p``."""
    bits = random_bits(key, shape, device)
    u = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return u < torch.tensor(p, dtype=torch.float32)


def dropout_keep_mask(key: Sequence[int], shape, rate: float,
                      device: torch.device | str = "cpu") -> Tuple[torch.Tensor, float]:
    """The JAX package's ``dropout_keep_mask``: keep mask bool[shape] and
    the quantised rate round(rate * 256) / 256 the caller rescales by. One
    threefry word of ``key`` (its two u32 words) covers four blocked bytes
    of the last axis; a byte at or above the threshold keeps."""
    thresh = _quantised_threshold(rate)
    shape = tuple(shape)
    if thresh <= 0:
        return torch.ones(shape, dtype=torch.bool, device=device), 0.0
    s_last = shape[-1]
    words = random_bits(key, shape[:-1] + ((s_last + 3) // 4,), device)
    keep = torch.cat([((words >> s) & 0xFF) >= thresh for s in (0, 8, 16, 24)], dim=-1)
    return keep[..., :s_last], thresh / 256.0


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


def _global_index(shape, device, batch_axis: int, batch_offset: int,
                  batch_total: Optional[int],
                  place: Optional[Dict[int, Tuple[int, int]]] = None) -> torch.Tensor:
    """int64 linear index (mod 2**32) of every element of a tensor of
    ``shape`` inside the global tensor whose ``batch_axis`` has
    ``batch_total`` rows, of which this one holds ``batch_offset ..``, and
    whose axes in ``place`` ({axis: (offset, global size)}) hold this
    tensor's block at that offset."""
    shape = tuple(shape)
    n = 1
    for size in shape:
        n *= size
    at = placement(shape, batch_axis, batch_offset, batch_total, place)
    arange = dict(dtype=torch.int64, device=device)
    if all(total == shape[ax] for ax, (_, total) in at.items() if ax != 0):
        # one contiguous run of the global tensor's indices
        start = at[0][0] * (n // shape[0]) if 0 in at and n else 0
        return (torch.arange(n, **arange) + start) & _U32
    idx = torch.zeros((), **arange)
    stride = 1
    for ax in range(len(shape) - 1, -1, -1):
        offset, total = at.get(ax, (0, shape[ax]))
        pos = torch.arange(shape[ax], **arange) + offset
        idx = idx + pos.view((-1,) + (1,) * (len(shape) - 1 - ax)) * stride
        stride *= total
    return idx.reshape(-1) & _U32


def hash_keep_mask(seed_u32: int, shape, rate: float,
                   device: torch.device | str = "cpu", *, batch_axis: int = 0,
                   batch_offset: int = 0, batch_total: Optional[int] = None,
                   place: Optional[Dict[int, Tuple[int, int]]] = None
                   ) -> Tuple[torch.Tensor, float]:
    """Counter-hash keep mask in the blocked-byte layout. Returns
    ``(keep bool[shape], effective_rate)`` with the rate quantised to
    ``round(rate * 256) / 256``; the caller rescales by the effective rate.
    ``batch_axis``/``batch_offset``/``batch_total`` and ``place`` place the
    tensor in a global one (module docstring); the mask is then its block of
    the global mask."""
    shape = tuple(shape)
    thresh = _quantised_threshold(rate)
    if thresh <= 0:
        return torch.ones(shape, dtype=torch.bool, device=device), 0.0
    s_last = shape[-1]
    wshape = shape[:-1] + ((s_last + 3) // 4,)
    idx = _global_index(wshape, device, batch_axis, int(batch_offset), batch_total,
                        place)
    words = _hash1_u32(int(seed_u32) & _U32, idx).view(wshape)
    keep = torch.cat([((words >> s) & 0xFF) >= thresh
                      for s in (0, 8, 16, 24)], dim=-1)
    return keep[..., :s_last], thresh / 256.0


def cheap_dropout_reference(seed_u32: int, x: torch.Tensor, rate: float, *,
                            batch_axis: int = 0, batch_offset: int = 0,
                            batch_total: Optional[int] = None,
                            place: Optional[Dict[int, Tuple[int, int]]] = None
                            ) -> torch.Tensor:
    """The plain version of :func:`cheap_dropout`: the keep mask of
    :func:`hash_keep_mask` as int64 torch ops, then kept elements divided by
    ``1 - p'`` in x's dtype, dropped ones zero."""
    if _quantised_threshold(rate) <= 0:
        return x
    keep, p_eff = hash_keep_mask(seed_u32, x.shape, rate, device=x.device,
                                 batch_axis=batch_axis, batch_offset=batch_offset,
                                 batch_total=batch_total, place=place)
    return torch.where(keep, x / (1.0 - p_eff), torch.zeros((), dtype=x.dtype,
                                                            device=x.device))


def cheap_dropout(seed_u32: int, x: torch.Tensor, rate: float, *,
                  batch_axis: int = 0, batch_offset: int = 0,
                  batch_total: Optional[int] = None,
                  place: Optional[Dict[int, Tuple[int, int]]] = None) -> torch.Tensor:
    """Inverted dropout on activations by :func:`hash_keep_mask` (the same
    placement arguments): kept elements are divided by ``1 - p'`` in x's
    dtype, dropped ones are zero. Differentiable, with no mask kept
    (``hash_dropout.HashDropoutFunction``): a CUDA tensor runs the
    hash-dropout kernel, a CPU tensor :func:`cheap_dropout_reference`."""
    thresh = _quantised_threshold(rate)
    if thresh <= 0:
        return x
    site = blocked_site(x.shape, seed_u32, thresh, 1.0 - thresh / 256.0,
                        batch_axis=batch_axis, batch_offset=batch_offset,
                        batch_total=batch_total, place=place)
    return dropout(x, site, lambda t: cheap_dropout_reference(
        seed_u32, t, rate, batch_axis=batch_axis, batch_offset=batch_offset,
        batch_total=batch_total, place=place))


def hash_dropout_reference(seed_u32: int, x: torch.Tensor, rate: float,
                           batch_offset: int = 0) -> torch.Tensor:
    """The plain version of :func:`hash_dropout`, int64 torch ops."""
    if rate <= 0.0:
        return x
    idx = _global_index(x.shape, x.device, 0, int(batch_offset), None)
    keep = (_hash1_u32(int(seed_u32) & _U32, idx) >= _keep_threshold(rate)).view(x.shape)
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def hash_dropout(seed_u32: int, x: torch.Tensor, rate: float,
                 batch_offset: int = 0) -> torch.Tensor:
    """Inverted dropout with a full 32-bit threshold: element ``i`` of x
    (its linear index; with ``batch_offset``, its index in a global tensor
    of which x holds rows ``batch_offset ..`` of the leading axis) is kept
    iff ``_hash1_u32(seed, i) >= rate * 2**32``, and kept elements are
    divided by ``1 - rate`` in x's dtype. Differentiable as
    :func:`cheap_dropout` is: the kernel on a CUDA tensor,
    :func:`hash_dropout_reference` on a CPU one."""
    if rate <= 0.0:
        return x
    site = element_site(x.shape, seed_u32, _keep_threshold(rate), 1.0 - rate, batch_offset)
    return dropout(x, site, lambda t: hash_dropout_reference(seed_u32, t, rate,
                                                             batch_offset))


def multi_head_attention(
    q: torch.Tensor,                          # [B, L, H, D]
    k: torch.Tensor,                          # [B, S, H, D]
    v: torch.Tensor,                          # [B, S, H, D]
    key_mask: Optional[torch.Tensor] = None,  # [B, S] True = attend
    seg: Optional[torch.Tensor] = None,       # [B, L] segment ids (0 = pad)
    dropout_rate: float = 0.0,
    dropout_seed: Optional[int] = None,       # u32 seed of the keep mask
    batch_offset: int = 0,                    # global index of row 0
) -> torch.Tensor:
    """Scaled dot-product attention with key-padding or segment masking.
    Returns [B, L, H, D]. With ``seg``, tokens attend only within their own
    segment; query rows that may attend nothing emit exact zeros.
    ``dropout_rate`` with a ``dropout_seed`` drops attention probabilities
    by :func:`cheap_dropout` (the bits of :func:`hash_keep_mask`) over the
    [B, H, L, S] tensor, whose rows are rows ``batch_offset ..`` of the
    global batch."""
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
    if dropout_rate > 0.0 and dropout_seed is not None:
        probs = cheap_dropout(dropout_seed, probs, dropout_rate, batch_offset=batch_offset)
    return torch.einsum("bhls,bshd->blhd", probs, v)
