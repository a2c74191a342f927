"""A plain forward of the token transformer, its L1 loss and its dropout.

What the port's ``SimpleTransformer`` computes for a ZINC regression cell,
written from its description, in plain torch: token plus position
embeddings; post-LN encoder layers (qkv, masked softmax attention, out
projection, add, LayerNorm, ReLU FFN, add, LayerNorm; LayerNorm eps 1e-6 in
f32); <bos> pooling (unpacked rows whose every first token is <bos>, else
the masked mean) or each packed segment's first position, LayerNorm, then a
linear head. The dense layers take their inputs and weights in the compute
precision (``bf16``: bfloat16, f32 accumulation), as the port's flax-style
``Dense(dtype=...)`` does; attention reads bf16 q, k, v and works in f32.

``fp8`` is the control: every dense layer's operands and q, k, v are
rounded to float8 e4m3 with a per-tensor scale (the next precision below
bf16), their gradients passed straight through.

Dropout, in training, at four sites a layer, with the counter hashes of the
port's kernels (frozen copies of ``ops/flash_attention.py`` ``_hash_u32``
and ``ops/attention.py`` ``_hash1_u32``): attention probabilities keep
where the hash of (batch*head, row, column) is at least p 2**32; the out
projection, the ReLU and the second FFN layer keep by bytes of one hash a
word in the blocked-byte layout (byte k of word w covers last-axis position
k W + w, W = ceil(S / 4)), at the byte threshold round(256 p). Kept values
are divided by 1 - p. Each forward draws its (attention, out, ReLU, ff2)
seeds for every layer in one ``torch.randint(0, 2**31 - 1, (layers, 4))``
from the generator it is handed, as the port's forward does.

Rows may be run in blocks (``row0``: the block's first row in the batch);
the masks are the rows of the whole batch's masks, so a blocked run gives
the batch's loss and gradients.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

U32 = 0xFFFFFFFF
LN_EPS = 1e-6
NEG = -1e30


@dataclass(frozen=True)
class Arch:
    d_model: int
    heads: int
    layers: int
    d_ff: int
    p_attn: float       # the attention site's rate (exact, u32 threshold)
    p_drop: float       # the other three sites' rate (byte threshold)


def _mul(x: torch.Tensor, c: int) -> torch.Tensor:
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & U32


def _fmix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul(x, 0x846CA68B)
    return x ^ (x >> 16)


def attn_keep(seed: int, bh0: int, bh: int, n: int, p: float, device) -> torch.Tensor:
    """[bh, n, n] keep mask of the attention site for batch*head rows
    ``bh0 ..``."""
    ar = dict(dtype=torch.int64, device=device)
    x = _mul(torch.arange(bh0, bh0 + bh, **ar)[:, None, None], 0x9E3779B1)
    x = x ^ _mul(torch.arange(n, **ar)[None, :, None], 0x85EBCA77)
    x = x ^ _mul(torch.arange(n, **ar)[None, None, :], 0xC2B2AE3D)
    x = (x + (seed & U32)) & U32
    return _fmix(x) >= min(int(p * 4294967296.0), 4294967295)


def byte_keep(seed: int, shape: Sequence[int], row0: int, p: float, device) -> torch.Tensor:
    """Keep mask of a blocked-byte site over a [rows, ...] block at row
    ``row0`` of the batch."""
    thresh = int(round(p * 256.0))
    *lead, s = shape
    w = (s + 3) // 4
    per_row = w
    for d in lead[1:]:
        per_row *= d
    idx = (torch.arange(lead[0] * per_row, dtype=torch.int64, device=device)
           + row0 * per_row) & U32
    x = _fmix((_mul(idx, 0x9E3779B1) + (seed & U32)) & U32).view(*lead, w)
    keep = torch.cat([((x >> b) & 0xFF) >= thresh for b in (0, 8, 16, 24)], dim=-1)
    return keep[..., :s]


class _Straight(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        s = x.detach().float().abs().amax().clamp(min=1e-30) / 448.0
        return ((x.float() / s).to(torch.float8_e4m3fn).float() * s).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        return g


def _low(x: torch.Tensor, precision: str) -> torch.Tensor:
    x = x.to(torch.bfloat16)
    return _Straight.apply(x) if precision == "fp8" else x


def dense(x, w, b, precision: str) -> torch.Tensor:
    return F.linear(_low(x, precision), _low(w, precision), b.to(torch.bfloat16))


def layer_norm(x, w, b) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), w, b, LN_EPS)


def _drop(x, keep, p) -> torch.Tensor:
    return torch.where(keep, x / (1.0 - round(p * 256.0) / 256.0), torch.zeros((), dtype=x.dtype,
                                                                            device=x.device))


def attention(q, k, v, seg, keep: Optional[torch.Tensor], p: float, precision: str):
    """q, k, v [B, L, H, D] bf16; seg [B, L] (0 = pad). Returns [B, L, H, D]
    bf16."""
    q, k, v = (_low(t, precision).float() for t in (q, k, v))
    d = q.shape[-1]
    logits = torch.einsum("blhd,bshd->bhls", q, k) / math.sqrt(d)
    allow = (seg[:, None, :, None] == seg[:, None, None, :]) & (seg[:, None, None, :] != 0)
    logits = torch.where(allow, logits, NEG)
    m = logits.amax(-1, keepdim=True)
    e = torch.exp(logits - m) * allow
    denom = e.sum(-1, keepdim=True)
    if keep is not None:
        e = torch.where(keep, e / (1.0 - p), torch.zeros((), device=e.device))
    out = torch.einsum("bhls,bshd->blhd", e, v) / torch.where(denom > 0, denom, 1.0).permute(
        0, 2, 1, 3)
    return out.to(torch.bfloat16)


def forward(w: Dict[str, torch.Tensor], arch: Arch, ids, seg, pos, *, readout: dict,
            seeds=None, row0: int = 0, precision: str = "bf16") -> torch.Tensor:
    """Predictions of a block of rows: [B, K] for packed rows
    (``readout["pos_bos"]``), [B] for unpacked ones (``readout["mask"]``).
    ``seeds``: the forward's [layers][4] dropout seeds, or None (eval)."""
    b, l = ids.shape
    h, d = arch.heads, arch.d_model
    x = w["embed.weight"][ids.long()] + w["pos.weight"][pos.long()]
    for i in range(arch.layers):
        p = f"layer_{i}."
        s = seeds[i] if seeds is not None else None
        qkv = dense(x, w[p + "qkv.weight"], w[p + "qkv.bias"], precision)
        q, k, v = (t.unflatten(-1, (h, d // h)) for t in qkv.split(d, dim=-1))
        keep = None if s is None or arch.p_attn <= 0 else attn_keep(
            s[0], (row0) * h, b * h, l, arch.p_attn, ids.device).view(b, h, l, l)
        a = attention(q, k, v, seg, keep, arch.p_attn, precision)
        a = dense(a.reshape(b, l, d), w[p + "out_proj.weight"], w[p + "out_proj.bias"], precision)
        if s is not None:
            a = _drop(a, byte_keep(s[1], a.shape, row0, arch.p_drop, a.device),
                      arch.p_drop)
        x = layer_norm(x + a.float(), w[p + "norm1.weight"], w[p + "norm1.bias"])
        y = F.relu(dense(x, w[p + "ff1.weight"], w[p + "ff1.bias"], precision))
        if s is not None:
            y = _drop(y, byte_keep(s[2], y.shape, row0, arch.p_drop, y.device),
                      arch.p_drop)
        y = dense(y, w[p + "ff2.weight"], w[p + "ff2.bias"], precision)
        if s is not None:
            y = _drop(y, byte_keep(s[3], y.shape, row0, arch.p_drop, y.device),
                      arch.p_drop)
        x = layer_norm(x + y.float(), w[p + "norm2.weight"], w[p + "norm2.bias"])
    if "pos_bos" in readout:
        idx = readout["pos_bos"].long()
        pooled = torch.gather(x, 1, idx[:, :, None].expand(-1, -1, d))
    else:
        maskf = readout["mask"].float()
        mean = (x * maskf[..., None]).sum(1) / maskf.sum(-1, keepdim=True).clamp(min=1.0)
        pooled = x[:, 0] if bool(readout["all_bos"]) else mean
    pooled = layer_norm(pooled, w["norm.weight"], w["norm.bias"])
    return F.linear(pooled, w["cls.weight"], w["cls.bias"]).squeeze(-1)


def param_shapes(arch: Arch, vocab: int, max_pos: int, classes: int = 1):
    """{name: shape} of the model's parameters, in the port's order."""
    d, f = arch.d_model, arch.d_ff
    out = {"embed.weight": (vocab, d), "pos.weight": (max_pos, d)}
    for i in range(arch.layers):
        p = f"layer_{i}."
        out.update({p + "qkv.weight": (3 * d, d), p + "qkv.bias": (3 * d,),
                    p + "out_proj.weight": (d, d), p + "out_proj.bias": (d,),
                    p + "norm1.weight": (d,), p + "norm1.bias": (d,),
                    p + "ff1.weight": (f, d), p + "ff1.bias": (f,),
                    p + "ff2.weight": (d, f), p + "ff2.bias": (d,),
                    p + "norm2.weight": (d,), p + "norm2.bias": (d,)})
    out.update({"norm.weight": (d,), "norm.bias": (d,), "cls.weight": (classes, d),
                "cls.bias": (classes,)})
    return out


def draw_seeds(generator: torch.Generator, layers: int):
    """One forward's dropout seeds, as the port's forward draws them."""
    return torch.randint(0, 2**31 - 1, (layers, 4), generator=generator).tolist()

