"""GPS: hybrid local-MPNN + global-attention graph transformer, in PyTorch.

Port of ``glearning_benchmark_tpu/models/gps.py``. Each layer:

    h = BN(h + Dropout(LocalGIN(h, A)))           bn_local
    h = BN(h + Dropout(attn_out(MHA(q, k, v))))   bn_attn
    h = BN(h + Dropout(ff2(Dropout(ReLU(ff1(h))))))   bn_ff (2x expansion)

Global attention is full masked self-attention over the node axis of each
padded graph: :func:`..ops.attention.multi_head_attention` (the plain
version of the JAX package's XLA attention, not the flash kernel) with
``key_mask = mask``, whose attention-probability dropout is the JAX
package's ``hash_keep_mask`` stream bit for bit. As in the reference, pad
query rows are not zeroed; no logit depends on them, because BatchNorm
statistics, ``A @ h`` and pooling are all masked. Parameter names follow
flax (``node_encoder``, ``gps_{i}/{local_gin,bn_local,q,k,v,attn_out,
bn_attn,ff1,ff2,bn_ff}``, ``post_mp``). The q/k/v/attn_out ``Dense`` layers
and the local GIN compute in ``compute_dtype``; the FFN, BatchNorms and
residuals in f32. The other dropout sites use
:func:`..ops.attention.hash_dropout`; a ``shard`` of the global batch
places every mask and reduces every BatchNorm as in ``models/mpnn.py``.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import multi_head_attention
from .mpnn import _SEED_MAX, GINLayer, MaskedBatchNorm, _cdtype, _drop, pool
from .transformer import _dense, _lecun_normal_

# dropout sites of a layer, in the order of a layer's seeds
_SITES = ("local_gin", "local", "attn_probs", "attn_out", "ff_relu", "ff2")


class GPSLayer(nn.Module):
    def __init__(self, dim: int, n_heads: int = 4, dropout: float = 0.0,
                 attn_dropout: float = 0.1, dtype: torch.dtype = torch.float32,
                 num_edge_types: int = 0):
        super().__init__()
        if dim % n_heads:
            raise ValueError(f"dim {dim} is not a multiple of n_heads {n_heads}")
        self.n_heads = n_heads
        self.dropout = dropout
        self.attn_dropout = attn_dropout
        self.dtype = dtype
        self.local_gin = GINLayer(dim, dim, dropout, dtype, num_edge_types)
        self.bn_local = MaskedBatchNorm(dim)
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.attn_out = nn.Linear(dim, dim)
        self.bn_attn = MaskedBatchNorm(dim)
        self.ff1 = nn.Linear(dim, 2 * dim)
        self.ff2 = nn.Linear(2 * dim, dim)
        self.bn_ff = MaskedBatchNorm(dim)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.local_gin.reset_parameters(generator)
        for lin in (self.q, self.k, self.v, self.attn_out, self.ff1, self.ff2):
            _lecun_normal_(lin, generator)

    def forward(self, h: torch.Tensor, adj: torch.Tensor, mask: torch.Tensor,
                etype: Optional[torch.Tensor] = None,
                seeds: Optional[Sequence[int]] = None, shard=None) -> torch.Tensor:
        """h [B, N, d] f32 -> [B, N, d] f32. ``seeds`` (one per site of
        ``_SITES``) turns dropout on; ``shard`` places the rows in the
        global batch."""
        s = dict(zip(_SITES, seeds if seeds is not None else (None,) * len(_SITES)))
        b, n, d = h.shape
        hd = d // self.n_heads
        row0 = 0 if shard is None else shard.start
        local = self.local_gin(h, adj, mask, etype, s["local_gin"], shard)
        local = _drop(local, self.dropout, s["local"], shard)
        h = self.bn_local(h + local, mask, shard)

        q, k, v = (_dense(lin, h, self.dtype).reshape(b, n, self.n_heads, hd)
                   for lin in (self.q, self.k, self.v))
        p_attn = self.attn_dropout if s["attn_probs"] is not None else 0.0
        attn = multi_head_attention(q, k, v, key_mask=mask, dropout_rate=p_attn,
                                    dropout_seed=s["attn_probs"],
                                    batch_offset=row0).reshape(b, n, d)
        attn = _dense(self.attn_out, attn, self.dtype).float()
        attn = _drop(attn, self.dropout, s["attn_out"], shard)
        h = self.bn_attn(h + attn, mask, shard)

        y = _drop(F.relu(self.ff1(h)), self.dropout, s["ff_relu"], shard)
        y = _drop(self.ff2(y), self.dropout, s["ff2"], shard)
        return self.bn_ff(h + y, mask, shard)


class GPSModel(nn.Module):
    """node_encoder, ``num_layers`` GPS layers, padded slots zeroed, the
    masked pool (``mean``, ``add``, else max) and ``post_mp``. Inits as in
    ``models/mpnn.py``."""

    def __init__(self, in_dim: int = 1, dim: int = 32, num_layers: int = 4,
                 n_heads: int = 4, dropout: float = 0.0, attn_dropout: float = 0.1,
                 pooling: str = "mean", num_classes: int = 2, task: str = "cycle_check",
                 compute_dtype: str = "float32", edge_features: bool = False,
                 num_edge_types: int = 4, generator: Optional[torch.Generator] = None):
        super().__init__()
        cdtype = _cdtype(compute_dtype)
        self.num_layers = num_layers
        self.dropout = dropout
        self.attn_dropout = attn_dropout
        self.pooling = pooling if pooling in ("mean", "add") else "max"
        self.task = task
        self.edge_features = edge_features
        self.compute_dtype = compute_dtype
        self.node_encoder = nn.Linear(in_dim, dim)
        for i in range(num_layers):
            self.add_module(f"gps_{i}", GPSLayer(
                dim, n_heads, dropout, attn_dropout, cdtype,
                num_edge_types=num_edge_types if edge_features else 0))
        self.post_mp = nn.Linear(dim, 1 if task == "zinc" else num_classes)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _lecun_normal_(self.node_encoder, generator)
        for i in range(self.num_layers):
            getattr(self, f"gps_{i}").reset_parameters(generator)
        _lecun_normal_(self.post_mp, generator)

    def forward(self, node_feat: torch.Tensor, adj: torch.Tensor, mask: torch.Tensor,
                etype: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                shard=None) -> torch.Tensor:
        """As ``MPNN.forward``."""
        seeds: Sequence[Optional[Sequence[int]]] = [None] * self.num_layers
        if self.training and max(self.dropout, self.attn_dropout) > 0.0:
            if generator is None:
                raise ValueError("a training forward with dropout needs the "
                                 "generator its seeds are drawn from")
            seeds = torch.randint(0, _SEED_MAX, (self.num_layers, len(_SITES)),
                                  generator=generator).tolist()
        etype = etype if self.edge_features else None
        h = self.node_encoder(node_feat)
        for i, layer_seeds in enumerate(seeds):
            h = getattr(self, f"gps_{i}")(h, adj, mask, etype, layer_seeds, shard)
        h = h * mask[..., None].to(h.dtype)
        out = self.post_mp(pool(h, mask, self.pooling))
        return out.squeeze(-1) if self.task == "zinc" else out
