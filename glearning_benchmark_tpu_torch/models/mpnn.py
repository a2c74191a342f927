"""GIN message-passing network on dense padded graph batches, in PyTorch.

Port of ``glearning_benchmark_tpu/models/mpnn.py``: ``MaskedBatchNorm``,
``GINLayer`` (GIN, or GINE factored by edge type) and ``MPNN``. Module and
parameter names follow the flax ones (``node_encoder``, ``conv_{i}/{eps,
edge_emb,mlp1,mlp_bn,mlp2}``, ``bn_{i}``, ``output_head``) so
``convert.py`` maps checkpoints mechanically; a BatchNorm's running mean
and variance are registered buffers, the flax ``batch_stats`` collection.

Neighbour aggregation is a batched dense product ``A @ H`` ([B, N, N] x
[B, N, F]): the graphs have at most ~64 nodes. Numerics follow flax: the
parameters are f32; the aggregation and the ``Dense`` layers of the GIN
MLP compute in ``compute_dtype``, and where flax asks for an f32 result of
bf16 operands (``preferred_element_type``) the port multiplies the
bf16-rounded operands in f32; BatchNorms, residuals, pooling and the head
run in f32.

Dropout runs only in ``train()`` mode, through
:func:`..ops.attention.hash_dropout`, with seeds drawn on the host from the
``torch.Generator`` the caller passes (flax draws threefry masks, which the
port does not reproduce: dropout bits are not a conformance surface).

Under data parallelism a forward is handed its ``shard`` of the global
batch (``parallel.mesh.BatchShard``): the dropout masks are the rank's rows
of the global ones, and a training BatchNorm's statistics are all-reduced
over the shard's group, so they cover every valid node of the global
batch, as GSPMD computes them in the reference, and every rank updates the
same running statistics.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import hash_dropout
from ..ops.segment import masked_max, masked_mean, masked_sum
from ..parallel.dist import global_sum
from .transformer import _dense, _lecun_normal_

_SEED_MAX = 2**31 - 1


def _cdtype(compute_dtype: str) -> torch.dtype:
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"compute_dtype must be float32 or bfloat16, "
                         f"got {compute_dtype!r}")
    return torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``einsum('bij,bjf->bif', a, b, preferred_element_type=f32)``: the
    operands as they are (bf16 or f32), the product and its sums in f32."""
    return torch.bmm(a.float(), b.float())


def _drop(x: torch.Tensor, rate: float, seed: Optional[int], shard=None) -> torch.Tensor:
    if seed is None:
        return x
    return hash_dropout(seed, x, rate, 0 if shard is None else shard.start)


def pool(h: torch.Tensor, mask: torch.Tensor, pooling: str) -> torch.Tensor:
    if pooling == "mean":
        return masked_mean(h, mask)
    if pooling == "add":
        return masked_sum(h, mask)
    if pooling == "max":
        return masked_max(h, mask)
    raise ValueError(f"unknown pooling {pooling!r}")


class MaskedBatchNorm(nn.Module):
    """BatchNorm1d over the flattened (batch, node) axis, masked to valid
    nodes, with running statistics (torch momentum convention: 0.1).

    In ``train()`` mode it normalises by the batch statistics of the valid
    nodes (biased variance) and updates the running mean and the running
    unbiased variance ``var * n / max(n - 1, 1)`` from the same statistics;
    in ``eval()`` mode it normalises by the running statistics. With a
    ``shard`` the sums behind the batch statistics (valid nodes, their sum,
    then their centred sum of squares) are all-reduced over its group,
    differentiably."""

    def __init__(self, num_features: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x: torch.Tensor, mask: torch.Tensor, shard=None) -> torch.Tensor:
        # x: [B, N, F], mask: [B, N]
        if self.training:
            m = mask.to(x.dtype)[..., None]
            sums = global_sum(torch.cat([(x * m).sum(dim=(0, 1)), m.sum()[None]]), shard)
            n = sums[-1].clamp(min=1.0)
            mean = sums[:-1] / n
            var = global_sum((((x - mean) ** 2) * m).sum(dim=(0, 1)), shard) / n
            with torch.no_grad():
                mom = self.momentum
                unbiased = var * n / (n - 1.0).clamp(min=1.0)
                self.running_mean.copy_((1 - mom) * self.running_mean + mom * mean)
                self.running_var.copy_((1 - mom) * self.running_var + mom * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean) * torch.rsqrt(var + self.eps)
        return y * self.weight + self.bias


class GINLayer(nn.Module):
    """One GIN convolution: MLP((1 + eps) h + A @ h) with the inner MLP
    mlp1 -> MaskedBatchNorm (f32) -> ReLU -> Dropout -> mlp2.

    With ``num_edge_types`` > 0 and an ``etype`` matrix, messages are
    edge-featured (GINE): m_i = sum_j ReLU(h_j + e_ij), factored by type
    into sum_t A_t @ ReLU(h + emb_t), never materialising [B, N, N, F]."""

    def __init__(self, in_dim: int, hidden: int, dropout: float = 0.0,
                 dtype: torch.dtype = torch.float32, num_edge_types: int = 0):
        super().__init__()
        self.dropout = dropout
        self.dtype = dtype
        self.num_edge_types = num_edge_types
        self.eps = nn.Parameter(torch.zeros(()))
        if num_edge_types > 0:
            self.edge_emb = nn.Parameter(torch.zeros(num_edge_types, in_dim))
        self.mlp1 = nn.Linear(in_dim, hidden)
        self.mlp_bn = MaskedBatchNorm(hidden)
        self.mlp2 = nn.Linear(hidden, hidden)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        nn.init.zeros_(self.eps)
        if self.num_edge_types > 0:
            nn.init.normal_(self.edge_emb, 0.0, 0.02, generator=generator)
        _lecun_normal_(self.mlp1, generator)
        _lecun_normal_(self.mlp2, generator)

    def forward(self, h: torch.Tensor, adj: torch.Tensor, mask: torch.Tensor,
                etype: Optional[torch.Tensor] = None,
                seed: Optional[int] = None, shard=None) -> torch.Tensor:
        """h [B, N, F] f32, adj [B, N, N] f32 -> [B, N, hidden] f32.
        ``seed`` turns the MLP's dropout on; ``shard`` places the rows in the
        global batch."""
        if self.num_edge_types > 0 and etype is not None:
            msg = torch.zeros(h.shape, dtype=torch.float32, device=h.device)
            hc = h.to(self.dtype)
            for t in range(1, self.num_edge_types + 1):
                a_t = (etype == t).to(self.dtype)
                msg = msg + _bmm_f32(a_t, F.relu(hc + self.edge_emb[t - 1].to(self.dtype)))
            agg = (1.0 + self.eps) * h + msg
        else:
            agg = (1.0 + self.eps) * h + _bmm_f32(adj.to(self.dtype), h.to(self.dtype))
        y = _dense(self.mlp1, agg, self.dtype)
        y = F.relu(self.mlp_bn(y.float(), mask, shard))
        y = _drop(y, self.dropout, seed, shard)
        return _dense(self.mlp2, y, self.dtype).float()


class MPNN(nn.Module):
    """GIN network: node_encoder, then per layer conv_i -> bn_i -> ReLU,
    padded slots zeroed, a masked pool and the output head.

    ``generator`` seeds the initial parameters, which follow flax's inits:
    lecun-normal ``Dense`` kernels, zero biases, ``eps`` 0, ``edge_emb``
    N(0, 0.02), BatchNorm scale 1 and bias 0."""

    def __init__(self, in_dim: int = 1, hidden_dim: int = 64, num_layers: int = 3,
                 dropout: float = 0.0, pooling: str = "mean", num_classes: int = 2,
                 task: str = "cycle_check", compute_dtype: str = "float32",
                 edge_features: bool = False, num_edge_types: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if pooling not in ("mean", "add", "max"):
            raise ValueError(f"unknown pooling {pooling!r}")
        cdtype = _cdtype(compute_dtype)
        self.num_layers = num_layers
        self.dropout = dropout
        self.pooling = pooling
        self.task = task
        self.edge_features = edge_features
        self.compute_dtype = compute_dtype
        self.node_encoder = nn.Linear(in_dim, hidden_dim)
        for i in range(num_layers):
            self.add_module(f"conv_{i}", GINLayer(
                hidden_dim, hidden_dim, dropout, cdtype,
                num_edge_types=num_edge_types if edge_features else 0))
            self.add_module(f"bn_{i}", MaskedBatchNorm(hidden_dim))
        self.output_head = nn.Linear(hidden_dim, 1 if task == "zinc" else num_classes)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        _lecun_normal_(self.node_encoder, generator)
        for i in range(self.num_layers):
            getattr(self, f"conv_{i}").reset_parameters(generator)
        _lecun_normal_(self.output_head, generator)

    def forward(self, node_feat: torch.Tensor, adj: torch.Tensor, mask: torch.Tensor,
                etype: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                shard=None) -> torch.Tensor:
        """node_feat [B, N, F], adj [B, N, N] f32, mask [B, N] bool -> logits
        [B, C] ([B] for zinc). ``etype`` [B, N, N] edge types (0 = none) is
        used only with ``edge_features``. In ``train()`` mode with dropout,
        ``generator`` (a CPU generator) gives the forward's seeds. ``shard``
        places the rows in the global batch (module docstring)."""
        seeds: Sequence[Optional[int]] = [None] * self.num_layers
        if self.training and self.dropout > 0.0:
            if generator is None:
                raise ValueError("a training forward with dropout needs the "
                                 "generator its seeds are drawn from")
            seeds = torch.randint(0, _SEED_MAX, (self.num_layers,),
                                  generator=generator).tolist()
        etype = etype if self.edge_features else None
        h = self.node_encoder(node_feat)
        for i, seed in enumerate(seeds):
            h = getattr(self, f"conv_{i}")(h, adj, mask, etype, seed, shard)
            h = F.relu(getattr(self, f"bn_{i}")(h, mask, shard))
        # zero padded slots before pooling (BN shifts them off zero)
        h = h * mask[..., None].to(h.dtype)
        out = self.output_head(pool(h, mask, self.pooling))
        return out.squeeze(-1) if self.task == "zinc" else out
