"""Tensor parallelism: the 'model'-sharded ``Linear`` and ``Embedding``.

In the JAX package TP is a layout: ``param_shard_spec`` splits the last
(feature) axis of every ``Dense`` kernel and ``Embed`` table over 'model',
and GSPMD keeps the math. Here a sharded module keeps its block of output
columns and computes them, then all-gathers them over 'model' (Megatron's
column-parallel layer with a gathered output), so everything after it
(attention, LayerNorm, BatchNorm, biases, the readout) runs replicated on
the 'model' ranks. The all-gather's backward sums the ranks' cotangent
shares and keeps this rank's columns (``comm.all_gather``), so each
rank's weight block gets the gradient of its own columns; the input
gradient is each rank's share, summed over 'model' where the trainer sums
the replicated parameters' gradients.

:func:`mark_sharded` turns the modules that :func:`.mesh.shard_params`
split into these kinds in place (the class changes, the parameter names
stay, so ``state_dict`` keys and ``convert.py`` are unchanged), and tells a
Switch MoE FFN whose expert stacks it split over 'expert' which axis they
lie on. :func:`dense` is the encoder's ``Dense(dtype=...)``, sharded or not.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn

from .comm import all_gather


class ShardedLinear(nn.Linear):
    """A ``Linear`` whose ``weight`` holds rows ``[i * out/n, (i+1) * out/n)``
    (output columns) on rank ``i`` of the ``tp_axis``; ``bias`` is whole."""

    tp_axis = None

    def forward(self, x: torch.Tensor, dtype: torch.dtype = None) -> torch.Tensor:
        dtype = dtype or x.dtype
        y = F.linear(x.to(dtype), self.weight.to(dtype))
        return all_gather(y, self.tp_axis, -1) + self.bias.to(dtype)


class ShardedEmbedding(nn.Embedding):
    """An ``Embedding`` whose table holds this rank's feature columns."""

    tp_axis = None

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return all_gather(F.embedding(ids, self.weight), self.tp_axis, -1)


def dense(lin: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax ``Dense(dtype=...)``: inputs and parameters promoted to the
    compute dtype; a sharded layer computes its columns and gathers them."""
    if isinstance(lin, ShardedLinear):
        return lin(x, dtype)
    return F.linear(x.to(dtype), lin.weight.to(dtype), lin.bias.to(dtype))


def mark_sharded(model: nn.Module, shards: Dict[str, "ParamShard"]) -> None:  # noqa: F821
    """Make the modules holding the split parameters compute with them."""
    for key, sh in shards.items():
        prefix, name = key.rsplit(".", 1)
        module = model.get_submodule(prefix)
        if sh.axis.names == ("model",):
            kind = {nn.Linear: ShardedLinear, nn.Embedding: ShardedEmbedding}.get(
                type(module))
            if kind is None or name != "weight":
                raise TypeError(f"{key}: no tensor-parallel form of "
                                f"{type(module).__name__}.{name}")
            module.__class__ = kind
            module.tp_axis = sh.axis
        elif sh.axis.names == ("expert",):
            module.ep_axis = sh.axis
        else:
            raise ValueError(f"{key}: no sharded form over {sh.axis.names}")
