"""Masked reductions over padded node/token axes.

Port of ``glearning_benchmark_tpu/ops/segment.py``: the graph models' pools
(PyG's ``global_{add,mean,max}_pool`` in the reference) as reductions over
the padded node axis of a dense batch, counting only ``mask == True``
positions. ``x`` is [..., N, F] and ``mask`` [..., N].
"""

from __future__ import annotations

import torch


def masked_sum(x: torch.Tensor, mask: torch.Tensor, axis: int = 1) -> torch.Tensor:
    return (x * mask.unsqueeze(-1).to(x.dtype)).sum(dim=axis)


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """The sum over valid positions over their count, clipped at 1 (an
    all-pad row gives zeros)."""
    m = mask.unsqueeze(-1).to(x.dtype)
    return (x * m).sum(dim=axis) / m.sum(dim=axis).clamp(min=1.0)


def masked_max(x: torch.Tensor, mask: torch.Tensor, axis: int = 1) -> torch.Tensor:
    """The max over valid positions; pad positions hold the dtype's
    ``finfo.min``. Tied maxima share the gradient equally, as in JAX."""
    fill = torch.finfo(x.dtype).min
    return torch.where(mask.unsqueeze(-1), x, fill).amax(dim=axis)
