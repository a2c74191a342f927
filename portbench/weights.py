"""The weights of a cell, made on the device from the seed.

One normal draw from a ``torch.Generator`` on the device for every
parameter at once, in f32 (the type the port holds its parameters in),
then scaled by leaf: embedding and position tables and the head 0.02,
other weight matrices 1 / sqrt(fan in), clipped at two standard
deviations; biases 0; LayerNorm scales 1. The program and the reference
are handed the same tensors by name.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def _std(name: str, shape: Tuple[int, ...]) -> float:
    if name.endswith("bias") or ("norm" in name and name.endswith("weight")):
        return 0.0
    if name.startswith(("embed.", "pos.", "cls.")):
        return 0.02
    return 1.0 / math.sqrt(shape[1])


def make(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: f32 tensor} for the parameter ``shapes`` (in their order)."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    sizes = [math.prod(s) for s in shapes.values()]
    flat = torch.randn(sum(sizes), generator=gen, device=device).clamp_(-2.0, 2.0)
    out, at = {}, 0
    for (name, shape), n in zip(shapes.items(), sizes):
        t = flat[at:at + n].view(shape)
        at += n
        std = _std(name, shape)
        if std == 0.0:
            t = torch.ones(shape, device=device) if not name.endswith("bias") \
                else torch.zeros(shape, device=device)
        else:
            t = t * std
        out[name] = t
    return out


def shapes_of(module: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    return {k: tuple(p.shape) for k, p in module.named_parameters()}
