"""Weights across frameworks: flax parameter trees <-> torch ``state_dict``.

No JAX counterpart: this module is the bridge that lets the port serve the
JAX package's checkpoints and lets the JAX package read the port's. The
module names are the flax ones, so the mapping is mechanical:

- ``Dense``: ``kernel`` [in, out] <-> ``Linear.weight`` [out, in]; ``bias``
  stays ``bias``;
- ``LayerNorm`` (modules named ``norm*``): ``scale`` <-> ``weight``;
- ``Embed`` (modules ``embed`` and ``pos``): ``embedding`` <-> ``weight``.

A flax path ``layer_0/qkv/kernel`` becomes the key ``layer_0.qkv.weight``.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch
from torch import nn

from .train.checkpoint import _flatten, _unflatten

_EMBEDS = ("embed", "pos")


def _as_tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.array(leaf))


def params_from_flax(params: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested flax ``params`` tree (numpy arrays or torch tensors, as the
    checkpoint readers return it) -> torch ``state_dict``."""
    out = {}
    for path, leaf in _flatten(params).items():
        *mod, name = path.split("/")
        t = _as_tensor(leaf)
        if name == "kernel":
            name, t = "weight", t.transpose(0, 1)
        elif name in ("scale", "embedding"):
            name = "weight"
        elif name != "bias":
            raise ValueError(f"unknown flax parameter {path!r}")
        out[".".join(mod + [name])] = t.contiguous()
    return out


def params_to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """torch ``state_dict`` -> nested flax ``params`` tree of CPU tensors
    (``train.checkpoint.save_checkpoint`` writes it)."""
    flat = {}
    for key, t in state_dict.items():
        *mod, name = key.split(".")
        t = t.detach().cpu()
        if name == "weight":
            if mod[-1] in _EMBEDS:
                name = "embedding"
            elif mod[-1].startswith("norm"):
                name = "scale"
            else:
                name, t = "kernel", t.transpose(0, 1)
        elif name != "bias":
            raise ValueError(f"unknown torch parameter {key!r}")
        flat["/".join(mod + [name])] = t.contiguous()
    return _unflatten(flat)


def load_flax_params(model: nn.Module, params: Dict[str, Any]) -> None:
    """Load a flax ``params`` tree into ``model``. Every parameter must be
    present with its shape, and no extra one may be; a floating parameter
    takes only a floating leaf (a uint leaf whose dtype sidecar was lost is
    refused, never cast)."""
    state = params_from_flax(params)
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    extra = sorted(set(state) - set(own))
    if missing or extra:
        raise ValueError(f"checkpoint params do not fit the model: missing "
                         f"{missing}, unexpected {extra}")
    for key, target in own.items():
        leaf = state[key]
        if leaf.shape != target.shape:
            raise ValueError(f"{key}: checkpoint shape {tuple(leaf.shape)}, "
                             f"model shape {tuple(target.shape)}")
        if target.is_floating_point() and not leaf.is_floating_point():
            raise TypeError(f"{key}: checkpoint leaf is {leaf.dtype} but the "
                            f"parameter is {target.dtype}; refusing to cast "
                            "(was the checkpoint's .json sidecar lost?)")
    model.load_state_dict(state)
