"""Weights across frameworks: flax parameter trees <-> torch ``state_dict``.

No JAX counterpart: this module is the bridge that lets the port serve the
JAX package's checkpoints and lets the JAX package read the port's. The
module names are the flax ones, so the mapping is mechanical:

- ``Dense``: ``kernel`` [in, out] <-> ``Linear.weight`` [out, in]; ``bias``
  stays ``bias``;
- ``LayerNorm`` (modules named ``norm*``) and the graph models'
  ``MaskedBatchNorm`` (modules named ``bn*`` and ``mlp_bn``): ``scale`` <->
  ``weight``;
- ``Embed`` (modules ``embed`` and ``pos``): ``embedding`` <-> ``weight``;
- GIN's scalar ``eps`` and GINE's ``edge_emb`` [types, F] keep their names
  and layout, and so do the Switch MoE expert stacks ``moe/{w1,b1,w2,b2}``
  (leading expert axis); the MoE ``router`` is a ``Dense``.

A flax path ``layer_0/qkv/kernel`` becomes the key ``layer_0.qkv.weight``.
The ``batch_stats`` collection (a BatchNorm's running ``mean`` and ``var``)
maps to the registered buffers ``running_mean`` and ``running_var``:
``bn_0/mean`` <-> ``bn_0.running_mean``.

Optimizer state crosses too. The JAX trainer saves ``opt_state`` as the
flat leaves of its optax chain state under the keys ``"000000"``,
``"000001"``, ... and restores them by position: Adam's step count, the
first moments of every parameter in the order ``jax.tree.leaves`` walks the
flax tree (dict keys sorted at each level), the second moments in the same
order, and, when a learning-rate schedule is set, the schedule's own step
count. :func:`opt_state_from_torch` writes that layout from the port's
optimizer and :func:`opt_state_to_torch` reads it back, so a checkpoint of
either trainer resumes in the other.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .train.checkpoint import _flatten, _unflatten

_EMBEDS = ("embed", "pos")
# parameters stored under the same name and layout in both packages
_AS_IS = ("eps", "edge_emb", "w1", "b1", "w2", "b2")
_STATS = {"mean": "running_mean", "var": "running_var"}


def _is_norm(module: str) -> bool:
    """LayerNorm (``norm*``) or MaskedBatchNorm (``bn*``, ``mlp_bn``)."""
    return module.startswith(("norm", "bn")) or module == "mlp_bn"


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
        elif name not in ("bias",) + _AS_IS:
            raise ValueError(f"unknown flax parameter {path!r}")
        out[".".join(mod + [name])] = t.contiguous()
    return out


def flax_path(key: str) -> Tuple[Tuple[str, ...], bool]:
    """(the flax path of a torch parameter's ``state_dict`` key, whether its
    flax leaf is the transpose of the tensor): ``layer_0.qkv.weight`` ->
    (("layer_0", "qkv", "kernel"), True)."""
    *mod, name = key.split(".")
    transposed = False
    if name == "weight":
        if mod[-1] in _EMBEDS:
            name = "embedding"
        elif _is_norm(mod[-1]):
            name = "scale"
        else:
            name, transposed = "kernel", True
    elif name not in ("bias",) + _AS_IS:
        raise ValueError(f"unknown torch parameter {key!r}")
    return tuple(mod) + (name,), transposed


def params_to_flax(state_dict: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """torch ``state_dict`` -> nested flax ``params`` tree of CPU tensors
    (``train.checkpoint.save_checkpoint`` writes it). BatchNorm running
    statistics are left out: :func:`batch_stats_to_flax` takes them."""
    flat = {}
    for key, t in state_dict.items():
        if key.rsplit(".", 1)[-1] in _STATS.values():
            continue
        path, transposed = flax_path(key)
        t = t.detach().cpu()
        flat["/".join(path)] = (t.transpose(0, 1) if transposed else t).contiguous()
    return _unflatten(flat)


def batch_stats_to_flax(state_dict: Dict[str, torch.Tensor]) -> Optional[Dict[str, Any]]:
    """The running statistics of a torch ``state_dict`` -> the flax
    ``batch_stats`` tree of CPU tensors, or None when there are none."""
    names = {v: k for k, v in _STATS.items()}
    flat = {}
    for key, t in state_dict.items():
        *mod, name = key.split(".")
        if name in names:
            flat["/".join(mod + [names[name]])] = t.detach().cpu().contiguous()
    return _unflatten(flat) if flat else None


def batch_stats_from_flax(batch_stats: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """A flax ``batch_stats`` tree -> the ``running_mean``/``running_var``
    entries of a torch ``state_dict``."""
    out = {}
    for path, leaf in _flatten(batch_stats).items():
        *mod, name = path.split("/")
        if name not in _STATS:
            raise ValueError(f"unknown flax batch statistic {path!r}")
        out[".".join(mod + [_STATS[name]])] = _as_tensor(leaf).contiguous()
    return out


def load_flax_params(model: nn.Module, params: Dict[str, Any],
                     batch_stats: Optional[Dict[str, Any]] = None) -> None:
    """Load a flax ``params`` tree, and a ``batch_stats`` tree when given,
    into ``model``. Every parameter (and, with ``batch_stats``, every
    running statistic) must be present with its shape, and no extra one
    may be; without ``batch_stats`` the model keeps its own running
    statistics. A floating parameter takes only a floating leaf (a uint
    leaf whose dtype sidecar was lost is refused, never cast)."""
    state = params_from_flax(params)
    own = dict(model.named_parameters())
    if batch_stats is not None:
        state.update(batch_stats_from_flax(batch_stats))
        own.update(model.named_buffers())
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
    model.load_state_dict(state, strict=False)


def _flax_leaf_order(flat: Dict[str, Any]) -> List[str]:
    """Paths of a flattened flax tree in ``jax.tree.leaves`` order."""
    return sorted(flat, key=lambda path: path.split("/"))


def opt_state_from_torch(state: Dict[str, Any], names: List[str],
                         with_schedule: bool) -> Dict[str, torch.Tensor]:
    """``ClippedAdamW.state()`` (moments listed like ``names``, the
    parameters' ``state_dict`` keys) -> the JAX trainer's ``opt_state``
    section: ``{"000000": count, mu leaves, nu leaves[, schedule count]}``."""
    leaves = [torch.tensor(int(state["count"]), dtype=torch.int32)]
    for moments in (state["mu"], state["nu"]):
        flat = _flatten(params_to_flax(dict(zip(names, moments))))
        leaves += [flat[path] for path in _flax_leaf_order(flat)]
    if with_schedule:
        leaves.append(torch.tensor(int(state["schedule_count"]),
                                   dtype=torch.int32))
    return {f"{i:06d}": leaf for i, leaf in enumerate(leaves)}


def opt_state_to_torch(saved: Dict[str, Any], names: List[str],
                       with_schedule: bool) -> Optional[Dict[str, Any]]:
    """The inverse: a checkpoint's ``opt_state`` section -> a state for
    ``ClippedAdamW.load_state`` with moments listed like ``names``. Returns
    None when the number of leaves does not fit this optimizer (another
    model, or a schedule on one side only); the caller then starts a fresh
    optimizer state, as the JAX trainer does."""
    leaves = [_as_tensor(saved[k]) for k in sorted(saved)]
    n = len(names)
    if len(leaves) != 1 + 2 * n + int(with_schedule):
        return None
    # the flax paths of these parameters, in leaf order
    flat = _flatten(params_to_flax({k: torch.empty(0, 0) if k.endswith("weight")
                                    else torch.empty(0) for k in names}))
    paths = _flax_leaf_order(flat)
    state: Dict[str, Any] = {"count": int(leaves[0]),
                             "schedule_count": int(leaves[-1]) if with_schedule else 0}
    for which, chunk in (("mu", leaves[1:1 + n]), ("nu", leaves[1 + n:1 + 2 * n])):
        by_key = params_from_flax(_unflatten(dict(zip(paths, chunk))))
        state[which] = [by_key[k] for k in names]
    return state
