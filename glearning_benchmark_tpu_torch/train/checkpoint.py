"""Checkpoint save/restore: the JAX package's ``.npz`` + ``.json`` pair.

Port of ``glearning_benchmark_tpu/train/checkpoint.py``. Checkpoints move
both ways between the two packages: arrays are stored flat by tree path
(``params/layer_0/qkv/kernel``) in the flax layout (``convert.py`` maps it
to and from a torch ``state_dict``), and the JSON sidecar holds the
metadata, including ``ext_dtypes`` for leaves numpy cannot store natively.

Two differences from the reference, both deliberate:

- bf16 leaves come back without ``ml_dtypes``: a leaf recorded as
  ``bfloat16`` is read as its ``uint16`` view and reinterpreted with
  ``torch.Tensor.view(torch.bfloat16)``. Leaves come back as CPU torch
  tensors.
- Only the dtypes listed in ``_EXT_DTYPES`` are restored from the sidecar;
  an unknown name raises. A uint leaf without a sidecar entry stays uint,
  and ``convert.load_flax_params`` refuses it where it meets a float
  parameter, instead of casting the raw bits to numbers.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

_EXT_DTYPES = {"bfloat16": (np.uint16, torch.bfloat16)}


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif tree is not None:
        out[prefix.rstrip("/")] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    tree: Dict[str, Any] = {}
    for key, v in flat.items():
        parts = key.split("/")
        cur = tree
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return tree


def serving_meta(model_name: str, bundle) -> Dict[str, Any]:
    """JSON block embedded in checkpoints so ``serve.Predictor`` can rebuild
    the model and its tokenizers without the training corpus."""
    return {
        "model_name": model_name,
        "task": bundle.task,
        "kind": bundle.kind,
        "num_classes": int(bundle.num_classes),
        "vocab_size": int(bundle.vocab_size),
        "q_token_id": None if bundle.q_token_id is None else int(bundle.q_token_id),
        "in_dim": int(bundle.in_dim),
        "meta": {k: (int(v) if isinstance(v, (int, np.integer)) else v)
                 for k, v in bundle.meta.items()},
    }


def _to_numpy(leaf) -> tuple:
    """(array numpy can store, ext dtype name or None)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return leaf.numpy(), None
    return np.asarray(leaf), None


def save_checkpoint(path: str, state: Dict[str, Any]) -> None:
    """Write ``<path>.npz`` + ``<path>.json``. ``state`` holds nested dicts of
    torch tensors or numpy arrays under ``params`` / ``batch_stats`` /
    ``opt_state``, and JSON metadata under ``epoch``, ``best_val``,
    ``config``, ``vocab`` and ``serve``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    arrays = {}
    ext_dtypes = {}
    for section in ("params", "batch_stats", "opt_state"):
        if state.get(section) is not None:
            for k, leaf in _flatten(state[section], f"{section}/").items():
                arrays[k], ext = _to_numpy(leaf)
                if ext is not None:
                    ext_dtypes[k] = ext
    meta: Dict[str, Any] = {}
    if ext_dtypes:
        meta["ext_dtypes"] = ext_dtypes
    for k in ("epoch", "best_val", "config", "vocab", "serve"):
        if state.get(k) is not None:
            meta[k] = state[k]
    np.savez_compressed(path + ".npz", **arrays)
    with open(path + ".json", "w") as f:
        json.dump(meta, f)


def load_checkpoint(path: str) -> Optional[Dict[str, Any]]:
    """Read a checkpoint pair (``path`` is the stem or the ``.npz``). Returns
    None when no ``.npz`` exists; leaves come back as CPU torch tensors."""
    if path.endswith(".npz"):
        path = path[: -len(".npz")]
    if not os.path.isfile(path + ".npz"):
        return None
    with np.load(path + ".npz") as z:
        flat = {k: z[k] for k in z.files}
    meta: Dict[str, Any] = {}
    if os.path.isfile(path + ".json"):
        with open(path + ".json") as f:
            meta = json.load(f)
    ext = meta.pop("ext_dtypes", {})
    tensors = {}
    for k, arr in flat.items():
        name = ext.get(k)
        if name is None:
            tensors[k] = torch.from_numpy(arr)
            continue
        if name not in _EXT_DTYPES:
            raise ValueError(f"checkpoint leaf {k!r} has dtype {name!r}, "
                             f"which this reader does not restore")
        store, torch_dtype = _EXT_DTYPES[name]
        if arr.dtype != store:
            raise ValueError(f"checkpoint leaf {k!r}: {name} stored as "
                             f"{arr.dtype}, expected {np.dtype(store)}")
        tensors[k] = torch.from_numpy(arr.view(np.int16)).view(torch_dtype)
    tree = _unflatten(tensors)
    return {
        "params": tree.get("params"),
        "batch_stats": tree.get("batch_stats"),
        "opt_state": tree.get("opt_state"),
        **meta,
    }
