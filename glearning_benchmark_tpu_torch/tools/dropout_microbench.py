"""Dropout microbench of the port: how to draw and apply the residual/FFN
dropout mask (the root ``tools/dropout_microbench.py`` on the port's ops).

    python -m glearning_benchmark_tpu_torch.tools.dropout_microbench \
        [--d-model 2048] [--batch 16] [--len 1024] [--iters 50] [--device cpu]

It times one encoder FFN block, ff1 -> relu -> drop -> ff2 -> drop, forward
and backward with respect to its input, at the reference's shape (d_model
2048, batch 16, L 1024, d_ff 4 d, p 0.1, bf16). The block runs K times with
a data dependence between iterations (x + 1e-6 grad x, the reference's scan
carry), under each way of drawing and applying the mask (``VARIANTS``):

- ``none``: no dropout (the ceiling);
- ``where``: the threefry blocked-byte mask (``dropout_keep_mask``), then
  ``torch.where``;
- ``mul``: the same mask applied as x * keep * 1/(1-p');
- ``bernoulli``: ``jax.random.bernoulli``'s threefry uniform an element
  (``ops.attention.bernoulli``), flax's dropout;
- ``remat_drop``: ``where`` inside ``torch.utils.checkpoint``, so the
  backward draws the mask again instead of keeping it;
- ``hash``: the counter-hash mask as the plain int64 torch ops
  (``cheap_dropout_reference``);
- ``hash_remat``: ``hash`` inside ``torch.utils.checkpoint``;
- ``hash_kernel``: the hash-dropout kernel (``cheap_dropout``), one launch
  a site forward and one backward.

Timing: CUDA events around the K iterations, after one warm run, best of 3.
Each variant's line gives its ms a block and its cost over ``none``, with
the card. Writes ``--out`` (default ``runs_torch/dropout_microbench.json``;
the root ``DROPOUT_MICROBENCH.json`` is the JAX package's). With
``--device cpu`` the blocks run for their outputs only: no time is
measured there.
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops import hash_dropout as hd
from ..ops.attention import (bernoulli, cheap_dropout, cheap_dropout_reference,
                             dropout_keep_mask, random_bits)
from ..utils.card import device_info
from ..utils.device import resolve_device
from . import RESULTS_DIR, emit, save

P_DROP = 0.1
# variant: (its drop function, run inside torch.utils.checkpoint)
VARIANTS = {"none": (None, False), "where": ("where", False), "mul": ("mul", False),
            "bernoulli": ("bernoulli", False), "remat_drop": ("where", True),
            "hash": ("hash", False), "hash_remat": ("hash", True),
            "hash_kernel": ("hash_kernel", False)}

Key = Tuple[int, int]
Drop = Callable[[Key, int, torch.Tensor], torch.Tensor]


def drop_fns(p: float) -> Dict[str, Drop]:
    """The drop functions of the variants, each (threefry key, hash seed,
    y) -> y with dropout at rate ``p``."""
    def zeros(y):
        return torch.zeros((), dtype=y.dtype, device=y.device)

    def where(key, seed, y):
        keep, p_eff = dropout_keep_mask(key, y.shape, p, y.device)
        return torch.where(keep, y / (1.0 - p_eff), zeros(y))

    def mul(key, seed, y):
        keep, p_eff = dropout_keep_mask(key, y.shape, p, y.device)
        return y * (keep.to(y.dtype) * (1.0 / (1.0 - p_eff)))

    def bern(key, seed, y):
        return torch.where(bernoulli(key, 1.0 - p, y.shape, y.device), y / (1.0 - p),
                           zeros(y))

    return {"where": where, "mul": mul, "bernoulli": bern,
            "hash": lambda key, seed, y: cheap_dropout_reference(seed, y, p),
            "hash_kernel": lambda key, seed, y: cheap_dropout(seed, y, p)}


def site_keys(seed: int, iters: int) -> List[List[Tuple[Key, int]]]:
    """(threefry key, hash seed) of the two drop sites of each iteration:
    key (seed, 2 i + j), and the hash seed one threefry word of it, as the
    reference draws ``jax.random.bits(rng, (), uint32)``."""
    return [[((seed, 2 * i + j), int(random_bits((seed, 2 * i + j), (1,))[0]))
             for j in range(2)] for i in range(iters)]


def ffn_block(x: torch.Tensor, w1: torch.Tensor, w2: torch.Tensor, drop: Optional[Drop],
              remat: bool, sites: List[Tuple[Key, int]]) -> torch.Tensor:
    """ff1 -> relu -> drop -> ff2 -> drop, x [B, L, d]."""
    def apply(y, site):
        if drop is None:
            return y
        if remat:
            return checkpoint(drop, site[0], site[1], y, use_reentrant=False)
        return drop(site[0], site[1], y)

    y = apply(F.relu(x @ w1), sites[0])
    return apply(y @ w2, sites[1])


def k_iters(x, w1, w2, drop: Optional[Drop], remat: bool, keys) -> torch.Tensor:
    """len(keys) forward-and-backward blocks, each input the last plus
    1e-6 times its gradient."""
    for sites in keys:
        xg = x.detach().requires_grad_()
        loss = ffn_block(xg, w1, w2, drop, remat, sites).float().sum()
        (gx,) = torch.autograd.grad(loss, xg)
        x = x + gx * 1e-6
    return x


def run_variant(name: str, x, w1, w2, keys, device: torch.device) -> Dict:
    """One variant's row: ms a block (best of 3 timed runs on the card) and
    the hash-dropout kernel's launches a block."""
    fn_name, remat = VARIANTS[name]
    drop = None if fn_name is None else drop_fns(P_DROP)[fn_name]
    hd.reset_launches()
    k_iters(x, w1, w2, drop, remat, keys)             # warm
    row = {"variant": name, "fwdbwd_ms": None,
           "hash_dropout_launches_per_block": hd.LAUNCHES["hash_dropout"] / len(keys)}
    if device.type == "cuda":
        best = float("inf")
        for _ in range(3):
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            k_iters(x, w1, w2, drop, remat, keys)
            t1.record()
            torch.cuda.synchronize()
            best = min(best, t0.elapsed_time(t1) / len(keys))
        row["fwdbwd_ms"] = best
    return row


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--d-model", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--len", dest="seq", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "dropout_microbench.json"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = device_info(device)
    d, b, l = args.d_model, args.batch, args.seq
    f = 4 * d
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((b, l, d), device=device, generator=gen).bfloat16()
    w1 = (torch.randn((d, f), device=device, generator=gen) * 0.02).bfloat16()
    w2 = (torch.randn((f, d), device=device, generator=gen) * 0.02).bfloat16()
    keys = site_keys(0, args.iters)
    shape = {"d_model": d, "batch": b, "seq": l, "d_ff": f, "p": P_DROP, "iters": args.iters}
    rows = []
    for name in VARIANTS:
        rows.append(emit({**run_variant(name, x, w1, w2, keys, device), "shape": shape,
                          "device": device.type}, card))
        if device.type == "cuda":
            torch.cuda.empty_cache()
    base = rows[0]["fwdbwd_ms"]
    cost = {r["variant"]: None if base is None else r["fwdbwd_ms"] - base for r in rows[1:]}
    save(args.out, {"card": card, "shape": shape, "rows": rows,
                    "note": "one FFN block (ff1->relu->drop->ff2->drop) forward and "
                            "backward, K iterations, CUDA events, best of 3; 'none' is "
                            "the ceiling",
                    "dropout_cost_ms_per_block": cost})
    return emit({"summary": "dropout_microbench", "dropout_cost_ms_per_block": cost,
                 "out": args.out, "device": device.type}, card)


if __name__ == "__main__":
    main()
