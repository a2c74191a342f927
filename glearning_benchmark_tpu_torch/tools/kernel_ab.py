"""A/B of source trees of the flash-attention kernels on one card, in one
process: this tree's ``csrc`` against others (a parent commit's, or
variants of a kernel), at the attention rows of the shipped configs (head
dims 4-16) or at the rows ``--rows`` names (``WIDE_ROWS``: mfu_bench's
packed rows at head dims 320-512).

    python -m glearning_benchmark_tpu_torch.tools.kernel_ab --against DIR
        [--against DIR ...] [--rows NAME,...] [--probe] [--out PATH]

Each ``DIR`` holds a tree's ``flash_attn_{fwd,bwd_dq,bwd_dkv}.cu`` and
``flash_attn_common.cuh`` (for example ``glearning_benchmark_tpu_torch/csrc``
of a ``git archive`` of another commit) with the C entry points this
tree's launchers call. Every tree is built for sm_90a into libraries of
its own (``ops.flash_attention.build``: a library is named by the hash of
its sources, so a source two trees share is built once; the other trees
side by side). At each row the inputs are made once (bf16 q, k, v, dO and
the row's segments from ``tools.flash_ab.inputs``: a ragged key mask or
packed rows of 4 segments; dropout at the training rate 26/256 on training
rows) and each kernel is timed (``utils.card.cuda_ms``) under this tree,
the others in order, the others backwards and this tree again; the lower
reading of each tree is kept, so all are read on the same card in the
same state. Before timing, each tree's O, dQ, dK and dV are held to the
plain version (rtol 4e-3, atol 1e-5, the kernels' elementwise tolerance;
LSE within 1e-4); with ``--probe`` only this tree's are (the others are
probes that leave out part of a kernel's work, to see what it costs). Each row also gives the kernels'
bounds (``bound``, ``bound_bwd``), ``scaled_dot_product_attention``'s
forward and backward on the same mask (no dropout), and each tree's
instance's registers and spilled bytes a thread (``kernel_attrs``).

Prints one JSON line a row with the card's name and power limit and writes
``--out`` (default ``runs_torch/kernel_ab.json``). Needs the card.
"""

from __future__ import annotations

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, List, Optional

import torch

from ..ops import flash_attention as fa
from ..utils.card import card, cuda_ms
from . import RESULTS_DIR, emit, save
from .flash_ab import _allow, inputs

TRAIN_RATE = 26 / 256      # the rate the trainer hands the kernels at dropout 0.1
RTOL, ATOL, LSE_ATOL = 4e-3, 1e-5, 1e-4
ITERS = 20                 # calls a reading
# (name, [B, L, H, D], segments, dropout): the rows of the shipped configs
# at head dims 4-16 (PERF.md's kernel table) and mfu_bench's head dim 12
ROWS = [
    ("agtt-train", (49, 256, 4, 16), "packed", TRAIN_RATE),
    ("ibtt-train", (128, 256, 4, 4), "ragged", TRAIN_RATE),
    ("ibtt-served", (256, 1024, 4, 4), "ragged", 0.0),
    ("graph-token-ibtt", (47, 640, 4, 4), "packed", TRAIN_RATE),
    ("graph-token-agtt", (22, 512, 4, 8), "packed", TRAIN_RATE),
    ("agtt-served", (256, 1024, 4, 16), "ragged", 0.0),
    ("mfu-d12", (64, 1024, 8, 12), "packed", TRAIN_RATE),
]
# mfu_bench's packed rows above head dim 256 (the wgmma_chunks instances)
WIDE_ROWS = [
    ("mfu-d320", (16, 1024, 8, 320), "packed", TRAIN_RATE),
    ("mfu-d384", (8, 1024, 8, 384), "packed", TRAIN_RATE),
    ("mfu-d448", (8, 1024, 8, 448), "packed", TRAIN_RATE),
    ("mfu-d512", (8, 1024, 8, 512), "packed", TRAIN_RATE),
]


def tree_sources(csrc: Path) -> tuple:
    """({kernel: its source}, (the shared header,)) of the tree in ``csrc``."""
    return ({name: csrc / f"{name}.cu" for name in fa.SOURCES},
            (csrc / "flash_attn_common.cuh",))


def load_tree(csrc: Path, head_dims: List[int]) -> tuple:
    """(the three kernels' C entry points built from the tree in ``csrc``,
    {(kernel, head dim, dropout): its instance's resources}) at
    ``head_dims``; the launchers' own sources are restored afterwards."""
    sources, headers = dict(fa.SOURCES), fa.HEADERS
    fa.SOURCES.update(tree_sources(csrc)[0])
    fa.HEADERS = tree_sources(csrc)[1]
    fa._fns.clear()
    try:
        fns = {name: fa._kernel(name) for name in sources}
        attrs = {(name, d, drop): fa.kernel_attrs(name, d, torch.bfloat16, drop)
                 for name in sources for d in head_dims for drop in (False, True)}
        return fns, attrs
    finally:
        fa.SOURCES.update(sources)
        fa.HEADERS = headers
        fa._fns.clear()


def use(fns: Dict[str, object]) -> None:
    fa._fns.clear()
    fa._fns.update(fns)


def held(q, k, v, seg, do, p: float, chunk: int = 64) -> None:
    """The loaded tree's forward and backward against the plain version
    (run on ``chunk`` batch rows at a time, each at its place in the
    batch*head index space of the dropout hash)."""
    o, lse = fa.flash_attention_fwd(q, k, v, seg, p, 11)
    dq, delta = fa.flash_attention_bwd_dq(q, k, v, seg, o, lse, do, p, 11)
    dk, dv = fa.flash_attention_bwd_dkv(q, k, v, seg, o, lse, do, delta, p, 11)
    h = q.shape[2]
    for i in range(0, q.shape[0], chunk):
        rows = slice(i, i + chunk)
        qf, kf, vf = (t[rows].float() for t in (q, k, v))
        ro, rl = fa.flash_attention_reference(qf, kf, vf, seg[rows], p, 11, i * h)
        refs = fa.flash_attention_bwd_reference(qf, kf, vf, seg[rows], o[rows], lse[rows],
                                                do[rows].float(), p, 11, i * h)
        for what, got, ref in (("O", o, ro), ("dQ", dq, refs[0]), ("dK", dk, refs[1]),
                               ("dV", dv, refs[2])):
            err = (got[rows].float() - ref).abs()
            if not bool((err <= RTOL * ref.abs() + ATOL).all()):
                raise AssertionError(f"{what} misses the plain version's bound")
        if (lse[rows] - rl).abs().max().item() > LSE_ATOL:
            raise AssertionError("LSE misses the plain version's")


def sdpa_ms(q, k, v, seg, do) -> Dict[str, float]:
    """SDPA's forward and its whole backward on the same mask."""
    allow = _allow(seg)
    qt, kt, vt = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    with torch.no_grad():
        fwd = min(cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=allow), ITERS))
    out = torch.nn.functional.scaled_dot_product_attention(qt, kt, vt, attn_mask=allow)
    bwd = min(cuda_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), do.transpose(1, 2),
                                                  retain_graph=True), ITERS))
    return {"forward": fwd, "backward": bwd}


def ab_row(shape, kind: str, p: float, trees: Dict[str, tuple], seed: int,
           probe: bool = False) -> dict:
    """One row: each tree held to the plain version (``probe``: this tree
    only), then timed in turns."""
    fns = {tree: t[0] for tree, t in trees.items()}
    names = list(trees)                      # "this" first
    b, l, h, d = shape
    q, k, v, seg_mask, seg_packed = inputs(b, l, h, d, torch.device("cuda"), seed)
    seg = seg_packed if kind == "packed" else seg_mask
    do = torch.randn(b, l, h, d, generator=torch.Generator().manual_seed(seed)).to(
        "cuda", torch.bfloat16)
    for tree in names[:1] if probe else names:
        use(fns[tree])
        held(q, k, v, seg, do, p)
    use(fns["this"])
    o, lse = fa.flash_attention_fwd(q, k, v, seg, p, 11)
    _, delta = fa.flash_attention_bwd_dq(q, k, v, seg, o, lse, do, p, 11)
    calls = {"flash_attn_fwd": lambda: fa.flash_attention_fwd(q, k, v, seg, p, 11),
             "flash_attn_bwd_dq": lambda: fa.flash_attention_bwd_dq(
                 q, k, v, seg, o, lse, do, p, 11),
             "flash_attn_bwd_dkv": lambda: fa.flash_attention_bwd_dkv(
                 q, k, v, seg, o, lse, do, delta, p, 11)}
    ms = {name: {tree: float("inf") for tree in names} for name in calls}
    for tree in names + names[::-1]:          # this, others, others backwards, this
        use(fns[tree])
        for name, fn in calls.items():
            ms[name][tree] = min(ms[name][tree], min(cuda_ms(fn, ITERS)))
    bounds = {"flash_attn_fwd": fa.bound(q, seg)["bound_ms"],
              "flash_attn_bwd_dq": fa.bound_bwd(q, seg, "dq")["bound_ms"],
              "flash_attn_bwd_dkv": fa.bound_bwd(q, seg, "dkv")["bound_ms"]}
    return {"ms": ms, "over_this": {n: {tree: t[tree] / t["this"] for tree in names[1:]}
                                    for n, t in ms.items()},
            "bound_ms": bounds, "sdpa_ms": sdpa_ms(q, k, v, seg, do),
            "designs": {n: fa.design(n, d, q.dtype, fa.tma_ok(q, k, v)) for n in calls},
            "resources": {n: {tree: {key: t[1][(n, d, p > 0)][key]
                                     for key in ("registers", "local_bytes")}
                              for tree, t in trees.items()} for n in calls}}


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--against", required=True, action="append",
                    help="directory with another tree's kernel sources (repeatable)")
    ap.add_argument("--rows", default=None,
                    help="comma-separated row names of ROWS and WIDE_ROWS (default: ROWS)")
    ap.add_argument("--probe", action="store_true",
                    help="the other trees are probes: hold only this tree to the plain version")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "kernel_ab.json"))
    args = ap.parse_args(argv)
    known = {r[0]: r for r in ROWS + WIDE_ROWS}
    rows = ROWS if args.rows is None else [known[n] for n in args.rows.split(",")]
    if not torch.cuda.is_available():
        print("kernel_ab: CUDA is not available; the kernels run only on the card",
              file=sys.stderr)
        raise SystemExit(1)
    gpu = card()
    dirs = {"this": fa._CSRC, **{d: Path(d).resolve() for d in args.against}}
    fa.build()                               # this tree first: the others share its sources
    with ThreadPoolExecutor(len(args.against)) as pool:
        list(pool.map(lambda d: fa.build(*tree_sources(d)), list(dirs.values())[1:]))
    head_dims = sorted({r[1][3] for r in rows})
    trees = {tree: load_tree(d, head_dims) for tree, d in dirs.items()}
    report = {}
    try:
        for seed, (name, shape, kind, p) in enumerate(rows):
            row = {"row": name, "shape": list(shape), "segments": kind, "p_drop": p,
                   "against": args.against, "probe": args.probe,
                   **ab_row(shape, kind, p, trees, seed, args.probe)}
            report[name] = emit(row, gpu)
            torch.cuda.empty_cache()
    finally:
        fa._fns.clear()
    save(args.out, report)
    return report


if __name__ == "__main__":
    main()
