"""Attention A/B of the port: the hand-written flash-attention kernels
against plain torch attention and ``scaled_dot_product_attention``, at the
shapes of the root ``tools/flash_ab.py`` (``SHAPES``, ibtt-sp to xxl).

    python -m glearning_benchmark_tpu_torch.tools.flash_ab [--shapes ibtt-zinc,xl] [--device cpu]

Three routes, bf16, at steady state (``utils.card.cuda_ms``: CUDA events
over back-to-back calls, queued behind a device spin):

- ``kernel``: ``ops.flash_attention.flash_attention``, the route every
  encoder layer of the port takes (forward kernel; backward the dQ and the
  dK/dV kernels);
- ``plain``: ``ops.attention.multi_head_attention``, dense torch ops on the
  [B, H, L, L] logits, the JAX package's default XLA route written in torch;
- ``sdpa``: ``torch.nn.functional.scaled_dot_product_attention`` with the
  same boolean mask, the library yardstick. The port never calls it.

For each shape: the forward with a ragged key mask (valid lengths 50-100% of
L), forward + backward (the gradients of ``sum(O)`` in q, k and v), the same
with attention-probability dropout at p 0.1 (the kernels' counter hash, the
plain route's blocked-byte hash, SDPA's own sampling), and with packed rows
(4 segments a row, then the pad tail) and dropout. Each row carries the
kernels' least time on the card (``ops.flash_attention.bound`` and
``bound_bwd`` on these inputs). A dense route whose memory would not fit
(xxl's plain route holds [2, 8, 8192, 8192] logits, with its softmax, masks
and saved activations) is skipped with the reason: its peak memory is read
at L = 1024 and scaled by (L/1024)^2 against the card's free memory.

With ``--device cpu`` every route runs once for its outputs (kernel route:
the plain version) and no time is measured. Writes ``--out`` (default
``runs_torch/flash_ab.json``).
"""

from __future__ import annotations

import argparse
import os
from typing import Callable, Dict, List, Optional

import torch
import torch.nn.functional as F

from ..ops import flash_attention as fa
from ..ops.attention import multi_head_attention
from ..utils.card import cuda_ms, device_info
from ..utils.device import resolve_device
from . import RESULTS_DIR, emit, save

SHAPES = [           # (name, B, L, H, D), tools/flash_ab.py:40-47
    ("ibtt-sp", 128, 640, 4, 4),
    ("agtt-sp", 128, 640, 4, 8),
    ("ibtt-zinc", 128, 1024, 4, 4),
    ("agtt-zinc", 128, 1024, 4, 16),
    ("long", 16, 2048, 4, 16),
    ("xl", 4, 4096, 8, 64),
    ("xxl", 2, 8192, 8, 64),
]
P_DROP = 0.1
SEED = 7
PROBE_L = 1024
VARIANTS = ("fwd", "fwdbwd", "drop_fwdbwd", "packed_fwdbwd")


def inputs(b: int, l: int, h: int, d: int, device: torch.device, seed: int = 0):
    """bf16 q, k, v [B, L, H, D], a ragged key mask (valid lengths 50-100%
    of L) as segment ids, and packed rows: 4 segments a row over the valid
    tokens, then the pad tail."""
    gen = torch.Generator().manual_seed(seed)
    q, k, v = (torch.randn(b, l, h, d, generator=gen).to(device, torch.bfloat16)
               for _ in range(3))
    lens = torch.randint(l // 2, l + 1, (b,), generator=gen)
    valid = torch.arange(l)[None, :] < lens[:, None]
    seg_mask = valid.to(torch.int32)
    seg_packed = torch.where(valid, (torch.arange(l)[None, :] // max(l // 4, 1)).clamp(max=3) + 1,
                             0).to(torch.int32)
    return q, k, v, seg_mask.to(device), seg_packed.to(device)


def _allow(seg: torch.Tensor) -> torch.Tensor:
    """SDPA's boolean mask [B, 1, L, L]: same segment and a valid key; pad
    query rows (whose outputs nobody reads) attend every key, so that no
    row is all masked (SDPA gives NaN there)."""
    allow = (seg[:, None, :, None] == seg[:, None, None, :]) & (seg > 0)[:, None, None, :]
    return allow | (seg == 0)[:, None, :, None]


def route_fn(route: str, seg: torch.Tensor, p_drop: float) -> Callable:
    """fn(q, k, v) -> O [B, L, H, D] of ``route`` with this mask and rate."""
    if route == "kernel":
        return lambda q, k, v: fa.flash_attention(q, k, v, seg=seg, p_drop=p_drop, seed=SEED)
    if route == "plain":
        return lambda q, k, v: multi_head_attention(q, k, v, seg=seg, dropout_rate=p_drop,
                                                    dropout_seed=SEED)
    allow = _allow(seg)
    return lambda q, k, v: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=allow,
        dropout_p=p_drop).transpose(1, 2)


def variant_fn(route: str, variant: str, q, k, v, seg_mask, seg_packed) -> Callable:
    """A no-argument call of ``route`` in ``variant``: the forward under
    no_grad, or forward + backward of sum(O) in q, k, v."""
    seg = seg_packed if variant == "packed_fwdbwd" else seg_mask
    p = 0.0 if variant in ("fwd", "fwdbwd") else P_DROP
    fn = route_fn(route, seg, p)
    if variant == "fwd":
        def fwd():
            with torch.no_grad():
                return fn(q, k, v)
        return fwd
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]

    def fwdbwd():
        return torch.autograd.grad(fn(*leaves).float().sum(), leaves)
    return fwdbwd


def peak_bytes(fn: Callable, device: torch.device) -> int:
    """Peak device memory one call of ``fn`` allocates beyond what is held."""
    torch.cuda.synchronize(device)
    base = torch.cuda.memory_allocated(device)
    torch.cuda.reset_peak_memory_stats(device)
    fn()
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) - base


def fits(route: str, shape, device: torch.device) -> Optional[str]:
    """None when the heaviest variant of ``route`` fits the card at
    ``shape``; else the reason it is skipped (peak at L = 1024, scaled by
    (L / 1024)^2, against the free memory)."""
    _, b, l, h, d = shape
    if route == "kernel" or l <= PROBE_L:
        return None
    probe = inputs(b, PROBE_L, h, d, device)
    need = max(peak_bytes(variant_fn(route, var, *probe), device)
               for var in VARIANTS) * (l / PROBE_L) ** 2
    del probe
    torch.cuda.empty_cache()
    free, _ = torch.cuda.mem_get_info(device)
    if need <= 0.9 * free:
        return None
    return (f"needs about {need / 2**30:.1f} GiB (peak at L {PROBE_L} x (L/{PROBE_L})^2), "
            f"{free / 2**30:.1f} GiB free")


def bounds(q, seg_mask, seg_packed) -> Dict[str, object]:
    """The kernels' least time for each variant on these inputs."""
    fwd = fa.bound(q, seg_mask)
    fwdbwd = fwd["bound_ms"] + sum(fa.bound_bwd(q, seg_mask, w)["bound_ms"] for w in ("dq", "dkv"))
    packed = (fa.bound(q, seg_packed)["bound_ms"]
              + sum(fa.bound_bwd(q, seg_packed, w)["bound_ms"] for w in ("dq", "dkv")))
    return {"bound_fwd_ms": fwd["bound_ms"], "bound_fwd_by": fwd["bound_by"],
            "bound_fwdbwd_ms": fwdbwd, "bound_drop_fwdbwd_ms": fwdbwd,
            "bound_packed_fwdbwd_ms": packed}


def run_shape(shape, device: torch.device, card: Dict[str, str]) -> Dict:
    name, b, l, h, d = shape
    q, k, v, seg_mask, seg_packed = inputs(b, l, h, d, device)
    row: Dict[str, object] = {"shape": name, "B": b, "L": l, "H": h, "D": d,
                              "dtype": "bfloat16", "p_drop": P_DROP, "device": device.type}
    skipped = {}
    for route in ("kernel", "plain", "sdpa"):
        reason = fits(route, shape, device) if device.type == "cuda" else None
        if reason is not None:
            skipped[route] = reason
            for var in VARIANTS:
                row[f"{route}_{var}_ms"] = None
            continue
        for var in VARIANTS:
            fn = variant_fn(route, var, q, k, v, seg_mask, seg_packed)
            if device.type == "cuda":
                row[f"{route}_{var}_ms"] = min(cuda_ms(fn, 10 if l >= 4096 else 20))
            else:
                out = fn()
                if not all(torch.isfinite(t.float()).all() for t in
                           (out if isinstance(out, tuple) else (out,))):
                    raise AssertionError(f"{route} {var} at {name}: non-finite output")
                row[f"{route}_{var}_ms"] = None    # not measured: no card
        if device.type == "cuda":
            torch.cuda.empty_cache()
    with torch.no_grad():
        ko = route_fn("kernel", seg_mask, 0.0)(q, k, v).float()
        so = route_fn("sdpa", seg_mask, 0.0)(q, k, v).float()
    # on the valid query rows (the kernel zeroes pad rows, SDPA attends there)
    row["max_abs_diff_kernel_vs_sdpa"] = (ko - so)[seg_mask > 0].abs().max().item()
    if device.type == "cuda":
        row.update(bounds(q, seg_mask, seg_packed))
        for var in VARIANTS:
            k_ms = row[f"kernel_{var}_ms"]
            for other in ("plain", "sdpa"):
                o_ms = row[f"{other}_{var}_ms"]
                row[f"{var}_{other}_over_kernel"] = None if o_ms is None else o_ms / k_ms
    row["skipped"] = skipped
    return emit(row, card)


def main(argv: Optional[List[str]] = None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="", help="comma-separated names (default: all)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--shape", nargs=5, action="append", default=None,
                    metavar=("NAME", "B", "L", "H", "D"), help="a shape of one's own")
    ap.add_argument("--out", default=os.path.join(RESULTS_DIR, "flash_ab.json"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = device_info(device)
    only = {s for s in args.shapes.split(",") if s}
    shapes = [s for s in SHAPES if not only or s[0] in only]
    shapes += [(s[0], *map(int, s[1:])) for s in args.shape or []]
    rows = [run_shape(s, device, card) for s in shapes]
    save(args.out, {"dtype": "bfloat16", "rows": rows})
    return emit({"summary": "flash_ab", "shapes": [r["shape"] for r in rows],
                 "kernel_fwdbwd_ms": {r["shape"]: r["kernel_fwdbwd_ms"] for r in rows},
                 "device": device.type}, card)


if __name__ == "__main__":
    main()
