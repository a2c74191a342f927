"""The work a step's inputs need, whatever implements it.

Attention: each (query, key) pair the segment and padding masks allow,
counted once a head and a layer; 4 D FLOPs a pair in the forward (q.k and
p.v) and 8 D in the backward (dV, dP, dQ, dK); each input byte read once
and each output byte written once a call (forward: q, k, v in, O out;
backward: q, k, v, O, dO in, dQ, dK, dV out), over valid tokens only. The
bound of a call is the larger of its FLOPs over the bf16 peak and its bytes
over the HBM rate. This replaces the allowed-pair bound of
``glearning_benchmark_tpu_torch/ops/flash_attention.py`` (``bound``,
``bound_bwd``, ``allowed_pairs``), which counts pad rows' output and the
SFU, and the count of ``tools/mfu_bench.py`` (``analytic_train_flops``),
which counts B L^2 pairs and every position.

Model FLOPs: 2 FLOPs a matmul parameter a valid token forward, 6 forward
and backward, over the encoder layers' weight matrices (qkv, out
projection, two FFN layers), plus the head once an example, plus the
attention FLOPs above. Embedding gathers, recomputation and padding are
left out.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def allowed_pairs(seg: np.ndarray) -> int:
    """Pairs a head of one layer attends over [rows, L] segment ids (0 =
    pad): the sum over rows and segments of the segment's length squared."""
    seg = np.asarray(seg)
    if seg.size == 0:
        return 0
    total = 0
    for row in seg:
        counts = np.bincount(row[row > 0])
        total += int((counts.astype(np.int64) ** 2).sum())
    return total


def matmul_params(arch: Dict[str, int]) -> int:
    d, ff = arch["d_model"], arch["d_ff"]
    return arch["layers"] * (4 * d * d + 2 * d * ff)


def attention_work(pairs: int, valid: int, arch: Dict[str, int], backward: bool) -> Dict:
    """FLOPs and bytes of the attention calls of one pass over all layers."""
    h, layers = arch["heads"], arch["layers"]
    dh = arch["d_model"] // h
    calls = [(4, 4)] + ([(8, 8)] if backward else [])   # (FLOPs a pair / D, rows moved)
    return {"calls": [{"flops": f * dh * pairs * h * layers,
                       "bytes": rows * valid * h * dh * 2 * layers} for f, rows in calls]}


def attention_bound_s(work: Dict, pk: Dict[str, float]) -> Dict:
    """Least seconds for the calls, and which bound binds more of it."""
    t_f = t_b = 0.0
    total = 0.0
    for c in work["calls"]:
        f, b = c["flops"] / pk["bf16_flops"], c["bytes"] / pk["hbm_bytes_s"]
        total += max(f, b)
        t_f += f
        t_b += b
    return {"seconds": total, "by": "flops" if t_f >= t_b else "bytes"}


def model_flops(pairs: int, valid: int, examples: int, arch: Dict[str, int],
                backward: bool) -> float:
    per_token = 2.0 * matmul_params(arch)
    head = 2.0 * arch["d_model"] * examples
    att = sum(c["flops"] for c in attention_work(pairs, valid, arch, False)["calls"])
    fwd = per_token * valid + head + att
    return 3.0 * fwd if backward else fwd
