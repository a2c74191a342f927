"""What the span readers share: device operations and host time by the
program's spans (``glearning_benchmark_tpu_torch/utils/trace.py``).

The program's spans are host ranges of the trace under their own names
(``SPANS``); the model's regions have one in the forward and one of the
same name around their backward. A device operation belongs to the
innermost span that holds the start of the host call that launched it,
and to the phase (``PHASES``) that holds that span. Host calls and device
operations are paired in order: on the one stream the steps run on, the
device runs its operations in the order the host enqueued them, so the
k-th enqueueing call (``ENQUEUE``) of the trace launched its k-th device
operation. A trace whose counts of the two differ, or that holds no span
(a program without them), reads None.
"""

from __future__ import annotations

import bisect
from typing import Callable, List, Optional, Tuple

PHASES = ("train.forward", "train.backward", "train.update")
NORM = ("layer.attn_norm", "layer.ffn_norm")
SPANS = frozenset(("train.step", "model.embed", "model.readout", "layer.attn", "layer.ffn")
                  + PHASES + NORM)
# the runtime and driver calls that put an operation on a stream
ENQUEUE = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchCooperativeKernel",
           "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")


def _spans(tr) -> List[Tuple[str, float, float]]:
    return sorted((s for s in tr.host if s[0] in SPANS), key=lambda s: (s[1], -s[2]))


def regions(tr) -> Optional[List[Tuple[float, Optional[str], Optional[str]]]]:
    """(seconds, phase, innermost span) of every device operation of the
    trace; None where the trace cannot say (module docstring)."""
    if tr is None or not tr.units or not tr.device:
        return None
    spans = _spans(tr)
    calls = sorted(s[1] for s in tr.host if s[0].startswith(ENQUEUE))
    if not spans or len(calls) != len(tr.device):
        return None
    parent: List[int] = []
    open_: List[int] = []
    for i, (_, a, _) in enumerate(spans):
        while open_ and spans[open_[-1]][2] <= a:
            open_.pop()
        parent.append(open_[-1] if open_ else -1)
        open_.append(i)
    starts = [s[1] for s in spans]
    out = []
    for t, (_, a, b) in zip(calls, sorted(tr.device, key=lambda s: s[1])):
        i = bisect.bisect_right(starts, t) - 1
        while i >= 0 and spans[i][2] <= t:
            i = parent[i]
        inner, phase = (spans[i][0] if i >= 0 else None), None
        while i >= 0:
            if spans[i][0] in PHASES:
                phase = spans[i][0]
            i = parent[i]
        out.append((b - a, phase, inner))
    return out


def device_ms_per_unit(ctx, keep: Callable[[Optional[str], Optional[str]], bool]
                       ) -> Optional[float]:
    """Device ms a traced step of the operations whose (phase, innermost
    span) ``keep`` takes."""
    ops = regions(ctx.trace)
    if ops is None:
        return None
    return sum(s for s, phase, inner in ops if keep(phase, inner)) / ctx.trace.units * 1e3


def host_ms_per_unit(ctx, name: str) -> Optional[float]:
    """Host ms a traced step inside the spans ``name``."""
    tr = ctx.trace
    if tr is None or not tr.units:
        return None
    walls = [b - a for n, a, b in tr.host if n == name]
    return sum(walls) / tr.units * 1e3 if walls else None
