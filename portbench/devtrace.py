"""A device trace of part of a run: ``torch.profiler`` over CPU and CUDA.

:func:`capture` runs a callable under the profiler and keeps, in seconds,
every device operation (kernels, copies, sets) and every host operation,
and the wall time of the traced stretch. From those: the device's busy
time (the union of its operations), time by operation name, and the idle
stretches of the device, each named by the innermost host operation that
was running when it began.
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

Span = Tuple[str, float, float]


@dataclass
class Trace:
    device: List[Span] = field(default_factory=list)
    host: List[Span] = field(default_factory=list)
    window_s: float = 0.0
    units: int = 0                 # steps or requests traced

    def busy_intervals(self) -> List[Tuple[float, float]]:
        out: List[Tuple[float, float]] = []
        for _, a, b in sorted(self.device, key=lambda s: s[1]):
            if out and a <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], b))
            else:
                out.append((a, b))
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals())

    def by_name(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for name, a, b in self.device:
            out[name] = out.get(name, 0.0) + (b - a)
        return out

    def idle_gaps(self) -> Dict[str, float]:
        """Idle seconds between device operations, by the innermost host
        operation running at each gap's start (the latest-started one that
        has not ended)."""
        busy = self.busy_intervals()
        host = sorted(self.host, key=lambda s: s[1])
        starts = [s[1] for s in host]
        out: Dict[str, float] = {}
        for (_, end), (start, _) in zip(busy, busy[1:]):
            if start <= end:
                continue
            name = "host: no operation"
            i = bisect.bisect_right(starts, end) - 1
            for j in range(i, max(i - 256, -1), -1):
                if host[j][2] > end:
                    name = host[j][0]
                    break
            out[name] = out.get(name, 0.0) + (start - end)
        return out

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.idle_gaps().items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:160], v] for k, v in ops],
                "idle_gaps": [[k[:160], v] for k, v in gaps]}


def capture(fn: Callable[[], int], sync: Callable[[], None], cuda: bool = True) -> Trace:
    """Trace ``fn`` (which returns how many steps or requests it ran)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        units = fn()
        sync()
        window = time.perf_counter() - t0
    tr = Trace(window_s=window, units=units)
    for e in prof.events():
        span = (e.name, e.time_range.start * 1e-6, e.time_range.end * 1e-6)
        if e.device_type == DeviceType.CUDA:
            tr.device.append(span)
        elif e.device_type == DeviceType.CPU:
            tr.host.append(span)
    return tr
