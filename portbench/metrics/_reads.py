"""What several readers share: device time of a kernel group a traced step."""

from __future__ import annotations

from typing import Optional

from ._groups import group_of


def group_ms_per_unit(ctx, group: str) -> Optional[float]:
    tr = ctx.trace
    if tr is None or not tr.device or not tr.units:
        return None
    s = sum(b - a for name, a, b in tr.device if group_of(name) == group)
    return s / tr.units * 1e3


def idle_share(ctx) -> Optional[float]:
    tr = ctx.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
