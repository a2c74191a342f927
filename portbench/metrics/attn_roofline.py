"""Per cent of its roofline the attention of a traced training step reaches:
the least time the step's attention calls could take on this card (each
allowed pair once a head and a layer, forward and backward, ``_counts.py``)
over the attention kernels' device time."""

from portbench.metrics._counts import attention_bound_s, attention_work
from portbench.metrics._reads import group_ms_per_unit


def read(ctx):
    ms = group_ms_per_unit(ctx, "attention")
    if not ms or ctx.peaks is None or not ctx.traced:
        return None
    t = ctx.traced
    bound = attention_bound_s(attention_work(t["pairs"], t["tokens"], ctx.arch, True), ctx.peaks)
    return 100.0 * bound["seconds"] / t["steps"] / (ms * 1e-3)
