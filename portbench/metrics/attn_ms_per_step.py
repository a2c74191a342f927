"""Device ms a traced training step in the kernel group ``attention`` (``_groups.py``)."""

from portbench.metrics._reads import group_ms_per_unit


def read(ctx):
    return group_ms_per_unit(ctx, "attention")
