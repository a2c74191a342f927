"""Device ms a traced training step launched under ``train.update``: the
optimizer step with its casts, the global norm, the clip and AdamW, and the
step's statistics (``_spans.py``)."""

from portbench.metrics._spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, lambda phase, span: phase == "train.update")
