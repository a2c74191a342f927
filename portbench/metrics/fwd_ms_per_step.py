"""Device ms a traced training step launched under ``train.forward``: the
batch gather, the model's forward, the loss and its statistics (``_spans.py``)."""

from portbench.metrics._spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, lambda phase, span: phase == "train.forward")
