"""Device ms a traced training step launched under ``train.backward``: the
autograd engine's work through the model and the attention kernels, with
the gradients' sums (``_spans.py``)."""

from portbench.metrics._spans import device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, lambda phase, span: phase == "train.backward")
