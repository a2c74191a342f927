"""Host ms a traced training step inside ``train.forward`` on the training
thread: the forward's enqueue, profiler on (``_spans.py``)."""

from portbench.metrics._spans import host_ms_per_unit


def read(ctx):
    return host_ms_per_unit(ctx, "train.forward")
