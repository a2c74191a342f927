"""Device ms a traced training step in the encoder layers' f32 residual add
and LayerNorm: the spans ``layer.attn_norm`` and ``layer.ffn_norm``, forward
and their backward (``_spans.py``)."""

from portbench.metrics._spans import NORM, device_ms_per_unit


def read(ctx):
    return device_ms_per_unit(ctx, lambda phase, span: span in NORM)
