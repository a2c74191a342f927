"""Per cent of the card's datasheet bf16 peak the untraced window's training
reaches: the model FLOPs its completed steps need (``_counts.py``: valid
tokens, allowed pairs, forward and backward) over the window's seconds."""

from portbench.metrics._counts import model_flops


def read(ctx):
    w = ctx.window
    if ctx.peaks is None or not w["seconds"]:
        return None
    flops = model_flops(w["pairs"], w["tokens"], w["examples"], ctx.arch, True)
    return 100.0 * flops / (w["seconds"] * ctx.peaks["bf16_flops"])
