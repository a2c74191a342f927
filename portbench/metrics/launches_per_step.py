"""Device operations (kernels, copies, sets) a traced training step."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or not tr.units:
        return None
    return len(tr.device) / tr.units
