"""Host ms a step to enqueue the window's epochs: the host clock around each
``train_epoch`` call, before the read that waits for the device, over the
steps of the untraced window."""


def read(ctx):
    w = ctx.window
    return w["enqueue_s"] / w["steps"] * 1e3 if w["steps"] else None
