"""Seconds of the port's ``build_dataset`` in set-up (its content-addressed
cache's load after a checkout's first run)."""


def read(ctx):
    return ctx.spans.get("bundle_s")
