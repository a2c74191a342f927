"""Per cent of the traced training stretch in which no device operation ran."""

from portbench.metrics._reads import idle_share


def read(ctx):
    return idle_share(ctx)
