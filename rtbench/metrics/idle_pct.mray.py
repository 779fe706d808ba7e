"""Per-layer metric ``idle_pct.mray`` (%): share of the profiled window in which no kernel or
copy ran on the card.

Read from the traced run; returns None where there is nothing to read."""

from rtbench.metrics_common import idle_pct


def read(ctx):
    return idle_pct(ctx)
