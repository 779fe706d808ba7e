"""Per-layer metric ``k5_ms.sweep`` (ms): device time of kernel K5 (``megakernel_clustered``) per
profiled sweep.

Read from the traced run; returns None where there is nothing to read."""

from rtbench.metrics_common import K5, kernel_ms


def read(ctx):
    return kernel_ms(ctx, K5)
