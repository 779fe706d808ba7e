"""Per-layer metric ``k1_ms.frame`` (ms): device time of kernel K1 (``megakernel_flat`` and its
``accumulate``) per profiled frame.

Read from the traced run; returns None where there is nothing to read."""

from rtbench.metrics_common import K1, kernel_ms


def read(ctx):
    return kernel_ms(ctx, K1)
