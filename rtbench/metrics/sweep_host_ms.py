"""Per-layer metric ``sweep_host_ms`` (ms): the median profiled sweep's wall time minus
``k5_ms.sweep``: the host's part of a sweep (the copy of the colours, the
sum into the accumulator, the launch wrapper).

Read from the traced run; returns None where there is nothing to read."""

import statistics

from rtbench.metrics_common import K5, kernel_ms


def read(ctx):
    k5 = kernel_ms(ctx, K5)
    if k5 is None or not ctx["unit_seconds"]:
        return None
    return 1e3 * statistics.median(ctx["unit_seconds"]) - k5
