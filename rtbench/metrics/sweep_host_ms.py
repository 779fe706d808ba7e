"""Per-layer metric ``sweep_host_ms`` (ms): the median profiled sweep's wall time minus
``k5_ms.sweep``: what of a sweep is not K5 (the launch wrapper, the sum's
enqueue and its kernel, the copy of the sum to the host).

Read from the traced run; returns None where there is nothing to read."""

import statistics

from rtbench.metrics_common import K5, kernel_ms


def read(ctx):
    k5 = kernel_ms(ctx, K5)
    if k5 is None or not ctx["unit_seconds"]:
        return None
    return 1e3 * statistics.median(ctx["unit_seconds"]) - k5
