"""Per-layer metric ``k1_roofline_pct`` (%): kernel K1's share of its roofline: the larger of
its operations over the FP32 peak and its bytes over the HBM peak, over its
device time a frame.  Operations and bytes come from ``rtbench.roofline``
(the reference's own count on 1,024 fixed pixels at 10 spp, scaled).

Read from the traced run; returns None where there is nothing to read."""

from rtbench import roofline, stats
from rtbench.metrics_common import K1, kernel_ms


def read(ctx):
    ms = kernel_ms(ctx, K1)
    if ms is None:
        return None
    flops, nbytes = roofline.k1_frame_work(ctx["config"], int(ctx["traffic"]["spp"]), ctx["device"])
    return stats.roofline_pct(flops, nbytes, ms * 1e-3)
