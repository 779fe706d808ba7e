"""Per-layer metric ``sweep_accum_ms`` (ms): the host's time in the program's
``rt.progressive.accumulate`` span, the median over profiled sweeps.  On a card the span
enqueues the sweep-sum kernel that adds the sweep into the device accumulator, and the
kernel runs after it; on the CPU the span holds the sum itself.

Read from the traced run; returns None where there is nothing to read."""

from rtbench import spans


def read(ctx):
    return spans.summed_ms(ctx["trace"], ("rt.progressive.accumulate",))
