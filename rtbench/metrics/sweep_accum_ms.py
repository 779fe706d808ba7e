"""Per-layer metric ``sweep_accum_ms`` (ms): the host's sum of a sweep into the accumulator
(the program's ``rt.progressive.accumulate`` span), the median over
profiled sweeps.

Read from the traced run; returns None where there is nothing to read."""

from rtbench import spans


def read(ctx):
    return spans.summed_ms(ctx["trace"], ("rt.progressive.accumulate",))
