"""Per-layer metric ``launch_prep_ms`` (ms): the megakernel wrapper's host work a unit
(the program's ``rt.megakernel.prepare`` spans: the input checks, the shade
table's transpose copy, the parameter block, the allocations), the median
over profiled units of their summed duration.

Read from the traced run; returns None where there is nothing to read."""

from rtbench import spans


def read(ctx):
    return spans.summed_ms(ctx["trace"], ("rt.megakernel.prepare",))
