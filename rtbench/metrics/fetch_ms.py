"""Per-layer metric ``fetch_ms`` (ms): what the host pays for the copy of a unit's result
after the device's work is done: the end of the program's ``rt.render.fetch``
or ``rt.progressive.fetch`` span minus the later of its start and the end of
the last kernel (not a copy) before it, the median over profiled units.

Read from the traced run; returns None where there is nothing to read."""

from rtbench import spans


def read(ctx):
    return spans.fetch_ms(ctx["trace"], ("rt.render.fetch", "rt.progressive.fetch"))
