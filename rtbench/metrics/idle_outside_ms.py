"""Per-layer metric ``idle_outside_ms`` (ms): the device's idle time a unit during which no
``rt.*`` span of the program is open on the host (the caller's share, which
no change to the program recovers); a unit runs from its start to the next
unit's start.  The median over profiled units.

Read from the traced run; returns None where there is nothing to read."""

from rtbench import spans


def read(ctx):
    return spans.idle_outside_ms(ctx["trace"])
