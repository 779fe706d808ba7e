"""The program's own spans in a traced run.

The port marks its layer boundaries with ``record_function`` ranges named
``rt.<layer>.<step>`` (a frame, a sweep, a launch's preparation, the fetch
to the host, the host's sum), recorded only while a profiler records.  They
come out of the profiler as host operations, so ``trace.from_profiler``
keeps them among ``Trace.host_names``/``host_start``/``host_end``, on the
clock of the device's kernels and copies.  Here each is assigned to the
benchmark's unit span (``rtbench.unit.*``) that contains it.

Reads the trace only and imports nothing of the program: on a program
without such spans every reading is None.
"""

from __future__ import annotations

import bisect
import statistics

from rtbench import stats
from rtbench.trace import SPAN_PREFIX, Trace

PREFIX = "rt."


def units(tr: Trace) -> list[tuple[float, float]]:
    """The profiled units' (start, end), in order."""
    return sorted((s, e) for n, s, e in tr.spans if n.startswith(SPAN_PREFIX + "unit"))


def program_spans(tr: Trace) -> list[tuple[str, float, float]]:
    """Every ``rt.*`` span of the trace: (name, start, end), by start."""
    return [(n, float(s), float(e)) for n, s, e in zip(tr.host_names, tr.host_start, tr.host_end)
            if n.startswith(PREFIX)]


def by_unit(tr: Trace) -> list[list[tuple[str, float, float]]]:
    """The program's spans inside each unit, in the units' order; a span
    outside every unit belongs to none."""
    us = units(tr)
    starts = [s for s, _ in us]
    out: list[list[tuple[str, float, float]]] = [[] for _ in us]
    for n, s, e in program_spans(tr):
        k = bisect.bisect_right(starts, s) - 1
        if k >= 0 and e <= us[k][1]:
            out[k].append((n, s, e))
    return out


def _median_ms(per_unit: list[float]):
    return 1e3 * statistics.median(per_unit) if per_unit else None


def summed_ms(tr: Trace, names: tuple[str, ...]):
    """Median over the units of the summed duration (ms) of the spans
    named ``names`` in each unit, or None where no unit has one."""
    spans = by_unit(tr)
    if not any(n in names for unit in spans for n, _, _ in unit):
        return None
    return _median_ms([sum(e - s for n, s, e in unit if n in names) for unit in spans])


def fetch_ms(tr: Trace, names: tuple[str, ...]):
    """Median over the units of what each ``names`` span costs the host
    after the device's work: the span's end minus the later of its start
    and the end of the last kernel (not a copy or fill) that ended before
    the span's end.  None where no unit has such a span."""
    spans = by_unit(tr)
    if not any(n in names for unit in spans for n, _, _ in unit):
        return None
    ends = sorted(e for _, _, e in tr.kernels())
    per_unit = []
    for unit in spans:
        total = 0.0
        for n, s, e in unit:
            if n in names:
                k = bisect.bisect_right(ends, e) - 1
                total += e - (max(s, ends[k]) if k >= 0 else s)
        per_unit.append(total)
    return _median_ms(per_unit)


def idle_outside_ms(tr: Trace):
    """Median over the units of the device's idle time (ms) during which no
    ``rt.*`` span is open on the host: the caller's share of the idle time.
    A unit's interval runs from its start to the next unit's start (the
    last unit's, to its end).  None without device operations or program
    spans."""
    us = units(tr)
    spans = [(s, e) for _, s, e in program_spans(tr)]
    if not tr.ops or not spans or not us:
        return None
    busy = [(s, e) for _, s, e in tr.ops]
    per_unit = []
    for k, (lo, hi) in enumerate(us):
        if k + 1 < len(us):
            hi = us[k + 1][0]
        idle = 0.0
        for g0, g1 in stats.gaps(busy, lo, hi):
            covered = stats.union_length([(max(s, g0), min(e, g1)) for s, e in spans
                                          if e > g0 and s < g1])
            idle += (g1 - g0) - covered
        per_unit.append(idle)
    return _median_ms(per_unit)
