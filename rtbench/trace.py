"""Reading a ``torch.profiler`` trace of the profiled units: the device's
operations (kernels, copies, fills) by name, start and end, the
benchmark's own spans (``record_function`` ranges around each call into the
program), and the host operations, all on the profiler's one clock.

``Trace`` is what a per-layer metric's reader (``rtbench/metrics/*.py``)
reads, together with the run's set-up timings; ``breakdown``
gives the result line's ``breakdown``: the device operations that took most
time, and the longest idle gaps named by the span and the host operation
that were open when they began.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

from rtbench import stats

SPAN_PREFIX = "rtbench."


@dataclass
class Trace:
    """Times in seconds from the start of the first profiled unit."""

    ops: list[tuple[str, float, float]]  # device operations: (name, start, end)
    spans: list[tuple[str, float, float]]  # the benchmark's spans
    host_names: list[str] = field(default_factory=list)
    host_start: np.ndarray = field(default_factory=lambda: np.zeros(0))
    host_end: np.ndarray = field(default_factory=lambda: np.zeros(0))
    units: int = 0  # profiled units
    window: tuple[float, float] = (0.0, 0.0)  # first unit's start, last unit's end

    def kernels(self) -> list[tuple[str, float, float]]:
        """Device operations that are kernels (not copies or fills)."""
        return [o for o in self.ops if not _is_copy(o[0])]

    def device_seconds(self, pattern: str) -> float:
        """Device time of the kernels whose name matches ``pattern``."""
        rx = re.compile(pattern)
        return sum(e - s for n, s, e in self.ops if rx.search(n))

    def busy_seconds(self) -> float:
        lo, hi = self.window
        return stats.union_length([(max(s, lo), min(e, hi)) for _, s, e in self.ops
                                   if e > lo and s < hi])

    def idle_pct(self) -> float:
        lo, hi = self.window
        return stats.idle_pct([(s, e) for _, s, e in self.ops], lo, hi)


def _is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


def from_profiler(prof, units: int) -> Trace:
    """A ``Trace`` of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    ops, spans, host = [], [], []
    for ev in prof.profiler.kineto_results.events():
        start, end = ev.start_ns(), ev.start_ns() + ev.duration_ns()
        name = ev.name()
        if ev.device_type() == DeviceType.CUDA:
            # The device's copy of a span (a user annotation) is no operation.
            if not (ev.is_user_annotation() or name.startswith(SPAN_PREFIX)):
                ops.append((name, start, end))
            continue
        if name.startswith(SPAN_PREFIX):
            spans.append((name, start, end))
        elif not ev.is_async():
            host.append((name, start, end))
    unit_spans = [s for s in spans if s[0].startswith(SPAN_PREFIX + "unit")]
    t0 = min((s for _, s, _ in unit_spans), default=0)
    t1 = max((e for _, _, e in unit_spans), default=0)
    sec = lambda ns: (ns - t0) * 1e-9
    host.sort(key=lambda h: h[1])
    return Trace(
        ops=sorted((n, sec(s), sec(e)) for n, s, e in ops),
        spans=[(n, sec(s), sec(e)) for n, s, e in spans],
        host_names=[h[0] for h in host],
        host_start=np.array([sec(h[1]) for h in host]),
        host_end=np.array([sec(h[2]) for h in host]),
        units=units,
        window=(0.0, sec(t1)),
    )


def _short(name: str, width: int = 120) -> str:
    return name if len(name) <= width else name[: width - 3] + "..."


def _doing(tr: Trace, t: float) -> str:
    """The benchmark span and the innermost host operation open at ``t``."""
    open_spans = [(s, n) for n, s, e in tr.spans if s <= t < e]
    where = max(open_spans)[1][len(SPAN_PREFIX):] if open_spans else "between spans"
    if len(tr.host_start):
        open_ = np.nonzero((tr.host_start <= t) & (tr.host_end > t))[0]
        if len(open_):
            inner = open_[np.argmax(tr.host_start[open_])]
            return f"{where} > {_short(tr.host_names[inner], 60)}"
    return f"{where} > python"


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, summed by name, and the
    longest idle gaps inside the window, by what the host was doing."""
    by_name: dict[str, float] = {}
    for n, s, e in tr.ops:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = tr.window
    idle = sorted(stats.gaps([(s, e) for _, s, e in tr.ops], lo, hi), key=lambda g: g[0] - g[1])
    return {
        "device_ops": [[_short(n), t] for n, t in ops],
        "idle_gaps": [[_doing(tr, s), e - s] for s, e in idle[:top]],
    }
