"""The benchmark's arithmetic: rates, percentiles, spreads, busy and idle
shares, rooflines, and the published peaks they are held against.

Frozen with the benchmark, so that a change to the program cannot change
how it is measured.
"""

from __future__ import annotations

import math

# Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
# full 700 W power limit): FP32 outside the tensor cores, and HBM3 bandwidth.
PEAK_FP32_FLOPS = 67.0e12
PEAK_HBM_BYTES_PER_S = 3.35e12


def window_rate(work: list[float], starts: list[float], ends: list[float]) -> float:
    """All the work of the completed units over the wall time from the
    first unit's start to the last unit's end (for ``mray_s``, the work is
    each unit's camera samples, W x H x spp, bounces not counted, as the
    upstream counts them: window.rs:315-324)."""
    return sum(work) / (max(ends) - min(starts))


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0-100) with linear interpolation between the
    closest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def union_length(intervals: list[tuple[float, float]]) -> float:
    """Total length covered by a set of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: list[tuple[float, float]], lo: float, hi: float) -> list[tuple[float, float]]:
    """The parts of [lo, hi] that no interval covers, in order."""
    out, cur = [], lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


def idle_pct(intervals: list[tuple[float, float]], lo: float, hi: float) -> float:
    """Share (%) of [lo, hi] in which no interval (kernel or copy) ran."""
    busy = union_length([(max(s, lo), min(e, hi)) for s, e in intervals if e > lo and s < hi])
    return 100.0 * (1.0 - busy / (hi - lo))


def roofline_pct(flops: float, bytes_moved: float, seconds: float) -> float:
    """Share (%) of the least time the chip could take, the larger of the
    operations over the FP32 peak and the bytes over the HBM peak, in the
    measured time."""
    return 100.0 * max(flops / PEAK_FP32_FLOPS, bytes_moved / PEAK_HBM_BYTES_PER_S) / seconds
