"""Profiling and structured metrics (rt_tpu/profiling.py).

Reference analog (SURVEY.md §5.1, §5.5): per-sweep and cumulative Mray/s
prints (window.rs:315-324) and indicatif progress bars.  The Mray/s
definition is the reference's: camera samples only, bounces not counted.
``device_trace`` records a ``torch.profiler`` trace (host and, where a card
is present, device activity) and writes it as a Chrome trace; ``cli --trace``
is its front end.

``span`` marks the package's layer boundaries (a frame, a sweep, a
launch's preparation, the fetch to the host, set-up steps) as
``record_function`` ranges named ``rt.<layer>.<step>``, on the profiler's
clock beside the card's kernels and copies.  A span records only while a
profiler records; otherwise it costs one flag test and does nothing.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from dataclasses import dataclass, field

import torch

SPAN_PREFIX = "rt."

_profiler_enabled = torch._C._autograd._profiler_enabled
_NO_SPAN = contextlib.nullcontext()


def span(name: str, args=None):
    """A context manager: the range ``rt.<name>`` (``args``, if given, as
    its string argument) while a ``torch.profiler`` profile records, and a
    shared null context otherwise.  It adds no synchronization, device
    operation or copy, so it changes no result."""
    if not _profiler_enabled():
        return _NO_SPAN
    return torch.profiler.record_function(SPAN_PREFIX + name,
                                          None if args is None else str(args))


def mray_per_s(width: int, height: int, spp: int, seconds: float) -> float:
    """The reference's throughput formula (window.rs:317-323): camera
    samples only; bounce rays are NOT counted."""
    return spp * width * height / 1.0e6 / max(seconds, 1.0e-12)


@contextlib.contextmanager
def device_trace(path: str):
    """Profile the enclosed block with ``torch.profiler`` (CPU activity,
    plus CUDA activity when a card is present) and write a Chrome trace
    to ``path``, viewable in Perfetto or chrome://tracing.  Yields the
    profiler, whose ``key_averages()`` sums time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)


@dataclass
class MetricsLog:
    """Append-only JSONL metrics with wall-clock stamps (§5.5)."""

    path: str | None = None
    _start: float = field(default_factory=time.perf_counter)

    def log(self, **fields) -> dict:
        record = {"t_wall_s": round(time.perf_counter() - self._start, 6), **fields}
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(record) + "\n")
        return record


class ProgressBar:
    """Terminal progress bar, the indicatif analog (camera.rs:332): one
    line redrawn with a carriage return, ETA from the cumulative rate."""

    def __init__(self, total: int, unit: str = "sweeps", width: int = 28, stream=None):
        self.total = max(total, 1)
        self.unit = unit
        self.width = width
        self.stream = stream if stream is not None else sys.stderr
        self.done = 0
        self._start = time.perf_counter()

    def update(self, done: int, suffix: str = "") -> None:
        self.done = min(done, self.total)
        frac = self.done / self.total
        filled = int(frac * self.width)
        bar = "#" * filled + "-" * (self.width - filled)
        elapsed = time.perf_counter() - self._start
        eta = elapsed * (1.0 - frac) / frac if frac > 0 else float("inf")
        eta_s = f"{eta:.0f}s" if eta < 1e4 else "--"
        self.stream.write(
            f"\r[{bar}] {self.done}/{self.total} {self.unit} "
            f"({100.0 * frac:3.0f}%) eta {eta_s} {suffix}"
        )
        self.stream.flush()
        if self.done >= self.total:
            self.stream.write("\n")


class ThroughputTimer:
    """Per-sweep and cumulative Mray/s, the reference's two printed figures
    (window.rs:315-324).  ``sweep_s`` is the last sweep's wall seconds,
    from the same two clock readings as its Mray/s."""

    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.total_rays = 0
        self.sweep_s = 0.0
        self._start = time.perf_counter()
        self._sweep_start = self._start

    def begin_sweep(self):
        self._sweep_start = time.perf_counter()

    def end_sweep(self, spp: int) -> tuple[float, float]:
        now = time.perf_counter()
        rays = spp * self.width * self.height
        self.total_rays += rays
        self.sweep_s = now - self._sweep_start
        sweep = rays / 1.0e6 / max(self.sweep_s, 1e-12)
        cumulative = self.total_rays / 1.0e6 / max(now - self._start, 1e-12)
        return sweep, cumulative
