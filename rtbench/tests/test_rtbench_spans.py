"""The readers of the program's spans (``rtbench/spans.py`` and the metrics
that use it) on a hand-built trace of two units whose spans and device
operations are known, on the same trace without the program's spans (a
program that has none), and on a traced run on the CPU."""

import time

import numpy as np
import pytest

from rtbench import harness
from rtbench.trace import Trace

from conftest import tiny_cell

MS = 1e-3
READERS = ("launch_prep_ms", "fetch_ms", "sweep_accum_ms", "idle_outside_ms")


def _trace(with_program_spans: bool = True) -> Trace:
    """Two sweeps: [0, 10] ms and [12, 20] ms.

    Sweep 0: prepare 0.4 ms; the kernel ends at 6.0, the copy runs 6.0-7.0
    and the fetch span 1.2-7.5 (1.5 ms after the kernel); the sum 1.0 ms;
    the device idles 0-1.1 and 7.0-12.0 (the next sweep's start), of which
    0-0.5 and 9.5-12.0 lie outside every span: 3.0 ms.
    Sweep 1: prepare 0.2 + 0.1 ms; the kernel ends at 16.0, a fill and the
    copy follow (no kernels), the fetch span 15.0-17.0 (1.0 ms after the
    kernel); the sum 0.2 ms; the device idles 12.0-12.7, 16.0-16.1 and
    16.8-20.0, of which 12.0-12.1 and 19.5-20.0 lie outside: 0.6 ms."""
    t = lambda *xs: [x * MS for x in xs]
    ops = [
        ("megakernel_clustered", *t(1.1, 6.0)),
        ("Memcpy DtoH (Device -> Pageable)", *t(6.0, 7.0)),
        ("megakernel_clustered", *t(12.7, 16.0)),
        ("Memset (Device)", *t(16.1, 16.2)),
        ("Memcpy DtoH (Device -> Pageable)", *t(16.2, 16.8)),
    ]
    host = [
        ("rt.scene.build", *t(-500.0, -100.0)),  # set-up: in no unit
        ("rt.progressive.step", *t(0.5, 9.5)),
        ("rt.progressive.dispatch", *t(0.55, 1.1)),
        ("rt.megakernel.prepare", *t(0.6, 1.0)),
        ("cudaLaunchKernel", *t(1.0, 1.1)),
        ("rt.megakernel.launch", *t(1.0, 1.1)),
        ("rt.progressive.fetch", *t(1.2, 7.5)),
        ("cudaMemcpyAsync", *t(1.2, 7.4)),
        ("rt.progressive.accumulate", *t(7.6, 8.6)),
        ("rt.progressive.step", *t(12.1, 19.5)),
        ("rt.megakernel.prepare", *t(12.2, 12.4)),
        ("rt.megakernel.prepare", *t(12.5, 12.6)),
        ("rt.progressive.fetch", *t(15.0, 17.0)),
        ("rt.progressive.accumulate", *t(17.1, 17.3)),
    ]
    if not with_program_spans:
        host = [h for h in host if not h[0].startswith("rt.")]
    host.sort(key=lambda h: h[1])
    return Trace(
        ops=sorted(ops),
        spans=[("rtbench.unit.sweeps", *t(0.0, 10.0)), ("rtbench.unit.sweeps", *t(12.0, 20.0))],
        host_names=[h[0] for h in host],
        host_start=np.array([h[1] for h in host]),
        host_end=np.array([h[2] for h in host]),
        units=2,
        window=(0.0, 20.0 * MS),
    )


def _read(name: str, tr: Trace):
    return harness.load_metric(name).read({"trace": tr})


@pytest.mark.parametrize("name, expected", [
    ("launch_prep_ms", (0.4 + 0.3) / 2),
    ("fetch_ms", (1.5 + 1.0) / 2),
    ("sweep_accum_ms", (1.0 + 0.2) / 2),
    ("idle_outside_ms", (3.0 + 0.6) / 2),
])
def test_reader_gives_its_number(name, expected):
    assert _read(name, _trace()) == pytest.approx(expected, rel=1e-9, abs=1e-12)


@pytest.mark.parametrize("name", READERS)
def test_reader_is_silent_without_program_spans(name):
    assert _read(name, _trace(with_program_spans=False)) is None


def test_spans_go_to_the_unit_that_holds_them():
    from rtbench import spans

    units = spans.by_unit(_trace())
    assert [len(u) for u in units] == [6, 5]
    assert all(n.startswith("rt.") for u in units for n, _, _ in u)
    assert "rt.scene.build" not in {n for u in units for n, _, _ in u}


@pytest.mark.parametrize("name, expect", [
    ("cover-final", {"fetch_ms"}),
    ("car-preview", {"fetch_ms", "sweep_accum_ms"}),
])
def test_traced_run_on_the_cpu_reads_the_program_spans(name, expect):
    """A traced run keeps the program's spans among the host operations on
    the CPU too (no device operations there, so no idle reading, and the
    plain megakernel has no launch wrapper)."""
    cell = tiny_cell(name, trace_units=3)
    res = harness.run_cell(cell, 2**31 + 977, 0.3, True, "cpu", time.monotonic())
    got = {k for k in READERS if k in res["metrics"]}
    assert got == expect, res["metrics"]
    assert all(res["metrics"][k]["value"] > 0.0 for k in got)
