"""Tests of the benchmark harness.  They run on the CPU at tiny sizes; the
one test that needs a card is marked ``cuda`` and decides inside the test.

    python3 -m pytest rtbench/tests -q -p no:cacheprovider
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs an NVIDIA GPU; skips elsewhere")


@pytest.fixture
def root():
    return ROOT


TINY = {
    "cover-final": dict(spp=2),
    "car-preview": dict(sweep_spp=2, sweeps_per_image=3),
}


def tiny_cell(name: str, width: int = 16, height: int = 9, car_res: int = 12, car_parts: int = 2,
              **traffic):
    """A cell of BENCHMARK.json cut to a test's size: the frame, the
    traffic's samples, the car's tessellation and the pixels compared; its
    limits are the cell's own."""
    from rtbench import harness

    cell = harness.load_cell(name)
    cell["config_spec"] = dict(cell["config_spec"], width=width, height=height)
    if cell["config_spec"]["scene"]["generator"] == "car":
        cell["config_spec"]["scene"] = dict(cell["config_spec"]["scene"], res=car_res,
                                            n_parts=car_parts)
    cell["traffic_spec"] = dict(cell["traffic_spec"], **{**TINY.get(name, {}), **traffic})
    cell["check_spec"] = dict(cell["check_spec"], pixels=48)
    return cell
