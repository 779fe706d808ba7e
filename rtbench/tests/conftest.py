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


TINY = {  # the traffic's samples, by its entry
    "frames": dict(spp=2),
    "sweeps": dict(sweep_spp=2, sweeps_per_image=3),
}


def tiny_cell(name: str, width: int = 16, height: int = 9, tiny_scene: bool = True, **traffic):
    """A cell of BENCHMARK.json cut to a test's size: the frame, the
    traffic's samples, the scene (by its generator's ``tiny``, where it has
    one and ``tiny_scene``) and the pixels compared; its limits are the
    cell's own."""
    from rtbench import harness

    cell = harness.load_cell(name)
    config = dict(cell["config_spec"], width=width, height=height)
    tiny = getattr(harness.load_generator(config["scene"]["generator"]), "tiny", None)
    if tiny_scene and tiny is not None:
        config["scene"] = tiny(config["scene"])
    cell["config_spec"] = config
    entry = cell["traffic_spec"]["entry"]
    cell["traffic_spec"] = dict(cell["traffic_spec"], **{**TINY[entry], **traffic})
    cell["check_spec"] = dict(cell["check_spec"], pixels=48)
    return cell
