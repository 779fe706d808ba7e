"""``correct`` comes out false when the timed path is broken underneath, and
the bfloat16 control fails the check.  Each run skips the look for a card
and drives the rest of a run on the CPU at a tiny size, with the cell's own
limits.  (One card a cell: there is no exchange between chips to leave out.)
"""

import time

import numpy as np
import pytest

from rtbench import control, harness

from conftest import tiny_cell

SEED = 2**31 + 977
CELLS = ["cover-final", "car-preview"]


def _run(cell):
    return harness.run_cell(cell, SEED, 0.3, False, "cpu", time.monotonic())


def _frames_fault(mp, fault):
    from rt_tpu_torch import megakernel, render

    real_image, real_mega = render.render_image, megakernel.render_megakernel
    if fault == "unchanged":  # every frame is the first one
        first = {}

        def stale(scene, camera, cfg, **kw):
            first.setdefault("img", real_image(scene, camera, cfg, **kw))
            return first["img"]

        mp.setattr(render, "render_image", stale)
    elif fault == "half":  # half the samples, the mean over the rest
        mp.setattr(megakernel, "render_megakernel",
                   lambda scene, camera, cfg, spp, *a, **kw:
                   real_mega(scene, camera, cfg, max(spp // 2, 1), *a, **kw))
    else:  # every answer altered where it is produced
        mp.setattr(megakernel, "render_megakernel", lambda *a, **kw: real_mega(*a, **kw) + 0.02)


def _sweeps_fault(mp, fault, engine):
    from rt_tpu_torch import megakernel, progressive

    if fault == "unchanged":  # the sweep leaves the accumulator as it was
        real_step = progressive.ProgressiveRenderer.step

        def step(self):
            before = self.state.accum.copy()
            out = real_step(self)
            self.state.accum[...] = before
            return out

        mp.setattr(progressive.ProgressiveRenderer, "step", step)
        return
    if engine == "mega":
        target, name = megakernel, "render_megakernel"
        real = megakernel.render_megakernel
        half = lambda scene, camera, cfg, spp, *a, **kw: real(
            scene, camera, cfg, max(spp // 2, 1), *a, **kw)
    else:
        target, name = progressive, "render_wavefront"
        real = progressive.render_wavefront
        half = lambda scene, camera, pix, cfg, spp, *a, **kw: real(
            scene, camera, pix, cfg, max(spp // 2, 1), *a, **kw)
    altered = lambda *a, **kw: real(*a, **kw) + 0.02
    mp.setattr(target, name, half if fault == "half" else altered)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = _run(tiny_cell(name))
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0, res["check"]
    # The contract's keys, then the numbers compared beside their limits,
    # under a key of their own that comes last.
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "check"]
    assert set(res["check"]) == set(tiny_cell(name)["check_spec"]["limits"])
    assert all(set(v) == {"value", "limit"} for v in res["check"].values())


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_run_is_not_correct(name, fault, monkeypatch):
    cell = tiny_cell(name)
    entry = cell["traffic_spec"]["entry"]
    if entry == "frames":
        _frames_fault(monkeypatch, fault)
    else:
        _sweeps_fault(monkeypatch, fault, cell["traffic_spec"]["engine"])
    res = _run(cell)
    assert not res["correct"], res["check"]


@pytest.mark.parametrize("name", CELLS)
def test_bfloat16_control_fails(name):
    cell = tiny_cell(name)
    nums = control.control_numbers(cell, SEED, "cpu", sweeps=2)
    limits = cell["check_spec"]["limits"]
    assert all(np.isfinite(v) for v in nums.values()), nums
    assert any(nums[k] > v for k, v in limits.items()), nums
