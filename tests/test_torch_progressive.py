"""Progressive refinement, checkpoints, the CLI's --progressive and the
profiling helpers, against the JAX package's.

Images are compared at atol/rtol 1e-3 per value, the tolerance of
tests/test_torch_wavefront.py: each sweep is one wavefront render on the
same hash streams.
"""

import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from rt_tpu_torch import megakernel, profiling, progressive, scenes
from rt_tpu_torch.config import ProgressiveSchedule, RenderConfig
from rt_tpu_torch.progressive import ProgressiveRenderer, accumulate_sweep

torch.set_num_threads(2)

TOL = dict(rtol=1e-3, atol=1e-3)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 16, 12


def _setup():
    camera = scenes.cam1(W, H)
    return scenes.cover_scene(2, 2, camera, seed=0), camera, RenderConfig(width=W, height=H,
                                                                          max_depth=6)


def _three_passes(module):
    return module.ProgressiveSchedule(ramp=(1, 2, 4), sustain_64=0, sustain_128=0, sustain_256=0)


def _jax_renderer(**kw):
    from rt_tpu import config as jconfig, scenes as jscenes
    from rt_tpu.progressive import ProgressiveRenderer as JRenderer

    camera = jscenes.cam1(W, H)
    scene = jscenes.cover_scene(2, 2, camera, seed=0)
    cfg = jconfig.RenderConfig(width=W, height=H, max_depth=6)
    return JRenderer(scene, camera, cfg, schedule=_three_passes(jconfig), **kw)


def _renderer(**kw):
    from rt_tpu_torch import config

    scene, camera, cfg = _setup()
    return ProgressiveRenderer(scene, camera, cfg, schedule=_three_passes(config), device="cpu",
                               **kw)


@pytest.mark.parametrize("reuse", [True, False])
def test_schedule_and_three_passes_match_jax(reuse, capsys):
    """Three sweeps against JAX's, with the sample indices restarting at 0
    every pass (the reference's quirk) and advancing across passes."""
    passes = ProgressiveSchedule.reference().passes()
    assert len(passes) == 237 and sum(passes) == 40055  # window.rs:233-247
    ref = _jax_renderer(reuse_sample_indices=reuse).run()
    r = _renderer(reuse_sample_indices=reuse)
    got = r.run()
    assert r.state.total_spp == 7 and r.state.pass_index == 3 and r.step() is None
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    out = capsys.readouterr().out
    assert "On sweep 3 adding 4 sample(s) for a total of 7 sample(s) per pixel" in out
    assert "million rays/second" in out


def test_checkpoint_resume_is_exact(tmp_path):
    """Two sweeps, a checkpoint, a fresh renderer that resumes it and runs
    the third: the image of the uninterrupted run, bit for bit."""
    whole = _renderer().run()
    ckpt = str(tmp_path / "ck.npz")
    first = _renderer(checkpoint_path=ckpt)
    first.run(max_passes=2)
    second = _renderer(checkpoint_path=ckpt)
    assert second.state.pass_index == 2 and second.state.total_spp == 3
    np.testing.assert_array_equal(second.state.accum, first.state.accum)
    assert second.step()["sweep"] == 3
    np.testing.assert_array_equal(second.state.image, whole)
    with np.load(ckpt) as data:
        assert sorted(data.files) == ["accum", "pass_index", "seed", "total_spp"]
        assert int(data["pass_index"]) == 3


def test_accumulator_is_the_numpy_sum_of_the_sweeps(monkeypatch):
    """Three sweeps on the "mega" engine: state.accum, the same array all
    along, equals numpy's sum of each sweep's colours times its spp bit for
    bit, and no sweep went through the card's kernel."""
    seen = []
    real = megakernel.render_megakernel

    def recorded(*a, **kw):
        out = real(*a, **kw)
        seen.append(out.numpy().copy())
        return out

    monkeypatch.setattr(megakernel, "render_megakernel", recorded)
    sums = progressive.DEVICE_SUMS
    r = _renderer(engine="mega")
    accum = r.state.accum
    r.step()
    assert r.state.accum is accum
    r.run()
    assert r.state.accum is accum and len(seen) == 3
    want = np.zeros((H, W, 3), np.float32)
    for colors, ns in zip(seen, (1, 2, 4)):
        want += colors.reshape(H, W, 3) * ns
    np.testing.assert_array_equal(r.state.accum, want)
    assert progressive.DEVICE_SUMS == sums


def test_load_checkpoint_fills_the_same_array(tmp_path):
    """A checkpoint loaded into a running renderer lands in the array
    state.accum already is, and the next sweep adds onto it; an image of
    another size is refused."""
    ckpt = str(tmp_path / "ck.npz")
    first = _renderer(checkpoint_path=ckpt)
    first.run(max_passes=2)
    r = _renderer()
    accum = r.state.accum
    r.load_checkpoint(ckpt)
    assert r.state.accum is accum and r.state.pass_index == 2 and r.state.total_spp == 3
    np.testing.assert_array_equal(accum, first.state.accum)
    r.step()
    assert r.state.accum is accum
    np.testing.assert_array_equal(r.state.image, _renderer().run())
    small = str(tmp_path / "small.npz")
    np.savez(small, accum=np.zeros((H, W - 1, 3), np.float32), total_spp=3, pass_index=2,
             seed=r.cfg.seed)
    with pytest.raises(ValueError, match="image"):
        r.load_checkpoint(small)


@pytest.mark.parametrize("ns", [1, 3, 4, 7, 256])
def test_plain_sweep_sum_is_numpy(ns):
    """The CPU's sweep sum: numpy's accum + colors * ns bit for bit, over
    large and tiny magnitudes and a length not divisible by 4."""
    rng = np.random.default_rng(ns)
    n = 3 * 7 * 5
    accum = (rng.standard_normal(n) * 10.0 ** rng.uniform(-40, 30, n)).astype(np.float32)
    colors = (rng.standard_normal(n) * 10.0 ** rng.uniform(-40, 30, n)).astype(np.float32)
    got = torch.from_numpy(accum.copy()).reshape(7, 5, 3)
    accumulate_sweep(got, torch.from_numpy(colors), ns)
    np.testing.assert_array_equal(got.numpy().reshape(-1), accum + colors * ns)


def test_jax_checkpoint_resumes_in_port(tmp_path):
    ckpt = str(tmp_path / "jax.npz")
    j = _jax_renderer(checkpoint_path=ckpt)
    j.run(max_passes=2)
    r = _renderer(checkpoint_path=ckpt)
    assert r.state.pass_index == 2 and r.state.total_spp == 3
    np.testing.assert_array_equal(r.state.accum, j.state.accum)
    r.step()
    j.step()
    np.testing.assert_allclose(r.state.image, j.state.image, **TOL)
    wrong = str(tmp_path / "other_seed.npz")
    np.savez(wrong, accum=r.state.accum, total_spp=7, pass_index=3, seed=5)
    with pytest.raises(ValueError, match="seed"):
        _renderer(checkpoint_path=wrong)


def test_run_stops_and_mega_engine(tmp_path):
    metrics = str(tmp_path / "m.jsonl")
    r = _renderer(metrics_path=metrics, engine="mega")
    assert r.engine == "mega"
    seen = []
    r.run(max_passes=3, on_sweep=lambda img, m: seen.append(m["sweep"]),
          should_stop=lambda: len(seen) >= 2)
    assert seen == [1, 2]
    lines = [json.loads(line) for line in open(metrics)]
    assert [line["sweep"] for line in lines] == [1, 2] and "t_wall_s" in lines[0]
    assert np.isfinite(r.state.image).all() and r.state.image.max() > 0
    with pytest.raises(ValueError, match="engine"):
        _renderer(engine="bogus")


def test_cli_progressive_writes_png(tmp_path):
    from PIL import Image

    out, ckpt = str(tmp_path / "p.png"), str(tmp_path / "p.npz")
    proc = subprocess.run(
        [sys.executable, "-m", "rt_tpu_torch.cli", "--scene", "cover", "--size", "24x16",
         "--max-depth", "6", "--progressive", "--passes", "2", "--checkpoint", ckpt,
         "--device", "cpu", "--out", out],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "On sweep 2 adding 2 sample(s)" in proc.stdout
    assert Image.open(out).size == (24, 16)
    with np.load(ckpt) as data:
        assert int(data["total_spp"]) == 3 and int(data["pass_index"]) == 2


def test_profiling_helpers(tmp_path):
    assert profiling.mray_per_s(800, 600, 2, 1.0) == 800 * 600 * 2 / 1e6  # window.rs:317-323
    timer = profiling.ThroughputTimer(100, 50)
    timer.begin_sweep()
    time.sleep(0.01)
    sweep, cumulative = timer.end_sweep(4)
    assert sweep > 0 and cumulative > 0 and timer.total_rays == 4 * 100 * 50
    path = str(tmp_path / "m.jsonl")
    log = profiling.MetricsLog(path)
    log.log(sweep=1, mray=3.5)
    log.log(sweep=2, mray=4.0)
    lines = [json.loads(line) for line in open(path)]
    assert lines[0]["sweep"] == 1 and "t_wall_s" in lines[0] and lines[1]["mray"] == 4.0
    buf = io.StringIO()
    bar = profiling.ProgressBar(4, stream=buf)
    bar.update(1, "x")
    bar.update(4, "done")
    assert "1/4" in buf.getvalue() and buf.getvalue().endswith("\n")
    trace = str(tmp_path / "trace.json")
    with profiling.device_trace(trace) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof.key_averages() and "traceEvents" in json.load(open(trace))
