"""The progressive renderer's sum on the card: the sweep-sum kernel
(``csrc/sweep_sum.cu``) against numpy's ``accum + colors * ns``, and
progressive runs on the card whose ``state.accum`` equals the host's sum of
the same sweeps' colours, bit for bit, resumed or not.

Every test needs a card and skips without one.  This file imports nothing
of the JAX package, so that it also runs on a machine without the JAX
package's dependencies.
"""

import numpy as np
import pytest
import torch

from rt_tpu_torch import megakernel, progressive, scenes
from rt_tpu_torch.config import ProgressiveSchedule, RenderConfig
from rt_tpu_torch.fixtures import make_glb_armor
from rt_tpu_torch.io.gltf_loader import add_gltf_to_scene
from rt_tpu_torch.progressive import ProgressiveRenderer, accumulate_sweep
from rt_tpu_torch.scene import SceneBuilder

W, H = 24, 14
CFG = RenderConfig(width=W, height=H, max_depth=6, seed=5)
SCHEDULE = ProgressiveSchedule(ramp=(1, 2, 4), sustain_64=0, sustain_128=0, sustain_256=0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")


def _scene(kind, tmp_path):
    """(scene, engine): the cover on K1 or the wavefront, the armor glb on K5."""
    cam = scenes.cam1(W, H)
    if kind == "armor":
        path = str(tmp_path / "armor.glb")
        make_glb_armor(path, res=10, n_parts=2)
        b = SceneBuilder()
        add_gltf_to_scene(b, path)
        return b.build(), "mega"
    return scenes.cover_scene(2, 2, cam, seed=0), kind


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 6, 4099, 3 * 1920 * 1080])
@pytest.mark.parametrize("ns", [1, 3, 4, 7, 256])
def test_sweep_sum_kernel_is_numpy_bit_for_bit(ns, n):
    _card()
    rng = np.random.default_rng(1000 * ns + n)
    accum = (rng.standard_normal(n) * 10.0 ** rng.uniform(-42, 30, n)).astype(np.float32)
    colors = (rng.standard_normal(n) * 10.0 ** rng.uniform(-42, 30, n)).astype(np.float32)
    want = accum + colors * ns
    got = torch.from_numpy(accum).cuda()
    before = progressive.DEVICE_SUMS
    accumulate_sweep(got, torch.from_numpy(colors).cuda(), ns)
    torch.cuda.synchronize()
    assert progressive.DEVICE_SUMS == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.cuda
def test_sweep_sum_refuses_what_the_kernel_cannot_take():
    _card()
    accum = torch.zeros(64, device="cuda")
    with pytest.raises(ValueError, match="aligned"):
        accumulate_sweep(accum[1:], torch.ones(63, device="cuda"), 1)
    with pytest.raises(ValueError, match="contiguous"):
        accumulate_sweep(accum, torch.ones(64, device="cuda", dtype=torch.float64), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mega", "wavefront", "armor"])
def test_progressive_on_the_card_sums_like_the_host(kind, tmp_path, monkeypatch):
    """Three sweeps on the card (K1, the wavefront, K5): state.accum, the
    same array all along, is the host's numpy sum of the sweeps' colours
    times their spp, and each sweep was summed by the kernel."""
    _card()
    scene, engine = _scene(kind, tmp_path)
    seen = []
    target, name = ((megakernel, "render_megakernel") if engine == "mega"
                    else (progressive, "render_wavefront"))
    real = getattr(target, name)

    def recorded(*a, **kw):
        out = real(*a, **kw)
        seen.append(out.cpu().numpy())
        return out

    monkeypatch.setattr(target, name, recorded)
    r = ProgressiveRenderer(scene, scenes.cam1(W, H), CFG, schedule=SCHEDULE, engine=engine,
                            device="cuda")
    assert r.engine == engine
    accum = r.state.accum
    before = progressive.DEVICE_SUMS
    r.run()
    assert progressive.DEVICE_SUMS == before + 3 and len(seen) == 3
    assert r.state.accum is accum and r.state.total_spp == 7
    want = np.zeros((H, W, 3), np.float32)
    for colors, ns in zip(seen, (1, 2, 4)):
        want += colors.reshape(H, W, 3) * ns
    np.testing.assert_array_equal(r.state.accum, want)
    assert want.max() > 0


@pytest.mark.cuda
def test_resumed_run_on_the_card_is_exact(tmp_path):
    """Two sweeps, a checkpoint, a fresh renderer that resumes it and runs
    the third: the accumulator of three straight sweeps, bit for bit."""
    _card()
    scene, _ = _scene("mega", tmp_path)
    cam = scenes.cam1(W, H)
    make = lambda **kw: ProgressiveRenderer(scene, cam, CFG, schedule=SCHEDULE, engine="mega",
                                            device="cuda", **kw)
    whole = make()
    whole.run()
    ckpt = str(tmp_path / "ck.npz")
    make(checkpoint_path=ckpt).run(max_passes=2)
    resumed = make(checkpoint_path=ckpt)
    accum = resumed.state.accum
    assert resumed.state.pass_index == 2
    resumed.run()
    assert resumed.state.accum is accum and resumed.state.total_spp == 7
    np.testing.assert_array_equal(resumed.state.accum, whole.state.accum)


@pytest.mark.cuda
def test_card_accum_is_a_read_only_mirror(tmp_path):
    """On the card state.accum mirrors the device's sum, which the next
    sweep's copy overwrites: a write into it raises instead of vanishing."""
    _card()
    scene, _ = _scene("mega", tmp_path)
    r = ProgressiveRenderer(scene, scenes.cam1(W, H), CFG, schedule=SCHEDULE, engine="mega",
                            device="cuda")
    r.step()
    with pytest.raises(ValueError, match="read-only"):
        r.state.accum[...] = 0.0
    assert r.state.accum.max() > 0
