"""Card-only checks of the live Hosek-Wilkie sky and glTF scenes: K1 and K5
against their plain versions bit for bit, and the sky's configuration on
the card against the CPU.  Every test is ``cuda``-marked and skips without
a card.  The file imports no JAX and no ``rt_tpu``, so that it collects on
a card's host that has no JAX package.

Serial CPU time of this file: under 1 s (every test skips).
"""

import numpy as np
import pytest
import torch

from rt_tpu_torch import fixtures, megakernel, scenes, sky
from rt_tpu_torch.camera import make_camera
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.io.gltf_loader import add_gltf_to_scene
from rt_tpu_torch.scene import SceneBuilder
from rt_tpu_torch.sky import SkyParams

W, H = 32, 24


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_hosek_config_on_the_card_equals_the_cpu():
    dev = _card()
    for point in ((3.0, 0.3, 0.8), (8.0, 0.1, 0.07), (12.0, 1.0, 1.6)):
        on_card = sky.hosek_config(*(torch.tensor(v, device=dev) for v in point))
        assert on_card.device.type == "cuda"
        torch.testing.assert_close(on_card.cpu(), sky.hosek_config(*point), atol=1e-6, rtol=1e-5)


@pytest.mark.cuda
def test_k1_under_live_sky_equals_plain():
    dev = _card()
    camera = scenes.cam1(W, H)
    scene = scenes.cover_scene(4, 4, camera, z=-0.2, seed=0)
    scene.sky = SkyParams.hosek(3.0, 0.3, 0.8)
    scene.to(dev)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=2, max_depth=12)
    got = megakernel.render_megakernel(scene, camera, cfg, 2, 0, 0)
    ref = megakernel.render_megakernel_plain(scene, camera, cfg, 2, 0, 0)
    assert torch.equal(got, ref)


@pytest.mark.cuda
def test_k5_on_a_glb_under_live_sky_equals_plain(tmp_path):
    dev = _card()
    path = str(tmp_path / "small.glb")
    fixtures.make_glb_armor(path, res=12, n_parts=2)
    b = SceneBuilder()
    add_gltf_to_scene(b, path)
    scene = b.build(sky=SkyParams.hosek(3.0, 0.3, 0.8)).to(dev)
    d, h = 5.5, 2.2
    camera = make_camera((d, -d, h), (0.0, 0.0, 1.0), (0.0, 0.0, 1.0),
                         focus_distance=float((2 * d * d + (h - 1) ** 2) ** 0.5),
                         defocus_angle=0.0, image_width=W, image_height=H, vertical_fov=32.0)
    cfg = RenderConfig(width=W, height=H, samples_per_pixel=2, max_depth=6)
    assert megakernel.eligible_clustered(scene, cfg)
    got = megakernel.render_megakernel(scene, camera, cfg, 2, 0, 0)
    ref = megakernel.render_megakernel_plain(scene, camera, cfg, 2, 0, 0)
    assert torch.equal(got, ref) and float(np.asarray(ref.cpu()).std()) > 0.05
