"""The port's main path on the CPU: the cover scene against the JAX
megakernel, the entry points, the CLI, and what must raise.

Tolerance for images: atol 1e-3, rtol 1e-3, the JAX package's own
megakernel parity tolerance (tests/test_megakernel.py).
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rt_tpu import scenes as jscenes
from rt_tpu.config import RenderConfig as JConfig
from rt_tpu.megakernel import render_megakernel as j_render_megakernel
from rt_tpu.wavefront import _render_generic
from rt_tpu_torch import _build, megakernel, scenes
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.render import render_image, render_pixel_colors

torch.set_num_threads(2)

W, H = 32, 24
TOL = dict(atol=1e-3, rtol=1e-3)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cover_scene_matches_jax_megakernel():
    """The bench configuration in miniature (checker ground triangles,
    glass, metal and the image-textured sphere) against the TPU kernel run
    in interpret mode, with the exact (t, id) winner selection."""
    jcam, tcam = jscenes.cam1(W, H), scenes.cam1(W, H)
    jscene = jscenes.cover_scene(4, 4, jcam, z=-0.2, seed=0)
    tscene = scenes.cover_scene(4, 4, tcam, z=-0.2, seed=0)
    jcfg = JConfig(width=W, height=H, samples_per_pixel=2, max_depth=12)
    tcfg = RenderConfig(width=W, height=H, samples_per_pixel=2, max_depth=12)
    ref = np.asarray(j_render_megakernel(
        jscene, jcam, jcfg, 2, 0, jax.random.key(0),
        lanes=256, tile_pixels=256, packed_select=False, interpret=True))
    got = megakernel.render_megakernel(tscene, tcam, tcfg, 2, 0, 0).numpy()
    np.testing.assert_allclose(got, ref, **TOL)


def test_sample_offset_and_pixel_base_match_generic():
    """A nonzero sample offset, and a half-frame pixel range, against
    _render_generic (tests/test_megakernel.py's multi-tile case)."""
    jcam, tcam = jscenes.cam1(W, H), scenes.cam1(W, H)
    jscene = jscenes.cover_scene(3, 3, jcam, z=-0.2, seed=1)
    tscene = scenes.cover_scene(3, 3, tcam, z=-0.2, seed=1)
    jcfg = JConfig(width=W, height=H, samples_per_pixel=2, max_depth=8)
    tcfg = RenderConfig(width=W, height=H, samples_per_pixel=2, max_depth=8)
    ref = np.asarray(_render_generic(
        jscene, jcam, jnp.arange(W * H, dtype=jnp.int32), jcfg, 2, jnp.int32(3), jax.random.key(0)))
    got = megakernel.render_megakernel(tscene, tcam, tcfg, 2, 3, 0).numpy()
    np.testing.assert_allclose(got, ref, **TOL)
    half = W * H // 2
    got2 = megakernel.render_megakernel(tscene, tcam, tcfg, 2, 3, 0, pixel_base=half, n_pixels=half)
    np.testing.assert_allclose(got2.numpy(), ref[half:], **TOL)
    np.testing.assert_array_equal(got2.numpy(), got[half:])


def test_render_image_on_cpu():
    camera = scenes.cam1(32, 18)
    scene = scenes.cover_scene(3, 3, camera, seed=2)
    cfg = RenderConfig(width=32, height=18, samples_per_pixel=2, max_depth=10)
    img, metrics = render_image(scene, camera, cfg, device="cpu")
    assert img.shape == (18, 32, 3) and img.dtype == np.float32
    assert np.isfinite(img).all() and 0.02 < img.mean() < 2.0
    assert metrics["rays"] == 2 * 32 * 18 and metrics["device"] == "cpu"
    assert metrics["mray_per_s"] == pytest.approx(metrics["rays"] / 1e6 / metrics["wall_s"])
    flat = render_pixel_colors(scene, camera, cfg, device="cpu", spp=1, sample_offset=1)
    np.testing.assert_array_equal(
        flat.numpy().reshape(-1, 3),
        megakernel.render_megakernel(scene, camera, cfg, 1, 1, 0).numpy(),
    )


def test_cli_writes_png(tmp_path, capsys, monkeypatch):
    import json

    from PIL import Image

    from rt_tpu_torch import cli

    out = tmp_path / "cover.png"
    assert cli.main(["--scene", "cover", "--size", "32x18", "--spp", "1", "--max-depth", "8",
                     "--device", "cpu", "--out", str(out)]) == 0
    assert Image.open(out).size == (32, 18)
    # The front ends run: the probe prints its dict, and a progressive pass
    # feeds the terminal preview and the HTTP viewer (tests/test_torch_front_ends.py
    # holds them against the JAX package).
    capsys.readouterr()
    assert cli.main(["--scene", "cover", "--size", "32x18", "--probe", "16,12",
                     "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out)["material"] == "Lambertian"
    monkeypatch.setenv("TERM", "xterm-256color")  # the ANSI terminal preview
    prog = tmp_path / "prog.png"
    assert cli.main(["--scene", "cover", "--size", "32x18", "--max-depth", "8", "--progressive",
                     "--passes", "1", "--term-preview", "--serve", "0", "--device", "cpu",
                     "--out", str(prog)]) == 0
    captured = capsys.readouterr()
    assert "\x1b[38;2;" in captured.out and "preview at http://localhost:" in captured.err
    assert Image.open(prog).size == (32, 18)


def test_config_is_the_jax_config_without_its_tpu_fields():
    """The port's RenderConfig has the JAX RenderConfig's fields, in its
    order and with its defaults, minus exactly the four that steer only
    TPU mechanisms."""
    jax_fields = [f.name for f in dataclasses.fields(JConfig)]
    fields = [f.name for f in dataclasses.fields(RenderConfig)]
    assert set(jax_fields) - set(fields) == {"sort_rays", "sort_every", "bin_lanes", "expand_sweep"}
    assert fields == [name for name in jax_fields if name in fields]
    jax_cfg, cfg = JConfig(), RenderConfig()
    for name in fields:
        if name == "compat":
            assert dataclasses.asdict(cfg.compat) == dataclasses.asdict(jax_cfg.compat)
        else:
            assert getattr(cfg, name) == getattr(jax_cfg, name), name


def test_import_loads_no_jax():
    code = (
        "import sys\n"
        "import rt_tpu_torch, rt_tpu_torch.cli, rt_tpu_torch.convert, rt_tpu_torch.megakernel\n"
        "import rt_tpu_torch.render, rt_tpu_torch.scenes, rt_tpu_torch.io, rt_tpu_torch._build\n"
        "import rt_tpu_torch.wavefront, rt_tpu_torch.progressive, rt_tpu_torch.profiling\n"
        "import rt_tpu_torch.materials, rt_tpu_torch.textures, rt_tpu_torch.prim_ops\n"
        "import rt_tpu_torch.cluster, rt_tpu_torch.cluster_ops, rt_tpu_torch.io.obj_loader\n"
        "import rt_tpu_torch.bvh.builder, rt_tpu_torch.bvh.native, rt_tpu_torch.bvh.traverse\n"
        "import rt_tpu_torch.micro_probe, rt_tpu_torch.grad, rt_tpu_torch.sampling\n"
        "import rt_tpu_torch.io.gltf_loader, rt_tpu_torch.io.png_io, rt_tpu_torch.fixtures\n"
        "import rt_tpu_torch.debug, rt_tpu_torch.viewer, rt_tpu_torch.term_preview\n"
        "import rt_tpu_torch.parallel, rt_tpu_torch.graft_entry\n"
        "import bench_cuda, bench_grad_cuda, bench_scenes_cuda, cluster_bench_cuda\n"
        "import bench_scaling_cuda, walk_counts_cuda\n"
        "from rt_tpu_torch.bvh import native\n"
        "assert native.available(), 'the port builds its own BVH library'\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'rt_tpu', 'flax', 'tools', 'PIL'))\n"
        "assert not bad, bad\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    camera = scenes.cam1(8, 6)
    scene = scenes.gen_checkered()
    cfg = RenderConfig(width=8, height=6, samples_per_pixel=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_pixel_colors(scene, camera, cfg, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        render_image(scene, camera, cfg, device="cuda")
    with pytest.raises(ValueError, match="unknown renderer"):
        render_pixel_colors(scene, camera, cfg.replace(renderer="bogus"), device="cpu")


def test_kernel_build_raises_without_nvcc(monkeypatch):
    """A missing compiler is an error, never a silent fallback."""
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build._nvcc()
