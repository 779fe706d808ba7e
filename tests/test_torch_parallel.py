"""The port's sharding (rt_tpu_torch.parallel, graft_entry) against the JAX
package's (rt_tpu.parallel on the conftest's 8-device CPU mesh), and
against itself: every shard of a mesh run in this one process and
assembled, plus the collective path at world size 1 and one spawned
4-rank gloo run.  Serial CPU time of the file: about 65 s (the spawned run
about 22 s of it, the JAX references about 30 s).

Tolerances:
- global work ids (``render_chunk(work=...)``): a batch cut into pieces,
  each keyed on its rows' ids in the whole batch, equals the whole batch
  bit for bit; ``work=None`` equals ``work=arange``;
- renders against JAX's ``render_sharded`` and the wavefront against
  ``render_sharded_wavefront``: atol 1e-3, rtol 1e-3, the megakernel
  parity tolerance (tests/test_megakernel.py);
- the port against its own single shard: bit-equal on tile meshes (the
  same rows, keys and sums), atol 1e-6 with an spp axis (partial sums in
  another order), as tests/test_distributed.py holds the JAX meshes; the
  sharded wavefront and megakernels bit-equal whatever the split;
- the training step against JAX's ``train_step_sharded``: the loss at
  rtol 1e-5 and each parameter update (new - old) / lr at |d| <= 1e-3
  |ref| + 1e-3 max|ref|, tests/test_torch_grad.py's gradient tolerance;
  against the port's single shard at atol 1e-6 (test_distributed.py).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rt_tpu import parallel as jpar
from rt_tpu import scenes as jscenes
from rt_tpu.config import RenderConfig as JConfig
from rt_tpu_torch import grad, graft_entry, megakernel, parallel, rng, scenes
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.render import render_chunk
from rt_tpu_torch.scene import SceneBuilder

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(atol=1e-3, rtol=1e-3)
W, H = 32, 16
N_PIX = W * H


def _cfgs(**kw):
    base = dict(width=W, height=H, samples_per_pixel=2, max_depth=6, diff_max_depth=3)
    base.update(kw)
    return JConfig(**base), RenderConfig(**base)


@pytest.fixture(scope="module")
def setup():
    """tests/test_distributed.py's scene in both packages."""
    jcam, tcam = jscenes.cam1(W, H), scenes.cam1(W, H)
    jscene = jscenes.cover_scene(2, 2, jcam, z=-0.2, seed=0)
    tscene = scenes.cover_scene(2, 2, tcam, z=-0.2, seed=0)
    jcfg, tcfg = _cfgs()
    return jscene, jcam, jcfg, tscene, tcam, tcfg


def _generic_scene():
    """Spheres under a checker with an image child (no shade table: the
    generic bounce and its threefry draws)."""
    rs = np.random.default_rng(3)
    b = SceneBuilder()
    img = rs.uniform(0, 1, (6, 5, 3)).astype(np.float32)
    solid = b.solid_color((0.2, 0.5, 0.8))
    mats = [b.lambertian(b.checker(0.4, b.image_texture(img), solid)), b.metal(solid, 0.3),
            b.dielectric(1.5), b.lambertian(solid)]
    for k in range(12):
        c = rs.uniform(-1.5, 1.5, 3)
        c[2] = rs.uniform(0.0, 1.0)
        b.add_sphere(c, rs.uniform(0.2, 0.6), mats[k % len(mats)])
    b.add_sphere((0, 0, -1000.2), 1000, mats[3])
    scene = b.build()
    assert scene.shade_table is None
    return scene


# -- global work ids -----------------------------------------------------------------


@pytest.mark.parametrize("kind", ["fast", "generic", "defocus", "fast_diff", "generic_diff"])
def test_work_ids_cut_batch_bit_exact(setup, kind):
    """Rows cut into pieces, each keyed on its rows' ids in the whole batch,
    give the whole batch's radiance bit for bit: the fast path's hash, the
    generic path's threefry scatter and roulette, the defocus disc, and the
    differentiable integrator."""
    _, _, _, tscene, tcam, tcfg = setup
    scene, cam = tscene, tcam
    if kind.startswith("generic"):
        scene = _generic_scene()
    if kind == "defocus":
        cam = scenes.cam2(W, H)
        assert cam.defocus_on
    diff = kind.endswith("_diff")
    spp, key = 3, rng.key(5)
    pix = torch.arange(0, N_PIX, 5)
    whole = render_chunk(scene, cam, pix, tcfg, spp, 1, key, diff).detach()
    rows = torch.arange(pix.shape[0] * spp).reshape(-1, spp)
    cuts = [0, 17, 40, pix.shape[0]]
    pieces = [render_chunk(scene, cam, pix[a:b], tcfg, spp, 1, key, diff,
                           work=rows[a:b].reshape(-1)).detach()
              for a, b in zip(cuts[:-1], cuts[1:])]
    assert torch.equal(torch.cat(pieces), whole)
    assert torch.equal(render_chunk(scene, cam, pix, tcfg, spp, 1, key, diff,
                                    work=rows.reshape(-1)).detach(), whole)
    # Another batch's rows draw other numbers.
    other = render_chunk(scene, cam, pix[:17], tcfg, spp, 1, key, diff,
                         work=rows[17:34].reshape(-1)).detach()
    assert not torch.equal(other, whole[:17])


# -- render_sharded --------------------------------------------------------------------


def _serial_render(tscene, tcam, tcfg, shape, spp, key=None):
    key = rng.key(tcfg.seed) if key is None else key
    t, s = shape
    tiles = []
    for i in range(t):
        parts = [parallel.render_shard(tscene, tcam, tcfg, shape, (i, j), spp, key)
                 for j in range(s)]
        tiles.append(sum(parts[1:], parts[0]))
    return parallel.assemble_render(tiles, tcam, spp, shape)


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_render_shards_match_jax(setup, shape):
    jscene, jcam, jcfg, tscene, tcam, tcfg = setup
    spp = 3  # pads the samples on the 4x2 mesh
    ref = np.asarray(jpar.render_sharded(jscene, jcam, jcfg, jpar.make_mesh(8, tiles=shape[0]),
                                         spp=spp))
    got = _serial_render(tscene, tcam, tcfg, shape, spp)
    assert got.shape == (H, W, 3)
    np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_render_shards_match_single_shard(setup):
    _, _, _, tscene, tcam, tcfg = setup
    single = _serial_render(tscene, tcam, tcfg, (1, 1), 2)
    for shape in ((8, 1), (3, 1)):  # 512 pixels pad to 513 on three tiles
        assert torch.equal(_serial_render(tscene, tcam, tcfg, shape, 2), single), shape
    two_d = _serial_render(tscene, tcam, tcfg, (4, 2), 2)
    np.testing.assert_allclose(two_d.numpy(), single.numpy(), atol=1e-6, rtol=0)
    assert not torch.equal(_serial_render(tscene, tcam, tcfg, (1, 1), 2, rng.key(1)), single)


# -- the wavefront and the megakernels -------------------------------------------------


def test_sharded_wavefront_bit_identical(setup):
    jscene, jcam, jcfg, tscene, tcam, tcfg = setup
    key = rng.key(0)
    single = parallel.wavefront_shard(tscene, tcam, tcfg, 1, 0, 2, key)
    for n in (8, 3):
        parts = [parallel.wavefront_shard(tscene, tcam, tcfg, n, r, 2, key) for r in range(n)]
        assert torch.equal(torch.cat(parts)[:N_PIX], single), n
    ref = np.asarray(jpar.render_sharded_wavefront(jscene, jcam, jcfg, jpar.make_mesh(8), spp=2))
    np.testing.assert_allclose(single.reshape(H, W, 3).numpy(), ref, **TOL)


@pytest.mark.parametrize("which", ["flat", "clustered"])
def test_sharded_megakernel_bit_identical(setup, which):
    """Contiguous near-equal ranges (not one 256-pixel tile a device, F4):
    K1's and K5's plain versions over the ranges equal the whole frame."""
    _, _, _, tscene, tcam, tcfg = setup
    scene, cam, cfg = tscene, tcam, tcfg
    if which == "clustered":
        cam = scenes.cam1(64, 8)
        scene = graft_entry.cloud_scene()
        cfg = RenderConfig(width=64, height=8, samples_per_pixel=1, max_depth=3)
        assert megakernel.eligible_clustered(scene, cfg)
    key = rng.key(cfg.seed)
    n = cam.image_width * cam.image_height
    whole = megakernel.render_megakernel(scene, cam, cfg, cfg.samples_per_pixel, 0,
                                         rng.key_seed(key))
    for shards in (3, 5):
        ranges = [parallel.megakernel_range(n, shards, r) for r in range(shards)]
        counts = [c for _, c in ranges]
        assert [b for b, _ in ranges] == [sum(counts[:r]) for r in range(shards)]
        assert sum(counts) == n and max(counts) - min(counts) <= 1
        parts = [parallel.megakernel_shard(scene, cam, cfg, shards, r, cfg.samples_per_pixel, key)
                 for r in range(shards)]
        assert torch.equal(torch.cat(parts), whole), shards
    assert parallel.megakernel_shard(scene, cam, cfg, n + 1, 0, 1, key).shape == (0, 3)


# -- train_step_sharded ----------------------------------------------------------------


def _serial_train(tscene, tcam, tcfg, shape, pix, target, spp, lr):
    t, s = shape
    n = len(pix)
    params = grad.SceneParams(*(p.detach().requires_grad_() for p in grad.get_params(tscene)))
    pix_t = torch.from_numpy(pix)
    sq = torch.zeros(())
    for i in range(t):
        parts = [parallel.train_shard(params, tscene, tcam, tcfg, shape, (i, j), pix_t, spp,
                                      rng.key(tcfg.seed)) for j in range(s)]
        rows = torch.from_numpy(target[i * n // t : (i + 1) * n // t])
        sq = sq + parallel.tile_squared_error(sum(parts[1:], parts[0]), rows, spp, s)
    grads = torch.autograd.grad(sq, params, allow_unused=True)
    new = [(p - lr * ((torch.zeros_like(p) if g is None else g) / (3 * n))).detach()
           for p, g in zip(params, grads)]
    return float(sq.detach()) / (3 * n), new


def _train_inputs():
    pix = np.arange(N_PIX, dtype=np.int32)
    target = np.random.default_rng(7).uniform(0.0, 1.0, (N_PIX, 3)).astype(np.float32)
    return pix, target


def _assert_delta_close(got, ref):
    """Parameter updates (new - old) / lr, leaf by leaf, at the gradient
    tolerance."""
    for name, dg, dr in zip(grad.SceneParams._fields, got, ref, strict=True):
        bound = 1e-3 * np.abs(dr) + 1e-3 * max(np.abs(dr).max(), 1e-12)
        assert (np.abs(dg - dr) <= bound).all(), (name, np.abs(dg - dr).max(), np.abs(dr).max())


def _delta(new, old, lr):
    return [(np.asarray(n) - o.detach().numpy()) / lr for n, o in zip(new, old)]


def _assert_update_close(got_new, ref_new, old, lr):
    _assert_delta_close(_delta(got_new, old, lr), _delta(ref_new, old, lr))


@pytest.mark.parametrize("shape", [(8, 1), (4, 2)])
def test_train_shards_match_jax(setup, shape):
    jscene, jcam, jcfg, tscene, tcam, tcfg = setup
    pix, target = _train_inputs()
    lr = 0.1
    jloss, jnew = jpar.train_step_sharded(jscene, jcam, jcfg, jpar.make_mesh(8, tiles=shape[0]),
                                          pix, target, spp=2, lr=lr)
    loss, new = _serial_train(tscene, tcam, tcfg, shape, pix, target, 2, lr)
    assert loss == pytest.approx(float(jloss), rel=1e-5)
    _assert_update_close(new, grad.get_params(jnew), grad.get_params(tscene), lr)


def test_train_shards_match_single_shard(setup):
    _, _, _, tscene, tcam, tcfg = setup
    pix, target = _train_inputs()
    l1, n1 = _serial_train(tscene, tcam, tcfg, (1, 1), pix, target, 2, 0.1)
    for shape in ((8, 1), (4, 2)):
        loss, new = _serial_train(tscene, tcam, tcfg, shape, pix, target, 2, 0.1)
        assert loss == pytest.approx(l1, rel=1e-6, abs=1e-7)
        for a, b in zip(new, n1):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=0)


# -- the collective path ---------------------------------------------------------------


def test_collectives_at_world_size_one(setup):
    """The entry points through torch.distributed (gloo, one rank): equal to
    the serial assembly of the (1, 1) mesh bit for bit."""
    _, _, _, tscene, tcam, tcfg = setup
    parallel.initialize_multihost(f"localhost:{parallel.free_port()}", 1, 0, backend="gloo")
    try:
        mesh = parallel.make_mesh()
        assert tuple(mesh.shape) == (1, 1) and tuple(mesh.get_coordinate()) == (0, 0)
        with pytest.raises(ValueError, match="cannot form"):
            parallel.make_mesh(2)
        img = parallel.render_sharded(tscene, tcam, tcfg, mesh, spp=2, device="cpu")
        assert torch.equal(img, _serial_render(tscene, tcam, tcfg, (1, 1), 2))
        wf = parallel.render_sharded_wavefront(tscene, tcam, tcfg, mesh, spp=2, device="cpu")
        assert torch.equal(wf.reshape(-1, 3),
                           parallel.wavefront_shard(tscene, tcam, tcfg, 1, 0, 2, rng.key(0)))
        mk = parallel.render_sharded_megakernel(tscene, tcam, tcfg, mesh, spp=2, device="cpu")
        assert torch.equal(mk.reshape(-1, 3),
                           megakernel.render_megakernel(tscene, tcam, tcfg, 2, 0, 0))
        pix, target = _train_inputs()
        loss, new_scene = parallel.train_step_sharded(tscene, tcam, tcfg, mesh, pix, target,
                                                      spp=2, lr=0.1, device="cpu")
        l1, n1 = _serial_train(tscene, tcam, tcfg, (1, 1), pix, target, 2, 0.1)
        assert float(loss) == pytest.approx(l1, rel=1e-6)
        for a, b in zip(grad.get_params(new_scene), n1):
            assert torch.equal(a, b)
    finally:
        dist.destroy_process_group()


def test_graft_entry_runs():
    fn, args = graft_entry.entry(device="cpu")
    out = fn(*args)
    assert out.shape == (64 * 36, 3) and bool(torch.isfinite(out).all())


def test_dryrun_multichip_four_ranks(setup, tmp_path):
    """dryrun_multichip(4) in its own process (4 spawned gloo ranks, a 2x2
    mesh): every rank's check passes (rank 0's three sharded frames equal
    their serial shards), and its loss and parameter update equal JAX's
    train_step_sharded on the same inputs (the target is each package's own
    render_sharded frame, as the dryrun takes it).  With an spp group of
    two ranks, the update also shows that the spp sum's backward passes
    each rank's gradient once."""
    out = tmp_path / "dryrun.npz"
    code = ("import numpy as np\n"
            "from rt_tpu_torch.graft_entry import dryrun_multichip\n"
            "r = dryrun_multichip(4, device='cpu')\n"
            "assert all(r[0]['serial_equal'].values()) and len({x['loss'] for x in r}) == 1, r\n"
            "for x in r[1:]:\n"
            "    assert all((a == b).all() for a, b in zip(x['update'], r[0]['update'])), x\n"
            "print(f\"loss {r[0]['loss']!r}\")\n"
            f"np.savez({str(out)!r}, *r[0]['update'])\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "dryrun_multichip(4): mesh={'tiles': 2, 'spp': 2} loss=0.000" in res.stdout, res.stdout
    loss = float(re.search(r"^loss (\S+)$", res.stdout, re.M).group(1))
    saved = np.load(out)
    update = [saved[f"arr_{k}"] for k in range(len(grad.SceneParams._fields))]
    jscene, jcam, _, tscene, _, _ = setup
    jcfg = JConfig(width=W, height=H, samples_per_pixel=2, max_depth=4, diff_max_depth=3)
    mesh, lr = jpar.make_mesh(4, tiles=2), 1e-2
    img = np.asarray(jpar.render_sharded(jscene, jcam, jcfg, mesh, spp=2))
    jloss, jnew = jpar.train_step_sharded(jscene, jcam, jcfg, mesh,
                                          np.arange(N_PIX, dtype=np.int32),
                                          img.reshape(N_PIX, 3), spp=2, lr=lr)
    assert loss == pytest.approx(float(jloss), rel=1e-5)
    _assert_delta_close(update, _delta(grad.get_params(jnew), grad.get_params(tscene), lr))
