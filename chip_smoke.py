#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rt_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from csrc/ (K1, the flat megakernel; K2/K2b,
the nearest-sphere kernel), holds each against its plain PyTorch version on
the card, and drives each path at the bench configuration, with the launch
counts set to 0 just before and read just after:

- the forward megakernel path (``render_image`` and the CLI), K1;
- the gradient path (``grad.pixel_grad`` at 400x225, 1 spp), K2: finite
  gradients that agree with the same path run on K2's plain version,
  bit-identical repeats, and autograd against finite differences;
- the chunked forward path (``render_pixel_colors(wavefront=False)``), K2.

It prints the card, the timings, the kernel table and, as the last line,
``{"ok": true, "device": {...}}``.  Any failure raises, so the script exits
non-zero and prints no result.  Without CUDA it fails at once.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ATOL = RTOL = 1e-3  # the JAX package's megakernel parity tolerance
# On the 400x225 bench frame the kernel and the plain version may part on a
# few paths: their sqrt, division and arithmetic round identically, but
# expf/acosf/atan2f/cosf may differ by an ulp between CUDA's and PyTorch's
# implementations, which can flip a texel index or, downstream of it, a
# Russian-roulette or Fresnel decision.  Allow 0.1% of the values outside
# the tolerance there; the small scenes must match strictly.
BENCH_OUTLIER_SHARE = 1e-3


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def small_scenes():
    """The scenes of tests/test_megakernel.py at 32x24, built by the port:
    (name, scene, camera, cfg, sample_offset, pixel_base, n_pixels)."""
    from rt_tpu_torch import scenes
    from rt_tpu_torch.camera import make_camera
    from rt_tpu_torch.config import CompatConfig, RenderConfig
    from rt_tpu_torch.scene import SceneBuilder
    from rt_tpu_torch.sky import SkyParams

    w, h = 32, 24

    def cam(defocus=0.0):
        return make_camera((6, 0, 2), (0, 0, 1), (0, 0, 1), focus_distance=6.0,
                           defocus_angle=defocus, image_width=w, image_height=h, vertical_fov=30.0)

    def simple(mat_fn, sky=None):
        b = SceneBuilder()
        b.add_sphere((0, 0, -1000), 1000, b.lambertian(b.solid_color((0.5, 0.5, 0.5))))
        mat_fn(b)
        return b.build(sky=sky or SkyParams.default())

    lam = lambda rgb: (lambda b: b.add_sphere((0, 0, 1), 1, b.lambertian(b.solid_color(rgb))))
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=2, max_depth=8)
    quirk = SkyParams.default().replace(cos_gamma_as_angle=True)
    out = [
        ("lambertian", simple(lam((0.8, 0.2, 0.1))), cam(), cfg, 0, 0, None),
        ("metal", simple(lambda b: b.add_sphere((0, 0, 1), 1, b.metal(b.solid_color((0.8, 0.7, 0.6)), fuzz=0.2))), cam(), cfg, 0, 0, None),
        ("dielectric", simple(lambda b: b.add_sphere((0, 0, 1), 1, b.dielectric(1.5))), cam(), cfg, 0, 0, None),
        ("emissive", simple(lambda b: b.add_sphere((0, 0, 1), 1, b.emissive((3.0, 2.0, 1.0)))), cam(), cfg, 0, 0, None),
        ("triangle", simple(lambda b: b.add_triangle((-1, -1, 0.5), (2, -1, 0.5), (0, 1, 2.5), b.lambertian(b.solid_color((0.2, 0.4, 0.8))))), cam(), cfg, 0, 0, None),
        ("defocus", simple(lam((0.7, 0.3, 0.2))), cam(0.6), cfg, 0, 0, None),
        ("scrambled_jitter", simple(lam((0.6, 0.6, 0.2))), cam(),
         cfg.replace(compat=CompatConfig(shared_halton_jitter=False)), 0, 0, None),
        ("quirk_sky", simple(lam((0.6, 0.2, 0.6)), quirk), cam(), cfg, 0, 0, None),
        ("hosek_sky", simple(lam((0.5, 0.4, 0.3)), SkyParams.hosek_reference()), cam(), cfg, 0, 0, None),
        ("offsets_full", simple(lam((0.3, 0.5, 0.7))), cam(), cfg, 3, 0, None),
        ("offsets_half", simple(lam((0.3, 0.5, 0.7))), cam(), cfg, 3, w * h // 2, w * h // 2),
    ]
    cam1 = scenes.cam1(w, h)
    out.append(("cover_4x4", scenes.cover_scene(4, 4, cam1, z=-0.2, seed=0), cam1,
                RenderConfig(width=w, height=h, samples_per_pixel=2, max_depth=12), 0, 0, None))
    return out


# Gradient path against the same path on K2's plain version: the loss at
# rtol 1e-5, each leaf at |d| <= 1e-3 |ref| + 1e-3 max|ref|.  Kernel and
# plain version pick the same winners, so the two runs should agree to the
# last bit; the bound allows for reductions that the two runs order alike.
GRAD_LOSS_RTOL = 1e-5
GRAD_LEAF_TOL = 1e-3


def compare(got, ref):
    """(max |got - ref|, values outside atol + rtol * |ref|, value count)."""
    d = (got - ref).abs()
    bad = int((d > ATOL + RTOL * ref.abs()).sum())
    return float(d.max()), bad, got.numel()


def timed_cuda(fn, reps: int):
    """(last result, mean ms per call) by CUDA events after one warm-up."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def random_rays(n: int, seed: int, device):
    """n rays from a numpy seed: origins over the cover scene's extent,
    directions from a normal distribution (not unit length)."""
    import numpy as np
    import torch

    rs = np.random.default_rng(seed)
    org = rs.uniform((-8, -8, 0), (8, 8, 2), (n, 3)).astype(np.float32)
    dirn = rs.normal(size=(n, 3)).astype(np.float32)
    return torch.from_numpy(org).to(device), torch.from_numpy(dirn).to(device)


def nearest_phase(dev, scene, timer):
    """K2 and K2b against their plain versions: the winner equal on every
    ray and t equal on every hit.  Returns, for K2 and for K2b, (max |d t|
    over its cases, kernel ms, plain ms at 90,000 rays x the scene's
    spheres)."""
    import numpy as np
    import torch

    from rt_tpu_torch import nearest_ops as no

    rs = np.random.default_rng(5)
    small = (torch.from_numpy(rs.uniform(-4, 4, (37, 3)).astype(np.float32)).to(dev),
             torch.from_numpy(rs.uniform(0.2, 1.5, (37,)).astype(np.float32)).to(dev))
    ns = scene.num_spheres
    bench = (scene.sph_center[:ns], scene.sph_radius[:ns])
    pad_case = (torch.zeros((4, 3), device=dev),
                torch.tensor([[0.0, 0.0, 1.0]] * 4, device=dev),
                torch.tensor([[0, 0, 2.0], [0, 0, 1.0]], device=dev),
                torch.tensor([0.5, 0.0], device=dev))
    cases = [
        ("bench 90000 x %d" % ns, *random_rays(90_000, 1, dev), *bench),
        ("random 1000 x 37", *random_rays(1000, 2, dev), *small),
        ("r=0 padding", *pad_case),
    ]
    worst = 0.0
    for name, org, dirn, centers, radius in cases:
        t_k, i_k = no.sphere_nearest(org, dirn, centers, radius, 1e-3, 3e38)
        t_p, i_p = no.sphere_nearest_plain(org, dirn, centers, radius, 1e-3, 3e38)
        hit = i_p >= 0
        err = float((t_k - t_p)[hit].abs().max()) if bool(hit.any()) else 0.0
        same = bool(torch.equal(i_k, i_p)) and bool(torch.equal(t_k[~hit], t_p[~hit]))
        print(f"[K2] {name}: idx equal {same}, hits {int(hit.sum())}, max|d t| on hits {err:.3e}")
        check(same and err == 0.0, f"K2 {name}: kernel and plain version disagree")
        worst = max(worst, err)
    check(bool((i_k == 0).all()) and bool((t_k == 1.5).all()), "K2: an r=0 sphere won")

    org, dirn = random_rays(90_000, 1, dev)
    n_pad = -(-90_000 // no.RAY_TILE) * no.RAY_TILE
    rays = torch.zeros((8, n_pad), device=dev)
    rays[0:3, :90_000], rays[3:6, :90_000], rays[3:6, 90_000:] = org.T, dirn.T, 1.0
    t_k, i_k = no.sphere_nearest_packed(rays, scene.sph_packed, 1e-3, 3e38)
    t_p, i_p = no.sphere_nearest_packed_plain(rays, scene.sph_packed, 1e-3, 3e38)
    t_2, i_2 = no.sphere_nearest(org, dirn, *bench, 1e-3, 3e38)
    err = float((t_k - t_p)[i_p >= 0].abs().max())
    same = bool(torch.equal(i_k, i_p)) and bool(torch.equal(i_k[:90_000], i_2))
    print(f"[K2b] packed {n_pad} x {scene.sph_packed.shape[0]}: idx equal to plain and to K2 "
          f"{same}, max|d t| on hits {err:.3e}")
    check(same and err == 0.0, "K2b: kernel and plain version disagree")

    _, kernel_ms = timer(lambda: no.sphere_nearest(org, dirn, *bench, 1e-3, 3e38), 5)
    _, plain_ms = timer(lambda: no.sphere_nearest_plain(org, dirn, *bench, 1e-3, 3e38), 5)
    _, packed_ms = timer(lambda: no.sphere_nearest_packed(rays, scene.sph_packed, 1e-3, 3e38), 5)
    _, packed_plain_ms = timer(
        lambda: no.sphere_nearest_packed_plain(rays, scene.sph_packed, 1e-3, 3e38), 5)
    return (worst, kernel_ms, plain_ms), (err, packed_ms, packed_plain_ms)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall(fn, reps: int, device) -> float:
    """Mean warm wall seconds of fn() over reps calls, after one warm-up,
    each call ended by a device synchronize."""
    fn()
    sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        sync(device)
    return (time.perf_counter() - t0) / reps


def grad_phase(dev, width: int = 400, height: int = 225, depth: int = 6, reps: int = 3):
    """The gradient path at bench_grad.py's configuration: cover_scene(11,
    11), cam1, diff_max_depth 6, every pixel at 1 spp, key 0, zero target.
    Returns (K2 launches in one pixel_grad call, timings dict)."""
    import torch

    from rt_tpu_torch import grad, nearest_ops, rng, scenes
    from rt_tpu_torch.config import RenderConfig

    camera = scenes.cam1(width, height)
    scene = scenes.cover_scene(11, 11, camera, z=-0.2, seed=0)
    scene.to(dev)
    cfg = RenderConfig(width=width, height=height, diff_max_depth=depth)
    n = width * height
    pix = torch.arange(n, device=dev)
    target = torch.zeros((n, 3), device=dev)
    key = rng.key(0)
    args = (scene, camera, cfg, pix, target, key)

    for name in nearest_ops.LAUNCHES:
        nearest_ops.LAUNCHES[name] = 0
    loss, g = grad.pixel_grad(*args)
    launches = dict(nearest_ops.LAUNCHES)
    print(f"[grad] pixel_grad {width}x{height} 1 spp, diff_max_depth {depth}: loss {loss.item():.9g}, "
          f"K2 launches {launches}")
    check(launches["sphere_nearest"] >= depth + 1, "the gradient path did not go through K2")
    check(bool(torch.isfinite(loss)), "non-finite loss")
    for leaf in grad.SceneParams._fields:
        v = getattr(g, leaf)
        check(bool(torch.isfinite(v).all()), f"non-finite gradient in {leaf}")
        print(f"[grad]   {leaf:18s} shape {tuple(v.shape)}, max|g| {float(v.abs().max()):.6g}")
    check(float(g.tex_color.abs().max()) > 0.0, "tex_color gradient is zero")

    loss2, g2 = grad.pixel_grad(*args)
    same = bool(torch.equal(loss, loss2)) and all(
        bool(torch.equal(a, b)) for a, b in zip(g, g2))
    print(f"[grad] a second kernel run is bit-identical in loss and every leaf: {same}")
    check(same, "two pixel_grad runs differ")

    loss_p, g_p = grad.pixel_grad(*args, sphere_nearest=nearest_ops.sphere_nearest_plain)
    rel = abs(loss.item() - loss_p.item()) / abs(loss_p.item())
    print(f"[grad] K2 kernel vs plain: loss rel diff {rel:.3e}")
    check(rel <= GRAD_LOSS_RTOL, "loss differs from the plain-K2 run")
    for leaf in grad.SceneParams._fields:
        a, b = getattr(g, leaf), getattr(g_p, leaf)
        d = float((a - b).abs().max())
        ok = bool(((a - b).abs() <= GRAD_LEAF_TOL * (b.abs() + b.abs().max())).all())
        print(f"[grad]   {leaf:18s} max|d| {d:.3e}")
        check(ok, f"{leaf}: kernel and plain-K2 gradients disagree")

    with torch.no_grad():
        params = grad.get_params(scene)
        fwd_s = wall(lambda: grad.pixel_loss(params, *args), reps, dev)
    grad_s = wall(lambda: grad.pixel_grad(*args), reps, dev)
    plain_s = wall(lambda: grad.pixel_grad(*args, sphere_nearest=nearest_ops.sphere_nearest_plain),
                   reps, dev)
    return launches, dict(forward_s=fwd_s, grad_s=grad_s, grad_plain_k2_s=plain_s)


def fd_phase(dev):
    """tests/test_grad.py's scene and FD cases tex_color[0,0] and
    sky_exposure, at that file's tolerances, with K2 on the card."""
    import numpy as np
    import torch

    from rt_tpu_torch import grad, rng, scenes
    from rt_tpu_torch.config import CompatConfig, RenderConfig
    from rt_tpu_torch.scene import SceneBuilder

    b = SceneBuilder()
    lam = b.lambertian_rgb(0.8, 0.5, 0.3)
    metal = b.metal_solid((0.7, 0.6, 0.5), 0.1)
    glass = b.dielectric(1.5)
    img = np.linspace(0.6, 1.0, 8 * 8 * 3, dtype=np.float32).reshape(8, 8, 3)
    textured = b.lambertian(b.image_texture(img))
    b.add_sphere((-0.6, 0.4, 0.0), 0.7, lam)
    b.add_sphere((0.7, -0.3, 0.1), 0.6, metal)
    b.add_sphere((1.4, -1.5, 0.2), 0.5, glass)
    b.add_sphere((-1.3, -0.9, 0.0), 0.5, textured)
    scene = b.build(use_bvh=False)
    scene.to(dev)
    camera = scenes.cam1(24, 16)
    cfg = RenderConfig(width=24, height=16, diff_max_depth=4, detach_sampling=False,
                       compat=CompatConfig(rr_clamp=0.6))
    pix, target, key = torch.arange(384, device=dev), torch.zeros((384, 3), device=dev), rng.key(0)
    loss_fn = lambda p: grad.pixel_loss(p, scene, camera, cfg, pix, target, key, spp=2)
    _, ad_params = grad.pixel_grad(scene, camera, cfg, pix, target, key, spp=2)
    params = grad.get_params(scene)
    for leaf, index, eps, tol in (("tex_color", (0, 0), 1e-2, 0.08), ("sky_exposure", (), 1e-2, 0.08)):
        ad = float(getattr(ad_params, leaf)[index])
        fd = grad.finite_difference_grad(loss_fn, params, leaf, index, eps)
        err = abs(ad - fd) / max(abs(ad), abs(fd), 1e-4)
        print(f"[fd] {leaf}{list(index)}: autograd {ad:.6g}, finite difference {fd:.6g}, "
              f"rel {err:.4f} (tol {tol})")
        check(abs(fd) > 1e-6 and err < tol, f"{leaf}: autograd and finite difference disagree")


def chunked_phase(dev, k1_image, spp: int = 10, block: int = 16):
    """render_pixel_colors(wavefront=False) on the bench frame against a
    K1 image of the same frame.  The two routes key their draws
    differently, so only statistics agree: at 10 spp the per-pixel noise
    alone is several 1e-2, so the check is on the means of block x block
    pixel tiles, whose noise is block times smaller.  Returns (K2
    launches, wall s, mean |d| per pixel, mean |d| of tile means)."""
    import numpy as np

    from rt_tpu_torch import nearest_ops
    from rt_tpu_torch.render import render_pixel_colors
    from rt_tpu_torch.scenes import bench_cover_config

    scene, camera, cfg = bench_cover_config()
    scene.to(dev)
    for name in nearest_ops.LAUNCHES:
        nearest_ops.LAUNCHES[name] = 0
    sync(dev)
    t0 = time.perf_counter()
    img = render_pixel_colors(scene, camera, cfg, device=dev, spp=spp, wavefront=False)
    img = img.cpu().numpy()
    seconds = time.perf_counter() - t0
    launches = dict(nearest_ops.LAUNCHES)
    check(launches["sphere_nearest"] >= 1, "the chunked path did not go through K2")
    check(img.shape == k1_image.shape and bool(np.isfinite(img).all()), "chunked image is not finite")

    def tiles(x):
        h, w = (x.shape[0] // block) * block, (x.shape[1] // block) * block
        return x[:h, :w].reshape(h // block, block, w // block, block, 3).mean(axis=(1, 3))

    pixel_mad = float(np.abs(img - k1_image).mean())
    tile_mad = float(np.abs(tiles(img) - tiles(k1_image)).mean())
    check(tile_mad < 1e-2, f"chunked image differs from the K1 image: tile mean |d| {tile_mad}")
    return launches, seconds, pixel_mad, tile_mad


def atlas_backward_phase(dev, atlas, timer, n: int = 90_000):
    """Cost of the deterministic texel-gather backward (elementwise.
    take_rows: index_put_ under torch.use_deterministic_algorithms) against
    plain indexing's backward, for n texel fetches from ``atlas``.
    Returns (deterministic ms, plain ms) per forward + backward."""
    import numpy as np
    import torch

    from rt_tpu_torch.elementwise import take_rows

    rs = np.random.default_rng(3)
    flat = atlas.reshape(-1, 3)
    # Few distinct texels, so that many lanes add into each one.
    idx = torch.from_numpy(rs.integers(0, min(flat.shape[0], 4096), n)).to(dev)
    cot = torch.from_numpy(rs.normal(size=(n, 3)).astype(np.float32)).to(dev)

    def run(gather):
        leaf = flat.detach().requires_grad_()
        return torch.autograd.grad(gather(leaf, idx), leaf, cot)[0]

    first = run(take_rows)
    check(bool(torch.equal(first, run(take_rows))), "deterministic texel backward differs")
    _, det_ms = timer(lambda: run(take_rows), 5)
    _, plain_ms = timer(lambda: run(lambda a, i: a[i]), 5)
    return det_ms, plain_ms


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from rt_tpu_torch import _build, megakernel as mk
    from rt_tpu_torch.render import render_image
    from rt_tpu_torch.scenes import bench_cover_config

    # -- 1. the card ---------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[card] {card}")
    print(f"[card] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, devices {torch.cuda.device_count()}")
    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 2. build K1 and K2 from the repository's sources ------------------------
    t0 = time.perf_counter()
    _build.library()
    print(f"[build] {_build.build_info['path']}: nvcc {_build.build_info['seconds']:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s)")
    for line in _build.build_info["log"].splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    # -- 3. kernel vs plain on the card -------------------------------------------
    for name, scene, camera, cfg, off, base, n in small_scenes():
        scene.to(dev)
        got = mk.render_megakernel(scene, camera, cfg, 2, off, cfg.seed, pixel_base=base, n_pixels=n)
        ref = mk.render_megakernel_plain(scene, camera, cfg, 2, off, cfg.seed, pixel_base=base, n_pixels=n)
        err, bad, total = compare(got, ref)
        print(f"[parity] {name:17s} 32x24 2spp: max|d| {err:.3e}, outside tol {bad}/{total}")
        check(bad == 0, f"{name}: kernel and plain version disagree")

    scene, camera, cfg = bench_cover_config()
    scene.to(dev)
    spp = cfg.samples_per_pixel
    plain = mk.render_megakernel_plain(scene, camera, cfg, spp, 0, cfg.seed)
    got, kernel_ms = timed_cuda(lambda: mk.render_megakernel(scene, camera, cfg, spp, 0, cfg.seed), 5)
    bench_err, bad, total = compare(got, plain)
    print(f"[parity] bench cover 400x225 {spp}spp depth {cfg.max_depth}: max|d| {bench_err:.3e}, "
          f"outside tol {bad}/{total} ({bad / total:.4%}, allowed {BENCH_OUTLIER_SHARE:.1%})")
    check(bad <= BENCH_OUTLIER_SHARE * total, "bench frame: kernel and plain version disagree")
    print(f"[time] bench frame {spp} spp on {card}: kernel {kernel_ms:.3f} ms "
          f"(CUDA events, mean of 5 after a warm-up)")

    # -- 4. the main path through render_image ----------------------------------
    mk.LAUNCHES = 0
    scene, camera, cfg = bench_cover_config()  # fresh, host-side scene: the cold run uploads it
    runs = []
    for label in ("cold", "warm", "warm", "warm"):
        img, m = render_image(scene, camera, cfg, device="cuda")
        runs.append((label, img, m))
        print(f"[main] render_image {label}: {m['wall_s']:.4f} s, {m['mray_per_s']:.2f} Mray/s "
              f"({m['rays']} camera rays) on {card}")
    img640, m640 = render_image(scene, camera, cfg, device="cuda", spp=640)
    print(f"[main] render_image 640 spp in one call: {m640['wall_s']:.4f} s, "
          f"{m640['mray_per_s']:.2f} Mray/s on {card}")
    launches = mk.LAUNCHES
    print(f"[main] megakernel launches during the main path: {launches}")
    check(launches >= 5, "the main path did not go through the CUDA kernel")
    for label, img, _ in runs + [("640spp", img640, m640)]:
        check(img.shape == (225, 400, 3), f"{label}: image shape {img.shape}")
        check(bool(np.isfinite(img).all()), f"{label}: non-finite values")
    check(np.array_equal(runs[1][1], runs[0][1]), "warm and cold renders differ")
    check(np.abs(runs[0][1] - plain.reshape(225, 400, 3).cpu().numpy()).mean() < 1e-3,
          "main-path image differs from the plain version")
    mean640 = float(img640.mean())
    check(abs(mean640 - float(runs[0][1].mean())) < 0.05 and 0.05 < mean640 < 2.0,
          f"640-spp image mean {mean640} is implausible")
    # The plain version's second run on the card: its PyTorch kernels are warm.
    scene.to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mk.render_megakernel_plain(scene, camera, cfg, spp, 0, cfg.seed)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    rays = spp * 400 * 225
    print(f"[main] plain version {spp} spp (warm, wall): {plain_ms / 1e3:.3f} s, "
          f"{rays / plain_ms / 1e3:.3f} Mray/s on {card}")

    # -- 5. the CLI ------------------------------------------------------------------
    os.makedirs("build", exist_ok=True)
    png = os.path.join("build", "cover_torch.png")
    if os.path.exists(png):
        os.remove(png)
    cmd = [sys.executable, "-m", "rt_tpu_torch.cli", "--scene", "cover", "--size", "400x225",
           "--spp", "10", "--max-depth", "50", "--out", png]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    print(f"[cli] {' '.join(cmd[1:])}: rc {res.returncode}, {time.perf_counter() - t0:.1f} s")
    for line in res.stderr.strip().splitlines()[-3:]:
        print(f"[cli] {line}")
    check(res.returncode == 0, "the CLI failed")
    with open(png, "rb") as f:
        check(f.read(8) == b"\x89PNG\r\n\x1a\n", "the CLI wrote no PNG")
    print(f"[cli] wrote {png}: {os.path.getsize(png)} bytes")

    # -- 6. determinism -------------------------------------------------------------
    scene.to(dev)
    a = mk.render_megakernel(scene, camera, cfg, spp, 0, cfg.seed)
    b = mk.render_megakernel(scene, camera, cfg, spp, 0, cfg.seed)
    torch.cuda.synchronize()
    check(torch.equal(a, b), "two kernel renders differ")
    print("[determinism] two kernel renders of the bench frame are bit-identical")

    # -- 7. K2/K2b kernel vs plain on the card ------------------------------------
    bench_scene, _, _ = bench_cover_config()
    bench_scene.to(dev)
    (k2_err, k2_ms, k2_plain_ms), (k2b_err, k2b_ms, k2b_plain_ms) = nearest_phase(
        dev, bench_scene, timed_cuda)
    print(f"[time] K2 sphere_nearest 90000 rays x {bench_scene.num_spheres} spheres on {card}: "
          f"kernel {k2_ms:.4f} ms, plain {k2_plain_ms:.4f} ms (CUDA events, mean of 5 after a warm-up)")
    print(f"[time] K2b sphere_nearest_packed 90112 x {bench_scene.sph_packed.shape[0]} on {card}: "
          f"kernel {k2b_ms:.4f} ms, plain {k2b_plain_ms:.4f} ms")
    det_ms, index_ms = atlas_backward_phase(dev, bench_scene.atlas, timed_cuda)
    print(f"[time] texel gather + backward, 90000 fetches, on {card}: deterministic "
          f"{det_ms:.4f} ms, plain indexing {index_ms:.4f} ms")

    # -- 8. the gradient path (pixel_grad at bench_grad.py's configuration) --------
    grad_launches, times = grad_phase(dev)
    print(f"[grad] warm wall, mean of 3, on {card}: pixel_loss forward {times['forward_s']:.4f} s, "
          f"pixel_grad {times['grad_s']:.4f} s, pixel_grad on plain K2 {times['grad_plain_k2_s']:.4f} s")

    # -- 9. autograd against finite differences on the card ----------------------
    fd_phase(dev)

    # -- 10. the chunked forward path -------------------------------------------------
    chunk_launches, chunk_s, pixel_mad, tile_mad = chunked_phase(dev, img640)
    rays = 10 * 400 * 225
    print(f"[chunked] render_pixel_colors(wavefront=False) 400x225 10 spp: {chunk_s:.4f} s, "
          f"{rays / chunk_s / 1e6:.3f} Mray/s on {card}; K2 launches {chunk_launches}")
    print(f"[chunked] against the 640-spp K1 image: mean |d| per pixel {pixel_mad:.5f}, "
          f"of 16x16 tile means {tile_mad:.5f} (limit 1e-2)")

    # -- 11. result -------------------------------------------------------------------
    check(all(math.isfinite(v) for v in (bench_err, kernel_ms, plain_ms, k2_ms, k2_plain_ms,
                                          k2b_ms, k2b_plain_ms)), "non-finite measurement")
    print("[kernels] sphere_nearest_packed (K2b) has no caller on any path, as in rt_tpu; "
          "it is held against its plain version above")
    print(card_line())
    print(json.dumps({"kernels": [
        {
            "name": "megakernel_flat",
            "route": "cuda",
            "source": "rt_tpu_torch/csrc/megakernel.cu",
            "replaces": "rt_tpu/megakernel.py:288",
            "launches": launches,
            "max_abs_err": bench_err,
            "ms": kernel_ms,
            "plain_ms": plain_ms,
        },
        {
            "name": "sphere_nearest",
            "route": "cuda",
            "source": "rt_tpu_torch/csrc/nearest.cu",
            "replaces": "rt_tpu/pallas_ops.py:123",
            "launches": grad_launches["sphere_nearest"],
            "max_abs_err": k2_err,
            "ms": k2_ms,
            "plain_ms": k2_plain_ms,
        },
        {
            "name": "sphere_nearest_packed",
            "route": "cuda",
            "source": "rt_tpu_torch/csrc/nearest.cu",
            "replaces": "rt_tpu/pallas_ops.py:313",
            "launches": grad_launches["sphere_nearest_packed"],
            "max_abs_err": k2b_err,
            "ms": k2b_ms,
            "plain_ms": k2b_plain_ms,
        },
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
