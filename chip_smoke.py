#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (rt_tpu_torch) on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels from csrc/ (K1, the flat megakernel; K2/K2b,
the nearest-sphere kernel; K3/K3b, the nearest-primitive kernel with the
shade-table fetch; K4/K4b, the cluster walk; K5, the clustered megakernel;
K6, the primitives probe's reduce, gather and scatter; and the BVH walk,
which is not a TPU kernel) and the C++ BVH builder, holds each kernel
against its plain PyTorch
version on the card, and drives each path at the bench configuration, with
the launch counts set to 0 just before and read just after:

- the forward megakernel path (``render_image`` and the CLI), K1, held
  bit for bit against its plain version on the test scenes (also with its
  ring's pixel slots reused) and the bench frame, and timed at 10 and 640 spp
  and on a 1600x900 frame;
- the gradient path (``grad.pixel_grad`` at 400x225, 1 spp), K2: finite
  gradients that agree with the same path run on K2's plain version,
  bit-identical repeats, and autograd against finite differences;
- the chunked forward path (``render_pixel_colors(wavefront=False)``), K2;
- the persistent wavefront (``render_pixel_colors`` with renderer
  "wavefront"), K3: bit-identical repeats and the same frame on K3's plain
  version; its generic path on a scene without a shade table, K2;
- progressive rendering (``ProgressiveRenderer`` and the CLI's
  ``--progressive``), K3: a checkpointed and resumed run bit-identical to
  an uninterrupted one;
- mesh scenes (BASELINE config 3: ``mesh_with_area_light`` of a 99,908-
  triangle closed mesh, and 3b, a 100,356-triangle height field, at
  800x450 and max depth 16, with 8 samples per pixel in place of the
  config's 64): ``render_image`` through K5, the wavefront through K4 (one
  launch per iteration), one progressive pass with the "mega" engine, and
  the CLI's ``obj:`` scene; K4/K4b and K5 are held against their plain
  versions there and on the tie scene of tests/test_torch_walk_order.py;
- the primitives probe (``python -m rt_tpu_torch.micro_probe all``), K6:
  ns per unit of each body and each gather mode;
- the blob's BVH through the walk kernel: ``grad.pixel_grad`` at 800x450,
  1 spp, diff_max_depth 6 (bit-identical repeats, a pixel block equal to
  the same step on the plain walk) and the chunked 2-spp frame
  (``render_pixel_colors(wavefront=False)``); and a defocused chunked
  frame of the cover scene;
- the live Hosek-Wilkie sky (``SkyParams.hosek``): ``hosek_config`` and
  ``sky_color_toward`` on the card against the CPU, and the bench cover
  frame under it through ``render_image`` (K1), bit-equal to plain;
- BASELINE config 4 (bench_scenes_cuda.py): the armor-class glb (54,720
  triangles, image textures) under the live sky at 800x450, depth 16, 8
  spp, two ``render_image`` frames through K5, bit-identical, and K5
  against plain on runs of its pixels;
- BASELINE config 5: the car-class glb (162,560 triangles) at 1920x1080,
  depth 12, progressive on the "mega" engine (K5) in 4-spp sweeps, cut to
  20 spp, each sweep summed on the card (``progressive.DEVICE_SUMS``): a
  run resumed at mid-run from an earlier checkpoint by a fresh renderer,
  bit-identical to the uninterrupted run, K5 against plain on runs of a
  sweep's pixels, and the sweep-sum kernel (``csrc/sweep_sum.cu``) on a
  sweep's colours and the run's sum, bit-equal to numpy's
  ``accum + colors * ns`` and timed beside torch's two-op form;
- the port's bench scripts: ``bench_cuda.main`` (K1) and
  ``bench_grad_cuda.main`` (K2) print bench.py's and bench_grad.py's lines;
- sphere clusters (cluster_bench_cuda.py's covers of 40k and 360k spheres
  at 800x450, depth 50, spp cut from 64 to 4): the host's scene build and
  the tables' bytes, ``render_image`` through K5, K5 against plain on
  runs of the frame and its last 16 pixels, the clustered wavefront (K4)
  at 1 spp against K5's image, and K4 against plain on the frame's camera
  rays and first bounces;
- the front ends: ``cli --probe`` on the card against the CPU probe, a
  "mega" progressive run feeding ``PreviewServer`` (``/frame.png`` and
  ``/probe``), and the CLI with ``--serve 0 --term-preview``;
- examples/inverse_rendering_torch.py, 10 steps on the card (K2, each
  launch held against plain on its inputs);
- sharding: ``parallel.render_sharded_megakernel`` on one NCCL rank
  against ``render_image``'s frames (K1 on the bench cover, K5 on the 40k
  cover), then ``graft_entry.dryrun_multichip(2)``: two gloo ranks on the
  one card, K2, K3 and K5 in each, every sharded frame equal to its serial
  shards, and the ranks' launches rerun here and held against their plain
  versions bit for bit.

It prints the card, the timings, the kernel table and, as the last line,
``{"ok": true, "device": {...}}``.  Any failure raises, so the script exits
non-zero and prints no result.  Without CUDA it fails at once.
"""

from __future__ import annotations

import contextlib
import importlib
import json
import math
import os
import subprocess
import sys
import time

from bench_cuda import sync
from bench_scenes_cuda import mesh_cam  # bench_scenes.py's config-3 camera

ATOL = RTOL = 1e-3  # the JAX package's megakernel parity tolerance


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def tests_module(name: str):
    """A module of the repository's tests/ (shared cases), imported by path:
    another installed package may be named "tests"."""
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    return importlib.import_module(name)


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


def k1_ring_phase(dev, spps=(5, 9)):
    """K1 against its plain version, bit for bit, where a launch reuses its
    ring's pixel slots: three of the 32x24 scenes (defocus, a pixel range
    with a sample offset, the cover crop) with the scratch cap lowered to
    two samples of the whole frame, so that each slot serves 2-5 pixels and
    lanes wait for slots (``K1_RING['waits']`` > 0 over the phase)."""
    import torch

    from rt_tpu_torch import megakernel as mk

    cap = mk.SCRATCH_CAP
    mk.SCRATCH_CAP = 12 * 32 * 24 * 2
    waits = 0
    try:
        for name, scene, camera, cfg, off, base, n in small_scenes():
            if name not in ("defocus", "offsets_half", "cover_4x4"):
                continue
            scene.to(dev)
            for spp in spps:
                got = mk.render_megakernel(scene, camera, cfg, spp, off, cfg.seed, pixel_base=base,
                                           n_pixels=n)
                ring = dict(mk.K1_RING, waits=int(mk.K1_RING["waits"]))
                ref = mk.render_megakernel_plain(scene, camera, cfg, spp, off, cfg.seed,
                                                 pixel_base=base, n_pixels=n)
                same = bool(torch.equal(got, ref))
                waits += ring["waits"]
                print(f"[parity] {name:17s} 32x24 {spp}spp, {ring['launches']} launch, "
                      f"{ring['slots']} slots x {ring['generations']} generations, "
                      f"{ring['waits']} waited steps: equal to plain {same}")
                check(same and ring["generations"] > 1 and ring["launches"] == 1,
                      f"{name} {spp} spp: K1 with reused slots and plain disagree")
    finally:
        mk.SCRATCH_CAP = cap
    check(waits > 0, "no lane waited for a slot: the lowered cap did not exercise the ring")


def k1_wide_phase(dev, card: str, spp: int = 10, block: int = 256):
    """The cover scene at 1600x900, 10 spp, depth 50 through K1, timed;
    three 256-pixel runs of the frame (its middle row and corners) equal to
    the plain version bit for bit.  Returns (the kernel's ms per frame, its
    least time): the ray segments and admitted sphere pairs that the plain
    runs searched, scaled from their 768 pixels to the frame, as K5's bound
    scales its 144 pixels."""
    import torch

    from rt_tpu_torch import megakernel as mk
    from rt_tpu_torch import scenes
    from rt_tpu_torch.config import RenderConfig

    w, h = 1600, 900
    camera = scenes.cam1(w, h)
    scene = scenes.cover_scene(11, 11, camera, z=-0.2, seed=0).to(dev)
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp, max_depth=50)
    img, ms = timed_cuda(lambda: mk.render_megakernel(scene, camera, cfg, spp, 0, cfg.seed), 3)
    ring = mk.K1_RING
    print(f"[time] K1 cover 1600x900 {spp} spp depth 50 ({ring['launches']} launch, "
          f"{ring['slots']} slots x {ring['generations']} generations) on {card}: kernel "
          f"{ms:.3f} ms, {spp * w * h / ms / 1e3:.2f} Mray/s (CUDA events, mean of 3 after a "
          f"warm-up)")
    check(img.shape == (w * h, 3) and bool(torch.isfinite(img).all()), "1600x900: non-finite image")
    mean = float(img.mean())
    check(0.05 < mean < 2.0, f"1600x900: implausible image mean {mean}")
    work = {"segments": 0, "admitted": 0}
    bases = (0, (h // 2) * w + w // 2 - block // 2, w * h - block)
    for base in bases:
        ref = mk.render_megakernel_plain(scene, camera, cfg, spp, 0, cfg.seed, pixel_base=base,
                                         n_pixels=block, search=counting_search(work))
        check(bool(torch.equal(img[base : base + block], ref)),
              f"1600x900: pixels [{base}, {base + block}) differ from the plain version")
    scale = w * h / (len(bases) * block)
    wide_bound = bound(brute_flops(round(work["segments"] * scale), scene.num_spheres,
                                   scene.num_triangles, round(work["admitted"] * scale)),
                       w * h * 12)
    print(f"[parity] 1600x900: image mean {mean:.4f}; three {block}-pixel runs equal to plain; "
          f"they searched {work['segments']} ray segments with {work['admitted']} admitted sphere "
          f"pairs; x {scale:.1f} for the frame: bound {wide_bound[0]:.4f} ms by {wide_bound[1]}")
    return ms, wide_bound


# Gradient path against the same path on K2's plain version: the loss at
# rtol 1e-5, each leaf at |d| <= 1e-3 |ref| + 1e-3 max|ref|.  Kernel and
# plain version pick the same winners, so the two runs should agree to the
# last bit; the bound allows for reductions that the two runs order alike.
GRAD_LOSS_RTOL = 1e-5
GRAD_LEAF_TOL = 1e-3


# The card's peaks for the least-time bounds (NVIDIA's H100 SXM data sheet,
# at the full 700 W): FP32 outside the tensor cores, and HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12
# Floating-point operations per pair, counted from the kernels' code
# (csrc/brute_force.cuh, csrc/nearest.cu); compares and selects not counted.
# A sphere pair needs its root only where the discriminant admits it, so the
# brute-force bounds (K1, K2, K3) count FLOPS_SPHERE_TEST for every pair
# and FLOPS_SPHERE_ROOT for each admitted pair, counted on the run's rays.
FLOPS_SPHERE_TEST = 18  # 3 sub, 5 for h, 7 for c, 3 for disc
FLOPS_SPHERE_ROOT = 6  # max, sqrt, 2 + 2 for the roots
FLOPS_SPHERE_PAIR = FLOPS_SPHERE_TEST + FLOPS_SPHERE_ROOT  # with its root: the walk and K6 take each
FLOPS_TRIANGLE_PAIR = 46  # 9 + 9 for the crosses, 5 det, 1 div, 3 sub, 6 u, 6 v, 6 t, 1 u+v
FLOPS_SLAB = 20  # a box test of the cluster walk: 6 sub, 6 mul, min/max of the slabs, the pad

# BASELINE configs 3 and 4 (bench_scenes.py:92-170): 800x450, max depth 16;
# the sample count is cut from 64 to 8 to fit this script's time.
MESH_W, MESH_H, MESH_DEPTH, MESH_SPP = 800, 450, 16, 8


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """(least ms the card could take, "operations" or "bytes")."""
    ops_ms, bytes_ms = flops / PEAK_FP32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def admitted_pairs(rays, sph, chunk: int = 1 << 15) -> int:
    """The (ray, sphere) pairs of rays f32[>=6, N] and sphere rows f32[S, 4]
    whose discriminant admits a root (tests/torch_brute_cases.admitted)."""
    brute = tests_module("torch_brute_cases")
    return sum(int(brute.admitted(rays[:, k : k + chunk], sph).sum())
               for k in range(0, rays.shape[1], chunk))


def brute_flops(n_rays: int, n_spheres: int, n_triangles: int, admitted: int) -> int:
    """Operations of a brute-force search of n_rays rays: every pair's test,
    and the root of each of the ``admitted`` sphere pairs."""
    return (n_rays * (n_spheres * FLOPS_SPHERE_TEST + n_triangles * FLOPS_TRIANGLE_PAIR)
            + admitted * FLOPS_SPHERE_ROOT)


def counting_search(counts: dict):
    """K1's plain search (megakernel.flat_search) that adds to ``counts``
    the ray segments it searches and their admitted sphere pairs."""
    from rt_tpu_torch import megakernel as mk

    def search(scene, cfg, rays):
        counts["segments"] += rays.shape[1]
        counts["admitted"] += admitted_pairs(rays, scene.sph_packed[: scene.num_spheres])
        return mk.flat_search(scene, cfg, rays)

    return search


def compare(got, ref):
    """(max |got - ref|, values outside atol + rtol * |ref|, value count)."""
    d = (got - ref).abs()
    bad = int((d > ATOL + RTOL * ref.abs()).sum())
    return float(d.max()), bad, got.numel()


def timed_cuda(fn, reps: int):
    """(last result, mean ms per call) by CUDA events after one warm-up.
    The timed calls are queued behind a ~10 ms spin of the card, so that a
    kernel shorter than its call's host work runs back to back and is timed
    itself, not the rate at which the host issues it.  A call that waits
    for the card (a plain version's host sync) is timed with its host work,
    as before."""
    import torch

    out = fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
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
    ray and t equal on every hit; on the tie scene of
    tests/torch_brute_cases.py at t_max 1e9, 3e38 and inf, t and idx bit
    for bit.  Returns, for K2 and for K2b, (max |d t|
    over its cases, kernel ms, plain ms at 90,000 rays x the scene's
    spheres), and the sphere pairs of those rays that the discriminant
    admits (the same for K2 and K2b)."""
    import numpy as np
    import torch

    from rt_tpu_torch import nearest_ops as no

    rs = np.random.default_rng(5)
    small = (torch.from_numpy(rs.uniform(-4, 4, (37, 3)).astype(np.float32)).to(dev),
             torch.from_numpy(rs.uniform(0.2, 1.5, (37,)).astype(np.float32)).to(dev))
    big_c = rs.uniform((-8, -8, 0), (8, 8, 2), (2500, 3)).astype(np.float32)
    big_r = rs.uniform(0.05, 0.4, (2500,)).astype(np.float32)
    big_c[2000], big_r[2000] = big_c[7], big_r[7]  # a tie across the kernel's table tiles
    big = (torch.from_numpy(big_c).to(dev), torch.from_numpy(big_r).to(dev))
    big_org, big_dir = random_rays(20_000, 3, dev)
    big_org[:500] = big[0][7]  # from inside sphere 7 and its copy: both exits at one t
    ns = scene.num_spheres
    bench = (scene.sph_center[:ns], scene.sph_radius[:ns])
    pad_case = (torch.zeros((4, 3), device=dev),
                torch.tensor([[0.0, 0.0, 1.0]] * 4, device=dev),
                torch.tensor([[0, 0, 2.0], [0, 0, 1.0]], device=dev),
                torch.tensor([0.5, 0.0], device=dev))
    cases = [
        ("bench 90000 x %d" % ns, *random_rays(90_000, 1, dev), *bench),
        ("random 1000 x 37", *random_rays(1000, 2, dev), *small),
        ("random 20000 x 2500 (a table over shared memory's 1024 rows)", big_org, big_dir, *big),
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
    brute = tests_module("torch_brute_cases")
    tie, tie_rays = brute.tie_scene().to(dev), brute.tie_rays().to(dev)
    tns = tie.num_spheres
    for t_max in (1e9, 3e38, float("inf")):
        args = (tie_rays[0:3].T, tie_rays[3:6].T, tie.sph_center[:tns], tie.sph_radius[:tns], 1e-3,
                t_max)
        k2 = no.sphere_nearest(*args)
        k2b = no.sphere_nearest_packed(tie_rays, tie.sph_packed, 1e-3, t_max)
        ref = no.sphere_nearest_plain(*args)
        same = equal(k2, ref) and equal(k2b, no.sphere_nearest_packed_plain(
            tie_rays, tie.sph_packed, 1e-3, t_max))
        print(f"[K2] tie scene of tests/torch_brute_cases.py, {tie_rays.shape[1]} rays x {tns} "
              f"spheres, t_max {t_max:g}: t and idx equal to plain {same} (K2b too), hits "
              f"{int((ref[1] >= 0).sum())}")
        check(same, f"K2/K2b on the tie scene at t_max {t_max:g}: kernel and plain version disagree")

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
    admitted = admitted_pairs(rays, scene.sph_packed)  # the pad rows (radius 0) admit none
    return (worst, kernel_ms, plain_ms), (err, packed_ms, packed_plain_ms), admitted


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


def prim_rays(scene, camera, cfg, n: int, dev):
    """n rays in the kernel layout f32[8, n]: the bench frame's first n/2
    camera rays (sample 0) and n/2 random rays."""
    import torch

    from rt_tpu_torch.camera import generate_rays

    half = n // 2
    pix = torch.arange(half, device=dev)
    org, dirn, _ = generate_rays(camera, pix, torch.zeros_like(pix), cfg.seed, cfg.compat)
    r_org, r_dir = random_rays(n - half, 6, dev)
    rays = torch.zeros((8, n), device=dev)
    rays[0:3], rays[3:6] = torch.cat([org, r_org]).T, torch.cat([dirn, r_dir]).T
    return rays


def prim_phase(dev, scene, camera, cfg, timer, n: int = 65_536):
    """K3 and K3b against their plain versions at the wavefront pool's
    shape (n rays x the bench scene's tables): winners, t and params equal
    bit for bit, with culling on and off.  Returns, for K3 and K3b, (max |d
    t|, kernel ms, plain ms, bound ms, bound_by)."""
    import torch

    from rt_tpu_torch import prim_ops as po

    rays = prim_rays(scene, camera, cfg, n, dev)
    tables = (scene.sph_packed, scene.tri_packed)
    table = scene.shade_table
    ns, nt = scene.num_spheres, scene.num_triangles
    for cull in (True, False):
        k3 = po.prim_nearest_shaded(rays, *tables, table, ns, 1e-3, 3e38, cull)
        k3b = po.prim_nearest_packed(rays, *tables, ns, 1e-3, 3e38, cull)
        ref = po.prim_nearest_shaded_plain(rays, *tables, table, ns, 1e-3, 3e38, cull)
        hit = ref[1] >= 0
        err = float((k3[0] - ref[0])[hit].abs().max())
        same = (all(bool(torch.equal(a, b)) for a, b in zip(k3, ref))
                and bool(torch.equal(k3b[0], ref[0])) and bool(torch.equal(k3b[1], ref[1])))
        tri_hits = int((ref[1] >= ns).sum())
        print(f"[K3] {n} rays x {ns} spheres + {nt} triangles, cull {cull}: t, prim and params "
              f"equal to plain {same} (K3b too), hits {int(hit.sum())} ({tri_hits} on triangles), "
              f"max|d t| {err:.3e}")
        check(same and err == 0.0 and tri_hits > 0, "K3/K3b: kernel and plain version disagree")
    brute = tests_module("torch_brute_cases")
    tie, tie_rays = brute.tie_scene().to(dev), brute.tie_rays().to(dev)
    tie_args = (tie_rays, tie.sph_packed, tie.tri_packed)
    for cull in (True, False):
        k3 = po.prim_nearest_shaded(*tie_args, tie.shade_table, tie.num_spheres, 1e-3, 3e38, cull)
        k3b = po.prim_nearest_packed(*tie_args, tie.num_spheres, 1e-3, 3e38, cull)
        ref = po.prim_nearest_shaded_plain(*tie_args, tie.shade_table, tie.num_spheres, 1e-3, 3e38,
                                           cull)
        same = equal(k3, ref) and equal(k3b, ref[:2])
        print(f"[K3] tie scene of tests/torch_brute_cases.py, {tie_rays.shape[1]} rays, cull "
              f"{cull}: t, prim and params equal to plain {same} (K3b too), hits "
              f"{int((ref[1] >= 0).sum())}")
        check(same, "K3/K3b on the tie scene: kernel and plain version disagree")
    args = (rays, *tables)
    _, k3_ms = timer(lambda: po.prim_nearest_shaded(*args, table, ns, 1e-3, 3e38), 5)
    _, k3_plain_ms = timer(lambda: po.prim_nearest_shaded_plain(*args, table, ns, 1e-3, 3e38), 5)
    _, k3b_ms = timer(lambda: po.prim_nearest_packed(*args, ns, 1e-3, 3e38), 5)
    _, k3b_plain_ms = timer(lambda: po.prim_nearest_packed_plain(*args, ns, 1e-3, 3e38), 5)
    # Least work: every real (ray, primitive) pair's test once and the roots
    # of the admitted sphere pairs; the rays' six rows and the tables read
    # once, t and prim (and K3's params) written once.
    admitted = admitted_pairs(rays, scene.sph_packed[:ns])
    flops = brute_flops(n, ns, nt, admitted)
    read = n * 6 * 4 + scene.sph_packed.numel() * 4 + scene.tri_packed.numel() * 4
    k3_bound = bound(flops, read + table.numel() * 4 + n * 8 + n * table.shape[0] * 4)
    k3b_bound = bound(flops, read + n * 8)
    print(f"[K3] least time on this card: K3 {k3_bound[0] * 1e3:.2f} us, K3b "
          f"{k3b_bound[0] * 1e3:.2f} us, both bound by {k3_bound[1]} ({flops / 1e9:.3f} GFLOP; "
          f"{admitted} of {n * ns} sphere pairs admitted)")
    return (err, k3_ms, k3_plain_ms, *k3_bound), (err, k3b_ms, k3b_plain_ms, *k3b_bound)


def wavefront_phase(dev, k1_frame):
    """The bench frame through render_pixel_colors with renderer
    "wavefront": K3 launches equal to the loop's iterations, a repeat
    bit-identical, the same frame on K3's plain version bit-identical, and
    the image against K1's of the same frame (the same hash streams).
    Returns (kernel launches, wavefront counts, wall s)."""
    import numpy as np
    import torch

    from rt_tpu_torch import prim_ops, rng, wavefront
    from rt_tpu_torch.render import render_pixel_colors
    from rt_tpu_torch.scenes import bench_cover_config

    scene, camera, cfg = bench_cover_config()
    cfg = cfg.replace(renderer="wavefront")
    scene.to(dev)
    spp, w, h = cfg.samples_per_pixel, camera.image_width, camera.image_height
    for name in prim_ops.LAUNCHES:
        prim_ops.LAUNCHES[name] = 0
    wavefront.COUNTS.update(iterations=0, segments=0)
    sync(dev)
    t0 = time.perf_counter()
    img = render_pixel_colors(scene, camera, cfg, device=dev)
    host = img.cpu().numpy()
    seconds = time.perf_counter() - t0
    launches, counts = dict(prim_ops.LAUNCHES), dict(wavefront.COUNTS)
    rays = spp * w * h
    print(f"[wavefront] render_pixel_colors(renderer='wavefront') {w}x{h} {spp} spp depth "
          f"{cfg.max_depth}: {seconds:.4f} s, {rays / seconds / 1e6:.3f} Mray/s; K3 launches "
          f"{launches['prim_nearest_shaded']}, iterations {counts['iterations']}, ray segments "
          f"{counts['segments']}")
    check(launches["prim_nearest_shaded"] == counts["iterations"] > 0,
          "the wavefront did not go through K3 once per iteration")
    check(host.shape == (h, w, 3) and bool(np.isfinite(host).all()), "wavefront image is not finite")
    again = render_pixel_colors(scene, camera, cfg, device=dev)
    check(bool(torch.equal(img, again)), "two wavefront renders differ")
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    plain = wavefront.render_wavefront(scene, camera, pix, cfg, spp, 0, rng.key(cfg.seed),
                                       prim_nearest=prim_ops.prim_nearest_shaded_plain)
    check(bool(torch.equal(img.reshape(-1, 3), plain)), "the wavefront on plain K3 differs")
    print("[wavefront] a repeat and the same frame on K3's plain version are bit-identical")
    d = np.abs(host - k1_frame)
    within = float((d <= ATOL + RTOL * np.abs(k1_frame)).all(axis=-1).mean())
    print(f"[wavefront] against K1's image of the frame: max|d| {d.max():.4e}, mean|d| "
          f"{d.mean():.3e}, pixels within 1e-3 {within:.4%}")
    check(within > 0.99, "the wavefront image differs from K1's")
    return launches, counts, seconds


def generic_phase(dev):
    """_render_generic on a scene without a shade table (a checker with an
    image child): K2 launches, and the same frame on K2's plain version
    bit-identical."""
    import numpy as np
    import torch

    from rt_tpu_torch import nearest_ops, rng, scenes, wavefront
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.scene import SceneBuilder

    b = SceneBuilder()
    img = np.linspace(0.2, 0.9, 8 * 8 * 3, dtype=np.float32).reshape(8, 8, 3)
    b.add_sphere((0, 0, -1000), 1000, b.lambertian(b.checker(0.5, b.image_texture(img),
                                                             b.solid_color((0.9, 0.9, 0.9)))))
    b.add_sphere((0, 0, 1), 1, b.metal_solid((0.8, 0.7, 0.6), 0.1))
    b.add_sphere((1.5, -1, 0.6), 0.6, b.dielectric(1.5))
    scene = b.build()
    check(scene.shade_table is None, "the generic scene has a shade table")
    scene.to(dev)
    w, h, spp = 200, 112, 2
    camera = scenes.cam1(w, h)
    cfg = RenderConfig(width=w, height=h, max_depth=16)
    pix = torch.arange(w * h, dtype=torch.int32, device=dev)
    for name in nearest_ops.LAUNCHES:
        nearest_ops.LAUNCHES[name] = 0
    wavefront.COUNTS.update(iterations=0, segments=0)
    sync(dev)
    t0 = time.perf_counter()
    got = wavefront.render_wavefront(scene, camera, pix, cfg, spp, 0, rng.key(0))
    sync(dev)
    seconds = time.perf_counter() - t0
    launches, iterations = dict(nearest_ops.LAUNCHES), wavefront.COUNTS["iterations"]
    plain = wavefront._render_generic(scene, camera, pix, cfg, spp, 0, rng.key(0),
                                      sphere_nearest=nearest_ops.sphere_nearest_plain)
    same = bool(torch.equal(got, plain))
    print(f"[generic] _render_generic, checker with an image child, {w}x{h} {spp} spp: "
          f"{seconds:.4f} s, K2 launches {launches}, iterations {iterations}; "
          f"equal to the plain-K2 run {same}")
    check(launches["sphere_nearest"] == iterations > 0,
          "the generic path did not go through K2")
    check(same and bool(torch.isfinite(got).all()), "the generic path on plain K2 differs")


def profile_phase(dev, card: str, spp: int = 2, top: int = 6):
    """One warm wavefront frame of the bench scene at ``spp`` under
    ``profiling.device_trace``: wall with and without the profiler, the
    device's busy share, K3's share of device time and the largest device
    items.  The trace goes to build/wavefront_trace.json."""
    from rt_tpu_torch import profiling, wavefront
    from rt_tpu_torch.render import render_pixel_colors
    from rt_tpu_torch.scenes import bench_cover_config

    scene, camera, cfg = bench_cover_config()
    cfg = cfg.replace(renderer="wavefront")
    frame = lambda: render_pixel_colors(scene, camera, cfg, device=dev, spp=spp)
    plain_s = wall(frame, 1, dev)
    os.makedirs("build", exist_ok=True)
    trace = os.path.join("build", "wavefront_trace.json")
    wavefront.COUNTS.update(iterations=0, segments=0)
    t0 = time.perf_counter()
    with profiling.device_trace(trace) as prof:
        frame()
        sync(dev)
    traced_s = time.perf_counter() - t0
    iterations = wavefront.COUNTS["iterations"]
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        us = getattr(e, "self_cuda_time_total", 0.0) if us is None else us
        if us > 0:
            rows.append((us, e.count, e.key))
    rows.sort(reverse=True)
    busy_us = sum(r[0] for r in rows)
    print(f"[profile] wavefront frame {camera.image_width}x{camera.image_height} {spp} spp on "
          f"{card}: wall {plain_s:.4f} s, under the "
          f"profiler {traced_s:.4f} s; trace {trace}")
    if not rows:
        print("[profile] the profiler recorded no device time: device busy share not measured")
        return
    k3_us = sum(r[0] for r in rows if "prim_nearest_kernel" in r[2])
    kernels = sum(r[1] for r in rows)
    print(f"[profile] device busy {busy_us / 1e3:.2f} ms = {busy_us / 1e4 / traced_s:.1f}% of the "
          f"profiled wall, {busy_us / 1e4 / plain_s:.1f}% of the unprofiled wall; K3 "
          f"{k3_us / 1e3:.3f} ms ({100 * k3_us / busy_us:.1f}% of device time); {kernels} device "
          f"kernels in {iterations} iterations ({kernels / max(iterations, 1):.0f} per iteration)")
    for us, count, key in rows[:top]:
        print(f"[profile]   {us / 1e3:9.3f} ms  {count:6d} x  {key[:90]}")


def progressive_phase(dev, card: str, passes: int = 9, cut: int = 5):
    """ProgressiveRenderer on the bench scene for the reference schedule's
    first ``passes`` passes: per-sweep Mray/s; a run checkpointed after
    pass ``cut`` and resumed by a fresh renderer, bit-identical to the
    uninterrupted run; and the "mega" engine once.  Returns (K3 launches,
    wall s of the uninterrupted run)."""
    import numpy as np

    from rt_tpu_torch import prim_ops
    from rt_tpu_torch.progressive import ProgressiveRenderer
    from rt_tpu_torch.scenes import bench_cover_config

    scene, camera, cfg = bench_cover_config()
    os.makedirs("build", exist_ok=True)
    ckpt = os.path.join("build", "progressive_smoke.npz")
    if os.path.exists(ckpt):
        os.remove(ckpt)
    for name in prim_ops.LAUNCHES:
        prim_ops.LAUNCHES[name] = 0
    sweeps = []
    t0 = time.perf_counter()
    whole = ProgressiveRenderer(scene, camera, cfg, device=dev)
    whole.run(max_passes=passes, on_sweep=lambda img, m: sweeps.append(m))
    seconds = time.perf_counter() - t0
    launches = prim_ops.LAUNCHES["prim_nearest_shaded"]
    spp, w, h = whole.state.total_spp, camera.image_width, camera.image_height
    print(f"[progressive] {passes} passes, {spp} spp at {w}x{h} on {card}: {seconds:.3f} s, "
          f"{spp * w * h / seconds / 1e6:.3f} Mray/s overall, K3 launches {launches}")
    print("[progressive] per sweep (spp: Mray/s): " + ", ".join(
        f"{m['sweep_spp']}: {m['mray_per_s']:.3f}" for m in sweeps))
    check(launches > 0 and spp == sum(whole.passes[:passes])
          and bool(np.isfinite(whole.state.image).all()),
          "the progressive run failed")
    first = ProgressiveRenderer(scene, camera, cfg, checkpoint_path=ckpt, device=dev)
    first.run(max_passes=cut)
    resumed = ProgressiveRenderer(scene, camera, cfg, checkpoint_path=ckpt, device=dev)
    check(resumed.state.pass_index == cut, "the checkpoint did not resume")
    resumed.run(max_passes=passes - cut)
    same = np.array_equal(resumed.state.accum, whole.state.accum)
    print(f"[progressive] checkpointed after pass {cut}, resumed by a fresh renderer: accumulator "
          f"bit-identical to the uninterrupted run {same}")
    check(same, "the resumed progressive run differs")
    t0 = time.perf_counter()
    mega = ProgressiveRenderer(scene, camera, cfg, engine="mega", device=dev)
    mega.run(max_passes=passes)
    mega_s = time.perf_counter() - t0
    d = float(np.abs(mega.state.image - whole.state.image).mean())
    print(f"[progressive] engine 'mega' (K1), {passes} passes: {mega_s:.3f} s, "
          f"{spp * w * h / mega_s / 1e6:.3f} Mray/s; mean |d| to the wavefront image {d:.3e}")
    check(mega.engine == "mega" and d < 1e-2, "the mega engine's image differs")
    return launches, seconds


def cli_progressive_phase():
    """The CLI's --progressive on the card: 4 passes with a checkpoint."""
    import numpy as np

    png = os.path.join("build", "cover_progressive.png")
    ckpt = os.path.join("build", "cover_progressive.npz")
    for path in (png, ckpt):
        if os.path.exists(path):
            os.remove(path)
    cmd = [sys.executable, "-m", "rt_tpu_torch.cli", "--scene", "cover", "--size", "400x225",
           "--max-depth", "50", "--progressive", "--passes", "4", "--checkpoint", ckpt,
           "--device", "cuda", "--out", png]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    print(f"[cli] {' '.join(cmd[1:])}: rc {res.returncode}, {time.perf_counter() - t0:.1f} s")
    for line in res.stdout.strip().splitlines()[-2:]:
        print(f"[cli] {line}")
    check(res.returncode == 0, f"the progressive CLI failed: {res.stderr[-2000:]}")
    with open(png, "rb") as f:
        check(f.read(8) == b"\x89PNG\r\n\x1a\n", "the progressive CLI wrote no PNG")
    with np.load(ckpt) as data:
        check(int(data["total_spp"]) == 15 and int(data["pass_index"]) == 4,
              "the progressive CLI's checkpoint is wrong")
    print(f"[cli] wrote {png} and {ckpt} (15 spp, 4 passes)")


def mesh_setup():
    """Build the BVH library (asserting that the native builder runs) and
    write the config 3-5 fixtures to build/fixtures with
    rt_tpu_torch.fixtures (numpy and the standard library only): the closed
    blob (skull class), the height field, and the armor- and car-class
    glbs.  Returns ensure_fixtures' {name: path}."""
    from rt_tpu_torch.bvh import builder, native
    from rt_tpu_torch.fixtures import ensure_fixtures

    t0 = time.perf_counter()
    ok = native.available()
    print(f"[mesh] native BVH builder built and loaded: {ok} ({time.perf_counter() - t0:.2f} s), "
          f"builder that runs: {builder.which()}")
    check(ok and builder.which() == "native", "the native BVH builder did not build or load")
    t0 = time.perf_counter()
    paths = ensure_fixtures(os.path.join("build", "fixtures"))
    print(f"[mesh] fixtures in {time.perf_counter() - t0:.2f} s: " + ", ".join(
        f"{path} ({os.path.getsize(path) / 1e6:.1f} MB)" for path in paths.values()))
    return paths


def mesh_scene(path: str, dev):
    """mesh_with_area_light(path) on the card, with its build time."""
    from rt_tpu_torch import scenes

    t0 = time.perf_counter()
    scene = scenes.mesh_with_area_light(path)
    seconds = time.perf_counter() - t0
    cl = scene.clusters
    live = int((cl.tri_cluster[:, 0] <= cl.tri_cluster[:, 3]).sum())
    print(f"[mesh] {path}: {scene.num_triangles} triangles, built in {seconds:.2f} s: "
          f"{live} triangle clusters in {cl.tri_super.shape[0]} supers, "
          f"{len(cluster_pages(cl))} pages of 512 clusters, "
          f"slot table {tuple(cl.shade_table.shape)}, BVH {scene.bvh.node_min.shape[0]} nodes")
    return scene.to(dev)


def walk_tests(work: dict) -> int:
    """Slab and pair tests in a plain walk's ``work``."""
    return work.get("slab", 0) + work.get("sphere_pairs", 0) + work.get("triangle_pairs", 0)


def walk_counts(work: dict) -> dict:
    """``work`` for printing: its sets of entered supers and clusters by size."""
    return {k: len(v) if isinstance(v, set) else v for k, v in work.items()}


def row_share(work: dict) -> str:
    """The slot-row bytes a plain walk's ``work`` says the kernels load
    (only the lanes below each entered cluster's live count) against what
    loading whole clusters would take."""
    live = work.get("sphere_row_bytes", 0) + work.get("triangle_row_bytes", 0)
    whole = work.get("sphere_row_bytes_whole", 0) + work.get("triangle_row_bytes_whole", 0)
    return (f"slot-row bytes {live} of {whole} for whole clusters "
            f"({100.0 * live / max(whole, 1):.2f}%)")


def walk_bound(work: dict, nbytes: float, scale: float = 1.0) -> tuple[float, str]:
    """Least time of a cluster walk that made ``work``'s tests ``scale``
    times over and moved ``nbytes``."""
    flops = (work.get("slab", 0) * FLOPS_SLAB + work.get("sphere_pairs", 0) * FLOPS_SPHERE_PAIR
             + work.get("triangle_pairs", 0) * FLOPS_TRIANGLE_PAIR)
    return bound(flops * scale, nbytes)


def walk_bytes(work: dict, n_rays: int, super_rows: int) -> int:
    """Bytes a walk must move: the rays' six rows read once and t and slot
    written once (``n_rays``), the ``super_rows`` super AABBs read once,
    and of the supers and clusters ``work`` says some ray entered, the
    cluster AABBs (64 a super) and the slot rows (4 for spheres, 10 for
    triangles; 128 slots a cluster) read once."""
    entered = lambda key: len(work.get(key, ()))
    return (n_rays * (24 + 8) + 32 * super_rows
            + 32 * 64 * (entered("sphere_supers") + entered("triangle_supers"))
            + 4 * 128 * (4 * entered("sphere_clusters") + 10 * entered("triangle_clusters")))


def mesh_rays(scene, camera, cfg, n: int, dev):
    """n rays in the kernel layout: n/2 camera rays of the frame (sample 0,
    pixels spread over it) and n/2 rays of the camera rays' first bounce."""
    import torch

    from rt_tpu_torch import cluster_ops, fast_shade
    from rt_tpu_torch.camera import generate_rays

    n_pix = camera.image_width * camera.image_height
    pix = torch.arange(n, device=dev) * (n_pix // n)
    org, dirn, gwork = generate_rays(camera, pix, torch.zeros_like(pix), cfg.seed, cfg.compat)
    cam_rays = torch.zeros((8, n), device=dev)
    cam_rays[0:3], cam_rays[3:6] = org.T, dirn.T
    cl = scene.clusters
    t, slot = cluster_ops.cluster_nearest(cam_rays, *cluster_ops.cluster_tables(cl), cl.n_sph_slots,
                                          cfg.t_min, cfg.t_max, cfg.compat.triangle_backface_cull)
    params = cl.shade_table.index_select(1, torch.clamp(slot, min=0))
    out = fast_shade.shade_bounce(scene, cam_rays, t, slot, cfg.seed, gwork, 0, cfg, params=params)
    bounce = out["new_rays"][:, out["hit"]]
    check(bounce.shape[1] >= n // 2, "too few camera rays hit the mesh scene")
    rays = torch.zeros((8, n), device=dev)
    rays[0:6, : n // 2] = cam_rays[0:6, : n // 2]
    rays[0:6, n // 2 :] = bounce[0:6, : n - n // 2]
    return rays


def tie_cases():
    """The tie scene and its rays of tests/test_torch_walk_order.py (port
    only, no JAX): equal t within a cluster and across clusters and supers."""
    walk_order = tests_module("test_torch_walk_order")
    return walk_order.tie_scene, walk_order.tie_rays


def cluster_pages(cl, size: int = 512) -> list:
    """The JAX package's pages of a clustered scene's whole tables, as
    K4 takes them: [(tables, sph_slot_base, tri_slot_base)]
    (tests/torch_cluster_cases.py, port only, no JAX)."""
    return tests_module("torch_cluster_cases").cluster_pages(cl, size)


def equal(got, ref) -> bool:
    """Two tuples of tensors equal bit for bit."""
    import torch

    return all(torch.equal(a, b) for a, b in zip(got, ref, strict=True))


def k4_rays_phase(dev, scene, camera, cfg, timer, n: int = 65_536):
    """K4 against its plain version, bit for bit, on ``n`` camera rays and
    first bounces of the frame (cull as ``cfg``), over the whole tables
    (one wavefront intersect), with its time, the plain version's and the
    bound from the walk's counted work.  Returns ((max |d t|, kernel ms,
    plain ms, bound ms, bound_by), the rays, the tables, the walk's work)."""
    from rt_tpu_torch import cluster_ops

    cl = scene.clusters
    rays = mesh_rays(scene, camera, cfg, n, dev)
    whole = cluster_ops.cluster_tables(cl)
    args = (cl.n_sph_slots, cfg.t_min, cfg.t_max, cfg.compat.triangle_backface_cull)
    # The work is counted apart from the timed plain runs (counting syncs
    # with the host).
    work = {}
    ref = cluster_ops.cluster_nearest_plain(rays, *whole, *args, work=work)
    got, ms = timer(lambda: cluster_ops.cluster_worklist_nearest(rays, *whole, *args), 5)
    _, plain_ms = timer(lambda: cluster_ops.cluster_nearest_plain(rays, *whole, *args), 1)
    hits = int((ref[1] >= 0).sum())
    print(f"[K4] {n} rays (camera + first bounce) x {scene.num_spheres} spheres + "
          f"{scene.num_triangles} triangles over the whole tables: equal to plain "
          f"{equal(got, ref)}, hits {hits}; walk work {walk_counts(work)}; {row_share(work)}")
    check(equal(got, ref) and hits > n // 4, "K4: kernel and plain version disagree")
    k4 = (0.0, ms, plain_ms,
          *walk_bound(work, walk_bytes(work, n, whole[0].shape[0] + whole[4].shape[0])))
    return k4, rays, whole, work


def cluster_phase(dev, scene, camera, cfg, timer, n: int = 65_536):
    """``k4_rays_phase`` on ``n`` rays of the frame, then K4 and K4b against
    their plain versions, bit for bit (t and slot ids on every ray),
    culling on and off: on those rays over the whole tables (K4 as the
    wavefront launches it, and K4b) and per cluster page (K4 with the
    page's slot bases; the pages merged equal the whole tables); and on the
    tie scene's rays.  Returns, for K4 (one wavefront intersect: one launch
    over the whole tables) and K4b, (max |d t|, kernel ms, plain ms, bound
    ms, bound_by)."""
    import torch

    from rt_tpu_torch import cluster_ops

    cl = scene.clusters
    k4, rays, whole, work = k4_rays_phase(dev, scene, camera, cfg, timer, n)
    pages = cluster_pages(cl)
    ns = cl.n_sph_slots
    tie_scene, tie_rays = tie_cases()
    tie = tie_scene().clusters.to(dev)
    t_rays = tie_rays().to(dev)
    t_whole = cluster_ops.cluster_tables(tie)
    for cull in (True, False):
        args = (ns, cfg.t_min, cfg.t_max, cull)
        ref = cluster_ops.cluster_nearest_plain(rays, *whole, *args)
        t_ref = cluster_ops.cluster_nearest_plain(t_rays, *t_whole, tie.n_sph_slots, cfg.t_min,
                                                  cfg.t_max, cull)
        same = {fn.__name__: equal(fn(rays, *whole, *args), ref)
                and equal(fn(t_rays, *t_whole, tie.n_sph_slots, cfg.t_min, cfg.t_max, cull), t_ref)
                for fn in (cluster_ops.cluster_worklist_nearest, cluster_ops.cluster_nearest)}
        pages_same, merged_k, merged_p = True, None, None
        for tables, s_base, t_base in pages:
            k = cluster_ops.cluster_worklist_nearest(rays, *tables, *args, s_base, t_base)
            p = cluster_ops.cluster_nearest_plain(rays, *tables, *args, s_base, t_base)
            pages_same = pages_same and equal(k, p)
            if merged_k is None:
                merged_k, merged_p = k, p
            else:
                merged_k = [torch.where(k[0] < merged_k[0], a, b) for a, b in zip(k, merged_k)]
                merged_p = [torch.where(p[0] < merged_p[0], a, b) for a, b in zip(p, merged_p)]
        paged_same = equal(merged_k, ref) and equal(merged_p, ref)
        hit = ref[1] >= 0
        print(f"[K4] {n} rays (camera + first bounce) x {scene.num_spheres} spheres + "
              f"{scene.num_triangles} triangles, cull "
              f"{cull}: over the whole tables, and on the tie scene's {t_rays.shape[1]} rays "
              f"(hits {int((t_ref[1] >= 0).sum())}), equal to plain: K4 "
              f"{same['cluster_worklist_nearest']}, K4b {same['cluster_nearest']}; every K4 page "
              f"equal to plain {pages_same}; the {len(pages)} pages merged equal to the whole "
              f"tables {paged_same}; hits {int(hit.sum())}")
        check(all(same.values()) and pages_same and paged_same and int(hit.sum()) > n // 4,
              "K4/K4b: kernel and plain version disagree")
    args = (ns, cfg.t_min, cfg.t_max, cfg.compat.triangle_backface_cull)
    _, k4b_ms = timer(lambda: cluster_ops.cluster_nearest(rays, *whole, *args), 5)
    _, k4b_plain_ms = timer(lambda: cluster_ops.cluster_nearest_plain(rays, *whole, *args), 1)
    _, pages_ms = timer(lambda: [cluster_ops.cluster_worklist_nearest(rays, *t, *args, sb, tb)
                                 for t, sb, tb in pages], 5)
    print(f"[K4] one launch over the whole tables: {k4[1]:.4f} ms; the {len(pages)} page "
          f"launches together {pages_ms:.4f} ms")
    # Coherent against incoherent rays, and four times the rays.
    tests = walk_tests(work)
    for label, part in (("camera rays", rays[:, : n // 2]), ("first bounces", rays[:, n // 2 :])):
        part = part.contiguous()
        w = {}
        cluster_ops.cluster_nearest_plain(part, *whole, *args, work=w)
        _, ms = timer(lambda: cluster_ops.cluster_nearest(part, *whole, *args), 5)
        print(f"[K4] {label} alone ({n // 2}): K4b {ms:.4f} ms, walk work {walk_counts(w)}, "
              f"{ms * 1e6 / max(walk_tests(w), 1):.4f} ns per test")
    four = rays.repeat(1, 4)
    _, ms4 = timer(lambda: cluster_ops.cluster_nearest(four, *whole, *args), 5)
    print(f"[K4] K4b on the rays four times over ({4 * n}): {ms4:.4f} ms, "
          f"{ms4 * 1e6 / (4 * tests):.4f} ns per test (at {n}: {k4b_ms * 1e6 / tests:.4f})")
    # K4 and K4b compute one function on the same rays, so they share one
    # bound.
    return k4, (0.0, k4b_ms, k4b_plain_ms, *k4[3:])


def k5_small_phase(dev):
    """K5 against its plain version, bit for bit: the 32x24 triangle-cloud and image-textured triangle scenes of
    tests/test_megakernel_cluster.py, the tie scene seen from above, and the
    prefix scenes of tests/torch_cluster_cases.py (clusters of 1 to 128
    live slots), on which K4 and K4b are held against plain too."""
    import torch

    from rt_tpu_torch import cluster_ops, megakernel as mk
    from rt_tpu_torch import scene as tscene
    from rt_tpu_torch.camera import make_camera
    from rt_tpu_torch.config import RenderConfig

    cases = tests_module("torch_cluster_cases")  # the test suite's scene cases (port only, no JAX)

    tie_scene, _ = tie_cases()
    side = make_camera((6, 0, 2), (0, 0, 1), (0, 0, 1), focus_distance=6.0, defocus_angle=0.0,
                       image_width=32, image_height=24, vertical_fov=30.0)
    down = make_camera((0.5, -3.5, 5.0), (0.0, 0.0, 0.5), (0, 0, 1), focus_distance=6.0,
                       defocus_angle=0.0, image_width=32, image_height=24, vertical_fov=60.0)
    small_cfg = RenderConfig(width=32, height=24, samples_per_pixel=2, max_depth=6)
    for name, build, cam in (("triangle cloud", lambda: cases.tri_cloud(tscene).build(), side),
                             ("image triangles", lambda: cases.image_tris(tscene).build(), side),
                             ("tie scene", tie_scene, down)):
        small = build().to(dev)
        ref = mk.render_megakernel_plain(small, cam, small_cfg, 2, 0, 0)
        same = bool(torch.equal(mk.render_megakernel(small, cam, small_cfg, 2, 0, 0), ref))
        print(f"[K5] {name} 32x24 2 spp depth 6: equal to plain {same}; mean "
              f"{float(ref.mean()):.4f}")
        check(same, f"K5 {name}: kernel and plain version disagree")
    above = make_camera((3.0, -6.0, 6.0), (3.0, 0.0, 0.5), (0, 0, 1), focus_distance=8.0,
                        defocus_angle=0.0, image_width=32, image_height=24, vertical_fov=60.0)
    for case in cases.PREFIX_CASES:
        small = cases.prefix_scene(case)[0].to(dev)
        cl = small.clusters
        rays = cases.prefix_rays(cl).to(dev)
        walks = True
        for cull in (True, False):
            args = (rays, *cluster_ops.cluster_tables(cl), cl.n_sph_slots, 1e-3, 1e9, cull)
            ref = cluster_ops.cluster_nearest_plain(*args)
            walks = walks and equal(cluster_ops.cluster_nearest(*args), ref) and equal(
                cluster_ops.cluster_worklist_nearest(*args), ref)
        ref = mk.render_megakernel_plain(small, above, small_cfg, 2, 0, 0)
        same = bool(torch.equal(mk.render_megakernel(small, above, small_cfg, 2, 0, 0), ref))
        print(f"[K5] prefix scene {case} 32x24 2 spp depth 6: equal to plain {same}; mean "
              f"{float(ref.mean()):.4f}; K4 and K4b on its {rays.shape[1]} rays, cull on and off, "
              f"equal to plain {walks}")
        check(same and walks, f"prefix scene {case}: a clustered kernel and plain disagree")


def k5_phase(dev, name, scene, camera, cfg, frame, frame_ms: float, runs: int = 9,
             run_len: int = 16, last_run: bool = False):
    """K5 against its plain version, bit for bit, on a mesh frame (``name``
    says which).
    ``frame`` is K5's full-frame launch at ``cfg``'s spp (``frame_ms`` per
    launch); its pixels are independent, so ``runs`` runs of ``run_len``
    pixels spread down the frame's diagonal (and, with ``last_run``, the
    frame's last ``run_len`` pixels) are held against
    render_megakernel_plain on the same pixels at the same spp.  The plain
    walk counts
    its tests on those pixels, scaled to the frame, and the clusters and
    shade rows they touch: the frame's least time.  Returns (max |d|, frame
    ms, plain ms on the runs, bound ms, bound_by)."""
    import torch

    from rt_tpu_torch import cluster_ops, megakernel as mk

    w, h, spp = camera.image_width, camera.image_height, cfg.samples_per_pixel
    work, winners = {}, set()

    def counted(scene_, cfg_, rays):
        c = scene_.clusters
        t, slot = cluster_ops.cluster_nearest_plain(
            rays, *cluster_ops.cluster_tables(c), c.n_sph_slots, cfg_.t_min, cfg_.t_max,
            cfg_.compat.triangle_backface_cull, work=work)
        winners.update(slot[slot >= 0].unique().tolist())
        return t, slot

    bases = [(h * (2 * k + 1) // (2 * runs)) * w + (w - run_len) * k // (runs - 1)
             for k in range(runs)] + ([w * h - run_len] if last_run else [])
    err, same, refs, plain_ms = 0.0, True, [], 0.0
    for base in bases:
        sync(dev)
        t0 = time.perf_counter()
        ref = mk.render_megakernel_plain(scene, camera, cfg, spp, 0, cfg.seed, pixel_base=base,
                                         n_pixels=run_len, search=counted)
        sync(dev)
        plain_ms += (time.perf_counter() - t0) * 1e3
        got = frame[base : base + run_len]
        err = max(err, float((got - ref).abs().max()))
        same = same and bool(torch.equal(got, ref))
        refs.append(ref)
    refs = torch.cat(refs)
    n_sample = len(bases) * run_len
    print(f"[K5] {name} {w}x{h} {spp} spp depth {cfg.max_depth}: the full-frame launch "
          f"against plain on {len(bases)} runs of {run_len} pixels (first pixels "
          f"{bases}): equal {same}, max|d| {err:.3e}, sample mean {float(refs.mean()):.4f}; "
          f"walk work {walk_counts(work)}, {len(winners)} distinct winners; {row_share(work)}")
    check(same and bool(torch.isfinite(refs).all()) and float(refs.mean()) > 0.01,
          f"K5: kernel and plain version disagree on the {name} frame")
    cl = scene.clusters
    nbytes = (walk_bytes(work, 0, cl.sph_super.shape[0] + cl.tri_super.shape[0])
              + 4 * cl.shade_table.shape[0] * len(winners) + 12 * w * h)
    return err, frame_ms, plain_ms, *walk_bound(work, nbytes, w * h / n_sample)


def mesh_frames_phase(dev, card: str, scenes_: dict, timer):
    """render_image of BASELINE config 3 and 3b through K5 (800x450, depth
    16, 8 spp): wall s, Mray/s, a repeat bit-identical, and K5's ms per
    launch.  Returns (K5 launches of the render_image calls, {name: K5 ms},
    {name: K5's full-frame output})."""
    import numpy as np

    from rt_tpu_torch import megakernel as mk
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.render import render_image

    camera = mesh_cam(MESH_W, MESH_H)
    cfg = RenderConfig(width=MESH_W, height=MESH_H, samples_per_pixel=MESH_SPP,
                       max_depth=MESH_DEPTH)
    frames, runs = {}, {}
    mk.LAUNCHES_CLUSTERED = 0
    for name, scene in scenes_.items():
        img, m = render_image(scene, camera, cfg, device=dev)
        again, m2 = render_image(scene, camera, cfg, device=dev)
        runs[name] = (img, m, again, m2)
    launches = mk.LAUNCHES_CLUSTERED
    kernel_ms = {}
    for name, (img, m, again, m2) in runs.items():
        print(f"[config3] {name} {MESH_W}x{MESH_H} {MESH_SPP} spp (the config's 64 cut to "
              f"{MESH_SPP}) depth {MESH_DEPTH} on {card}: render_image {m['wall_s']:.4f} s "
              f"({m['mray_per_s']:.3f} Mray/s), repeat {m2['wall_s']:.4f} s "
              f"({m2['mray_per_s']:.3f} Mray/s), image mean {float(img.mean()):.4f}")
        check(img.shape == (MESH_H, MESH_W, 3) and bool(np.isfinite(img).all())
              and 0.01 < float(img.mean()) < 5.0, f"{name}: implausible image")
        check(np.array_equal(img, again), f"{name}: two render_image frames differ")
        scene = scenes_[name]
        frames[name], kernel_ms[name] = timer(
            lambda: mk.render_megakernel(scene, camera, cfg, MESH_SPP, 0, cfg.seed), 5)
        rays = MESH_SPP * MESH_W * MESH_H
        print(f"[config3] {name}: K5 {kernel_ms[name]:.3f} ms per launch (CUDA events, mean of 5 "
              f"after a warm-up), {rays / kernel_ms[name] / 1e3:.3f} Mray/s in the kernel")
    print(f"[config3] K5 launches during the render_image frames: {launches}")
    check(launches == 2 * len(scenes_), "the config-3 frames did not go through K5")
    return launches, kernel_ms, frames


def mesh_wavefront_phase(dev, scene, spp: int = 2):
    """The blob frame at ``spp`` through render_pixel_colors with renderer
    "wavefront": one K4 launch per iteration, and the image
    against K5's image of the same frame (the same hash streams).  Returns
    (K4 launches by name, wavefront counts, wall s)."""
    import numpy as np

    from rt_tpu_torch import cluster_ops, megakernel as mk, rng, wavefront
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.render import render_pixel_colors

    camera = mesh_cam(MESH_W, MESH_H)
    cfg = RenderConfig(width=MESH_W, height=MESH_H, samples_per_pixel=spp, max_depth=MESH_DEPTH,
                       renderer="wavefront")
    for name in cluster_ops.LAUNCHES:
        cluster_ops.LAUNCHES[name] = 0
    wavefront.COUNTS.update(iterations=0, segments=0)
    sync(dev)
    t0 = time.perf_counter()
    img = render_pixel_colors(scene, camera, cfg, device=dev).cpu().numpy()
    seconds = time.perf_counter() - t0
    launches, counts = dict(cluster_ops.LAUNCHES), dict(wavefront.COUNTS)
    print(f"[wavefront-mesh] blob {MESH_W}x{MESH_H} {spp} spp depth {MESH_DEPTH}: {seconds:.4f} s, "
          f"{spp * MESH_W * MESH_H / seconds / 1e6:.3f} Mray/s; iterations {counts['iterations']}, "
          f"ray segments {counts['segments']}, K4 launches {launches}")
    check(launches["cluster_worklist_nearest"] == counts["iterations"] > 0,
          "the clustered wavefront did not go through K4 once per iteration")
    k5 = mk.render_megakernel(scene, camera, cfg, spp, 0, rng.key_seed(rng.key(cfg.seed)))
    k5 = k5.reshape(MESH_H, MESH_W, 3).cpu().numpy()
    d = np.abs(img - k5)
    within = float((d <= ATOL + RTOL * np.abs(k5)).all(axis=-1).mean())
    print(f"[wavefront-mesh] against K5's image of the frame: max|d| {d.max():.4e}, mean|d| "
          f"{d.mean():.3e}, pixels within 1e-3 {within:.4%}")
    check(bool(np.isfinite(img).all()) and within >= 0.999,
          "the clustered wavefront's image differs from K5's")
    return launches, counts, seconds


def mesh_progressive_cli_phase(dev, scene, obj_path: str):
    """One progressive pass with the "mega" engine on the blob (K5), and
    the CLI's obj: scene on the card."""
    import numpy as np

    from rt_tpu_torch import megakernel as mk
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.progressive import ProgressiveRenderer

    cfg = RenderConfig(width=MESH_W, height=MESH_H, max_depth=MESH_DEPTH)
    before = mk.LAUNCHES_CLUSTERED
    t0 = time.perf_counter()
    prog = ProgressiveRenderer(scene, mesh_cam(MESH_W, MESH_H), cfg, engine="mega", device=dev)
    prog.run(max_passes=1)
    print(f"[progressive-mesh] one 'mega' pass on the blob: {time.perf_counter() - t0:.3f} s, "
          f"K5 launches {mk.LAUNCHES_CLUSTERED - before}")
    check(prog.engine == "mega" and mk.LAUNCHES_CLUSTERED == before + 1
          and bool(np.isfinite(prog.state.image).all()), "the mega engine did not run K5")
    png = os.path.join("build", "obj_cli.png")
    if os.path.exists(png):
        os.remove(png)
    cmd = [sys.executable, "-m", "rt_tpu_torch.cli", "--scene", f"obj:{obj_path}", "--size",
           "200x112", "--spp", "2", "--out", png]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    print(f"[cli] {' '.join(cmd[1:])}: rc {res.returncode}, {time.perf_counter() - t0:.1f} s")
    for line in res.stderr.strip().splitlines()[-2:]:
        print(f"[cli] {line}")
    check(res.returncode == 0, f"the obj: CLI failed: {res.stderr[-2000:]}")
    with open(png, "rb") as f:
        check(f.read(8) == b"\x89PNG\r\n\x1a\n", "the obj: CLI wrote no PNG")


# K6's plain-version check at reps 1-3: reduce and gather bit for bit (the
# same integer and float arithmetic); scatter's f32 sums run in another
# order than the plain version's matrix product, so each scr element is
# held within 1e-5 of max|scr|, and the plane within 1e-5 of the sum of
# the |scr| terms it adds up (the readings the limits were set from are in
# PERF.md).  Products of bf16-rounded values (the TPU's DEFAULT precision)
# are off by up to 2^-8 of each term, far outside these limits.
MICRO_SCATTER_RTOL = 1e-5


def micro_scatter_limits(scr, reps: int) -> tuple[float, float]:
    """(limit of an scr element, limit of the plane) around the plain
    version's ``scr`` after ``reps`` reps."""
    rows = scr[0, : 8 * 128].abs().reshape(8, 128).sum(dim=1)
    terms = sum(float(rows[rr & 7]) for rr in range(reps))
    return MICRO_SCATTER_RTOL * float(scr.abs().max()), MICRO_SCATTER_RTOL * terms


def micro_exact_cases(dev) -> list:
    """K6's reduce and gather cases whose kernel outputs must equal their
    plain versions' bit for bit, each (label, kernel call, plain call): reps
    1-3; reduce at n 1,024 (default planes) and 8,192 (random planes), and
    on the tie inputs of tests/torch_micro_cases.py (keys 0-39, rays outside
    the plane, initial planes that tie); gather in every mode at 256 and
    1,024 visits from random rows, on the probe's inputs and on the slot
    blocks of tests/torch_micro_cases.gather_hard_inputs."""
    import functools

    import numpy as np
    import torch

    from rt_tpu_torch import micro_probe as mp

    micro_cases = tests_module("torch_micro_cases")
    data = mp.inputs("all", dev)
    r, g = data["reduce"], data["gather"]
    ties = [x.to(dev) for x in micro_cases.tie_reduce_inputs(1)]
    hard = [x.to(dev) for x in micro_cases.gather_hard_inputs(3)]
    rs = np.random.default_rng(1)
    ints = lambda lo, hi, shape: torch.from_numpy(rs.integers(lo, hi, shape).astype(np.int32)).to(dev)
    cases = []
    for reps in (1, 2, 3):
        init = dict(best=ints(0, 1 << 29, (8, 128)), bi=ints(-3, 3, (8, 128)))
        for label, args, kw in (("n 1024", (r["rid"], r["key"], reps, 1024), {}),
                                (f"n {mp.NI}", (r["rid"], r["key"], reps, mp.NI), init),
                                (f"ties n {mp.NI}", (*ties[:2], reps, mp.NI),
                                 dict(best=ties[2], bi=ties[3]))):
            cases.append((f"reduce reps {reps} {label}", functools.partial(mp.reduce, *args, **kw),
                          functools.partial(mp.reduce_plain, *args, **kw)))
        res0 = ints(-9, 9, (mp.NI,))
        for name, (rays_t, slots, item, vcl) in (("", (g["rays_t"], g["slots"], g["item"], g["vcl"])),
                                                 (" hard slots", hard[:4])):
            for mode in mp.MODES:
                for nv in (256, mp.NV):
                    args = (rays_t, slots, item, vcl, reps, nv)
                    kw = dict(mode=mode, res=res0)
                    cases.append((f"gather[{mode}]{name} reps {reps} visits {nv}",
                                  functools.partial(mp.gather, *args, **kw),
                                  functools.partial(mp.gather_plain, *args, **kw)))
    return cases


def micro_parity_phase(dev) -> float:
    """K6's kernels against their plain versions at reps 1-3, at a small n
    and at the probe's n: reduce and gather bit for bit in the cases of
    ``micro_exact_cases``; scatter at 6 chunks and at 18 (past the last
    column block), on destinations repeated across k and across s, from the
    default and from random initial states.  Returns the largest |d| of
    scatter (reduce and gather must be exact)."""
    import numpy as np
    import torch

    from rt_tpu_torch import micro_probe as mp

    cases = micro_exact_cases(dev)
    for label, kernel, plain in cases:
        check(equal(kernel(), plain()), f"K6 {label}: kernel and plain version differ")
    micro_cases = tests_module("torch_micro_cases")
    s = mp.inputs("scatter", dev)["scatter"]
    rs = np.random.default_rng(1)
    worst, scr_max = 0.0, 0.0
    for reps in (1, 2, 3):
        scr0 = torch.from_numpy(rs.standard_normal((8, mp.NI)).astype(np.float32)).to(dev)
        for n_chunks, kw in ((6, {}), (18, dict(scr=scr0))):  # 18: past the last column block
            (out, scr), (p_out, p_scr) = (mp.scatter(s["vals"], s["dst"], reps, n_chunks, **kw),
                                          mp.scatter_plain(s["vals"], s["dst"], reps, n_chunks, **kw))
            d_scr, d_out = float((scr - p_scr).abs().max()), float((out - p_out).abs().max())
            tol_scr, tol_out = micro_scatter_limits(p_scr, reps)
            check(d_scr <= tol_scr and d_out <= tol_out,
                  f"K6 scatter reps {reps} chunks {n_chunks}: |d| {d_scr}, {d_out} over "
                  f"{tol_scr}, {tol_out}")
            print(f"[K6] scatter reps {reps} chunks {n_chunks}: scr max|d| {d_scr:.3e} "
                  f"(limit {tol_scr:.3e}, max|scr| {float(p_scr.abs().max()):.4f}), plane |d| "
                  f"{d_out:.3e} (limit {tol_out:.3e})")
            worst, scr_max = max(worst, d_scr), max(scr_max, float(p_scr.abs().max()))
        # Destinations repeated across k and across s: each lane counts once.
        dst = micro_cases.repeated_dst(mp.SCATTER_SHAPE["kk"], 3).to(dev)
        (out, scr), (p_out, p_scr) = (mp.scatter(s["vals"], dst, reps, 18, scr=scr0),
                                      mp.scatter_plain(s["vals"], dst, reps, 18, scr=scr0))
        d_scr, d_out = float((scr - p_scr).abs().max()), float((out - p_out).abs().max())
        tol_scr, tol_out = micro_scatter_limits(p_scr, reps)
        check(d_scr <= tol_scr and d_out <= tol_out,
              f"K6 scatter reps {reps}, repeated destinations: |d| {d_scr}, {d_out} over "
              f"{tol_scr}, {tol_out}")
        print(f"[K6] scatter reps {reps} chunks 18, destinations repeated across k and s: scr "
              f"max|d| {d_scr:.3e} (limit {tol_scr:.3e}), plane |d| {d_out:.3e} (limit "
              f"{tol_out:.3e})")
        worst = max(worst, d_scr)
    print(f"[K6] reduce and gather equal to plain in {len(cases)} cases (reps 1-3; reduce n 1024 "
          f"and 8192, default, random and tying initial planes; gather 5 modes, 256 and {mp.NV} "
          f"visits, two slot tables, random initial rows); scatter max|d| {worst:.3e} within "
          f"{MICRO_SCATTER_RTOL} x max|scr| ({scr_max:.4f})")
    return worst


def micro_probe_phase(dev):
    """The probe at its defaults through its command line
    (``python -m rt_tpu_torch.micro_probe all --mode sweep``, then the
    unaligned gather), with the launch counts set to 0 just before; then
    each body at 8 and 1,024 reps, also at n/2 and n/8, and its plain
    version's time at 1 rep.  Returns (the CLI's results by name, launches,
    plain ms by body, the 8-to-1,024-rep results by name)."""
    import torch

    from rt_tpu_torch import micro_probe as mp

    for name in mp.LAUNCHES:
        mp.LAUNCHES[name] = 0
    results = mp.main(["all", "--mode", "sweep", "--device", str(dev)])
    results.update(mp.main(["gather", "--mode", "unaligned", "--device", str(dev)]))
    launches = dict(mp.LAUNCHES)
    print(f"[K6] probe launches: {launches}")
    check(all(v > 0 for v in launches.values()), "the probe did not launch every K6 kernel")
    data = mp.inputs("all", dev)
    r, g, s = data["reduce"], data["gather"], data["scatter"]
    sc = mp.SCATTER_SHAPE
    # The reps loop must do its work every rep.  nomath's rep is a fraction
    # of a microsecond, within the timer's noise between 8 and 32 reps, so
    # every body is also timed at 8 and 1,024 reps: t(1024) must exceed t(8).
    bodies = {"reduce": lambda reps: mp.reduce(r["rid"], r["key"], reps, mp.NI),
              "scatter": lambda reps: mp.scatter(s["vals"], s["dst"], reps, mp.NI // sc["ch"], **sc)}
    for mode in mp.MODES:
        bodies[f"gather[{mode}]"] = (lambda reps, mode=mode: mp.gather(
            g["rays_t"], g["slots"], g["item"], g["vcl"], reps, mp.NV, mode=mode))
    long = {}
    for name, fn in bodies.items():
        long[name] = mp.run(f"{name} at 8 and 1024 reps", fn, 8, 1024, results[name]["n"], dev)
        check(long[name]["t_r2_ms"] > long[name]["t_r1_ms"],
              f"K6 {name}: t(1024 reps) is not above t(8 reps): the reps loop did no work")
    # The time per rep must follow n.  It is taken between 8 and 1,024 reps:
    # between 8 and 32, reduce's 24 reps of ~2 us are within the timer's noise.
    # It is held between n and n/8: reduce's one block is latency-bound at
    # n/2 (its ratio there is printed, ~1.25), and the ratio between n and
    # n/8 proves the same thing, that the rep loop does work that grows with n.
    cuts = {
        "reduce": lambda n: (lambda reps: mp.reduce(r["rid"], r["key"], reps, n)),
        "gather[full]": lambda n: (lambda reps: mp.gather(g["rays_t"], g["slots"], g["item"],
                                                          g["vcl"], reps, n)),
        "scatter": lambda n: (lambda reps: mp.scatter(s["vals"], s["dst"], reps, n, **sc)),
    }
    ratios = {}
    for name, fn in cuts.items():
        full = long[name]
        for div in (2, 8):
            n = full["n"] // div
            part = mp.run(f"{name} at n/{div}, 8 and 1024 reps", fn(n), 8, 1024, n, dev)
            slope = lambda x: (x["t_r2_ms"] - x["t_r1_ms"]) / (x["r2"] - x["r1"])
            ratios[name, div] = slope(full) / max(slope(part), 1e-12)
            print(f"[K6] {name}: ms per rep at n {full['n']} / at n {n}: {ratios[name, div]:.3f}")
    # Scatter's chunks run side by side on the card (one block row each),
    # so its time per rep does not follow n up to the 16 chunks.
    check(ratios["reduce", 8] > 1.3 and ratios["gather[full]", 8] > 1.3,
          "K6 reduce or gather: the time per rep does not grow with n")
    plain = {
        "reduce": lambda: mp.reduce_plain(r["rid"], r["key"], 1, mp.NI),
        "gather": lambda: mp.gather_plain(g["rays_t"], g["slots"], g["item"], g["vcl"], 1, mp.NV),
        "scatter": lambda: mp.scatter_plain(s["vals"], s["dst"], 1, mp.NI // sc["ch"], **sc),
    }
    plain_ms = {name: timed_cuda(fn, 5)[1] for name, fn in plain.items()}
    torch.cuda.synchronize()
    return results, launches, plain_ms, long


def micro_reduce_library(dev) -> float:
    """ms of one PyTorch call that computes reduce's state: an int64
    ``scatter_reduce("amin")`` of key << 32 | (item + 1) into the initial
    plane best << 32 (index 0 for the initial value, so a tie keeps it, as
    the body's strict < does).  Held against the plain version once, from
    the default and from a random initial plane; the packing is made before
    the timing, as the kernel's inputs are."""
    import numpy as np
    import torch

    from rt_tpu_torch import micro_probe as mp

    r = mp.inputs("reduce", dev)["reduce"]
    rid = r["rid"].reshape(-1).to(torch.int64)
    packed = (r["key"].reshape(-1).to(torch.int64) << 32) | torch.arange(1, mp.NI + 1, device=dev)
    rs = np.random.default_rng(2)
    for best in (None, torch.from_numpy(rs.integers(0, 1 << 29, (8, 128)).astype(np.int32)).to(dev)):
        bi = torch.from_numpy(rs.integers(-3, 3, (8, 128)).astype(np.int32)).to(dev)
        plane = best if best is not None else torch.full((8, 128), mp.INT32_MAX, device=dev)
        init = plane.reshape(-1).to(torch.int64) << 32
        got = init.scatter_reduce(0, rid, packed, "amin")
        idx = got & 0xFFFFFFFF
        _, p_best, p_bi = mp.reduce_plain(r["rid"], r["key"], 1, mp.NI, best=best, bi=bi)
        same = (torch.equal((got >> 32).to(torch.int32), p_best.reshape(-1))
                and torch.equal(torch.where(idx > 0, idx - 1, bi.reshape(-1).to(torch.int64))
                                .to(torch.int32), p_bi.reshape(-1)))
        check(same, "K6 reduce: the packed scatter_reduce and the plain version differ")
    init = torch.full((mp.R,), mp.INT32_MAX, dtype=torch.int64, device=dev) << 32
    _, ms = timed_cuda(lambda: init.scatter_reduce(0, rid, packed, "amin"), 20)
    print(f"[K6] reduce's library call (packed int64 scatter_reduce amin) equal to plain; "
          f"{ms:.5f} ms per call")
    return ms


def micro_bounds(dev) -> dict:
    """Least time of one rep of each K6 body at the probe's inputs: each
    input read once and each output written once, and the operations that
    these inputs need (gather: FLOPS_SPHERE_TEST for every (item, lane)
    pair and FLOPS_SPHERE_ROOT for each pair with disc >= 0 and rad > 0,
    counted on the probe's inputs, as K1-K3 are counted; reduce: a compare
    per item; scatter: an add per (destination, value row) that lands in a
    written column block)."""
    from rt_tpu_torch import micro_probe as mp

    data = mp.inputs("all", dev)
    g, s = data["gather"], data["scatter"]
    sc = mp.SCATTER_SHAPE
    reduce_b = bound(mp.NI, 8 * mp.NI)  # a rep reads rid and key; the planes move once a launch
    clusters = int(g["vcl"].reshape(-1)[: mp.NV].unique().numel())
    rays = int(g["item"].reshape(-1)[: mp.NI].unique().numel())
    pairs = mp.NV * 8 * 128
    _, disc, _, rad = tests_module("torch_micro_cases").gather_pairs(
        g["rays_t"], g["slots"], g["item"], g["vcl"], mp.NV)
    admitted = int(((disc >= 0.0) & (rad > 0.0)).sum())
    gather_b = bound(pairs * FLOPS_SPHERE_TEST + admitted * FLOPS_SPHERE_ROOT,
                     rays * 32 + clusters * 4 * 128 * 4 + 4 * (mp.NI + mp.NV) + 4 * mp.NI)
    print(f"[K6] gather: {admitted} of its {pairs} pairs a rep admitted (disc >= 0, rad > 0)")
    in_range = int((s["dst"] < mp.NI).sum())  # 16 chunks of 512 cover [0, 8192)
    scatter_b = bound(in_range * sc["nvrows"],
                      4 * s["vals"].numel() + 4 * s["dst"].numel() + 4 * sc["nvrows"] * mp.NI)
    return {"reduce": reduce_b, "gather": gather_b, "scatter": scatter_b}


def bvh_walk_phase(dev, scene, camera, cfg, timer, n: int = 65_536):
    """The BVH walk kernel against the plain walk on ``n`` rays of the
    config-3 blob frame (camera rays and first bounces), bit for bit, with
    culling on and off.  Returns (kernel ms, plain ms, hits)."""
    import torch

    from rt_tpu_torch.bvh import traverse
    from rt_tpu_torch.config import CompatConfig

    rays = mesh_rays(scene, camera, cfg, n, dev)
    org, dirn = rays[0:3].T.contiguous(), rays[3:6].T.contiguous()
    for cull in (True, False):
        compat = CompatConfig(triangle_backface_cull=cull)
        got = traverse.bvh_walk(scene, org, dirn, cfg.t_min, cfg.t_max, compat)
        sync(dev)
        t0 = time.perf_counter()
        ref = traverse.bvh_walk_plain(scene, org, dirn, cfg.t_min, cfg.t_max, compat)
        sync(dev)
        plain_s = time.perf_counter() - t0
        same = bool(torch.equal(got[0], ref[0])) and bool(torch.equal(got[1], ref[1]))
        hits = int((ref[1] >= 0).sum())
        print(f"[bvh] walk kernel, {n} rays (camera + first bounce) x {scene.num_triangles} "
              f"triangles, cull {cull}: t and prim equal to the plain walk {same}, hits {hits}, "
              f"plain walk {plain_s:.2f} s")
        check(same and hits > n // 4, "the BVH walk kernel and the plain walk disagree")
    compat = cfg.compat
    _, walk_ms = timer(lambda: traverse.bvh_walk(scene, org, dirn, cfg.t_min, cfg.t_max, compat), 5)
    _, plain_ms = timer(
        lambda: traverse.bvh_walk_plain(scene, org, dirn, cfg.t_min, cfg.t_max, compat), 1)
    return walk_ms, plain_ms, hits


def mesh_grad_phase(dev, scene, card: str, depth: int = 6, reps: int = 2):
    """grad.pixel_grad on the config-3 blob at bench_grad.py's shape: 800x450,
    every pixel at 1 spp, diff_max_depth 6, key 0, zero target, all seven
    SceneParams leaves.  Finite and nonzero; a second call bit-identical;
    a 16x9 pixel block equal, bit for bit, to the same step with the plain
    walk.  Returns the warm wall s per step."""
    import torch

    from rt_tpu_torch import grad, rng
    from rt_tpu_torch.bvh import traverse
    from rt_tpu_torch.config import RenderConfig

    camera = mesh_cam(MESH_W, MESH_H)
    cfg = RenderConfig(width=MESH_W, height=MESH_H, diff_max_depth=depth)
    n = MESH_W * MESH_H
    args = (scene, camera, cfg, torch.arange(n, device=dev), torch.zeros((n, 3), device=dev),
            rng.key(0))
    traverse.LAUNCHES["bvh_walk"] = 0
    sync(dev)
    t0 = time.perf_counter()
    loss, g = grad.pixel_grad(*args)
    sync(dev)
    cold_s = time.perf_counter() - t0
    launches = traverse.LAUNCHES["bvh_walk"]
    print(f"[grad-mesh] pixel_grad config-3 blob {MESH_W}x{MESH_H} 1 spp, diff_max_depth {depth}: "
          f"loss {loss.item():.9g}, first call {cold_s:.3f} s, walk kernel launches {launches} "
          f"(forward + checkpointed recompute)")
    check(launches == 2 * (depth + 1), "the mesh gradient path did not go through the walk kernel")
    check(bool(torch.isfinite(loss)) and loss.item() > 0, "non-finite or zero loss on the blob")
    for leaf in grad.SceneParams._fields:
        v = getattr(g, leaf)
        check(bool(torch.isfinite(v).all()), f"non-finite gradient in {leaf}")
        print(f"[grad-mesh]   {leaf:18s} shape {tuple(v.shape)}, max|g| {float(v.abs().max()):.6g}")
    check(float(g.tex_color.abs().max()) > 0 and float(g.sky_exposure.abs()) > 0,
          "zero tex_color or exposure gradient on the blob")
    loss2, g2 = grad.pixel_grad(*args)
    same = bool(torch.equal(loss, loss2)) and all(bool(torch.equal(a, b)) for a, b in zip(g, g2))
    print(f"[grad-mesh] a second call is bit-identical in loss and every leaf: {same}")
    check(same, "two pixel_grad calls on the blob differ")
    # The first 16x9 block down the frame's middle column whose paths carry
    # light at 1 spp (inside the blob's silhouette every path of a block
    # can end dark within diff_max_depth bounces, a zero loss).
    for y0 in (MESH_H // 2 - 5, MESH_H * 3 // 4, MESH_H // 4, MESH_H - 12):
        x0 = MESH_W // 2 - 8
        ys, xs = torch.meshgrid(torch.arange(y0, y0 + 9), torch.arange(x0, x0 + 16), indexing="ij")
        block = (ys * MESH_W + xs).reshape(-1).to(dev)
        b_args = (scene, camera, cfg, block, torch.zeros((block.numel(), 3), device=dev),
                  rng.key(0))
        lk, gk = grad.pixel_grad(*b_args)
        if lk.item() > 0:
            break
        print(f"[grad-mesh] 16x9 block at rows {y0}-{y0 + 8}: loss 0, trying the next")
    sync(dev)
    t0 = time.perf_counter()
    lp, gp = grad.pixel_grad(*b_args, bvh_walk=traverse.bvh_walk_plain)
    sync(dev)
    plain_s = time.perf_counter() - t0
    same = bool(torch.equal(lk, lp)) and all(bool(torch.equal(a, b)) for a, b in zip(gk, gp))
    print(f"[grad-mesh] 16x9 block (rows {y0}-{y0 + 8}, columns {x0}-{x0 + 15}): kernel walk "
          f"equal to the plain "
          f"walk in loss and every leaf {same} (loss {lk.item():.6g}; plain walk step {plain_s:.1f} s)")
    check(same and lk.item() > 0, "the blob gradient differs between the walk kernel and the plain walk")
    # The timed calls are held against the first too (torch.equal's host
    # sync is inside the timing, a few ms of a ~2 s step).
    same_runs = []
    step_s = wall(lambda: same_runs.append(
        torch.equal(loss, (r := grad.pixel_grad(*args))[0])
        and all(torch.equal(a, b) for a, b in zip(g, r[1]))), reps, dev)
    print(f"[grad-mesh] warm wall per pixel_grad step on {card}: {step_s:.4f} s (mean of {reps}); "
          f"the {len(same_runs)} timed calls are bit-identical to the first: {same_runs}")
    check(all(same_runs), "a timed pixel_grad call on the blob differs from the first")
    return step_s


def mesh_chunked_phase(dev, scene, card: str, k5_mean: float, spp: int = 2):
    """render_pixel_colors(wavefront=False) of the config-3 blob at ``spp``
    and max depth 16: finite, a repeat bit-identical, Mray/s, and its mean
    against K5's 8-spp frame mean within 10% (the streams differ: jax.random
    here, the counter hash in K5).  Returns the wall s."""
    import numpy as np
    import torch

    from rt_tpu_torch.bvh import traverse
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.render import render_pixel_colors

    camera = mesh_cam(MESH_W, MESH_H)
    cfg = RenderConfig(width=MESH_W, height=MESH_H, samples_per_pixel=spp, max_depth=MESH_DEPTH)
    traverse.LAUNCHES["bvh_walk"] = 0
    sync(dev)
    t0 = time.perf_counter()
    img = render_pixel_colors(scene, camera, cfg, device=dev, wavefront=False)
    host = img.cpu().numpy()
    seconds = time.perf_counter() - t0
    launches = traverse.LAUNCHES["bvh_walk"]
    mean = float(host.mean())
    rays = spp * MESH_W * MESH_H
    print(f"[chunked-mesh] render_pixel_colors(wavefront=False) blob {MESH_W}x{MESH_H} {spp} spp "
          f"depth {MESH_DEPTH} on {card}: {seconds:.4f} s, {rays / seconds / 1e6:.4f} Mray/s, walk "
          f"kernel launches {launches}; image mean {mean:.5f}, K5's 8-spp frame mean {k5_mean:.5f}")
    check(launches >= 1, "the chunked mesh frame did not go through the walk kernel")
    check(host.shape == (MESH_H, MESH_W, 3) and bool(np.isfinite(host).all()),
          "the chunked mesh frame is not finite")
    again = render_pixel_colors(scene, camera, cfg, device=dev, wavefront=False)
    check(bool(torch.equal(img, again)), "two chunked mesh frames differ")
    check(abs(mean - k5_mean) <= 0.1 * k5_mean, "the chunked mesh frame's mean is off K5's by > 10%")
    print("[chunked-mesh] a repeat is bit-identical; the mean is within 10% of K5's")
    return seconds


def defocus_phase(dev, card: str, spp: int = 2):
    """The cover scene through cam2 (thin lens, 0.7 degrees) on the chunked
    path, whose disc comes from jax.random's stream, against K1's frame of
    the same camera (the counter hash's disc): finite, and the means within
    10%.  Returns the wall s."""
    import numpy as np

    from rt_tpu_torch import megakernel as mk, scenes
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.render import render_pixel_colors

    camera = scenes.cam2(400, 225)
    check(camera.defocus_on, "cam2 does not defocus")
    scene = scenes.cover_scene(11, 11, camera, z=-0.2, seed=0).to(dev)
    cfg = RenderConfig(width=400, height=225, samples_per_pixel=spp, max_depth=16)
    sync(dev)
    t0 = time.perf_counter()
    img = render_pixel_colors(scene, camera, cfg, device=dev, wavefront=False).cpu().numpy()
    seconds = time.perf_counter() - t0
    k1 = mk.render_megakernel(scene, camera, cfg, spp, 0, cfg.seed).cpu().numpy()
    print(f"[defocus] chunked cover frame through cam2 (defocus 0.7 deg) 400x225 {spp} spp on "
          f"{card}: {seconds:.4f} s, mean {float(img.mean()):.5f}; K1's frame mean "
          f"{float(k1.mean()):.5f}")
    check(bool(np.isfinite(img).all()) and abs(float(img.mean()) - float(k1.mean()))
          <= 0.1 * float(k1.mean()), "the defocused chunked frame is off")
    return seconds


# The live skies of the sky phase: config 4's, config 5's (bench_scenes.py's
# skies) and one whose elevation comes from a sun off the zenith.
LIVE_SKIES = {
    "config4": dict(turbidity=3.0, albedo=0.3, elevation=0.8),
    "config5": dict(turbidity=8.0, albedo=0.1, elevation=0.07, exposure=0.35),
    "tilted_sun": dict(turbidity=2.5, albedo=0.6, sun_direction=(0.3, -0.4, 0.5), exposure=0.8),
}
SKY_RTOL = 1e-5  # the card's transcendentals against the CPU's (tests/test_torch_sky_hosek.py)
SKY_ATOL = 1e-6


def live_sky_phase(dev, card: str, timer):
    """The live Hosek-Wilkie sky: ``hosek_config`` and ``sky_color_toward``
    on the card against the CPU at three skies (65,536 seeded unit
    directions), then the bench cover frame under hosek(3.0, 0.3, 0.8)
    through ``render_image`` (K1), equal bit for bit to the plain version
    on the same frame.  Returns (K1 launches of the render_image call, K1
    ms per launch, plain ms)."""
    import numpy as np
    import torch

    from rt_tpu_torch import megakernel as mk
    from rt_tpu_torch import sky
    from rt_tpu_torch.render import render_image
    from rt_tpu_torch.scenes import bench_cover_config
    from rt_tpu_torch.sky import SkyParams

    dirs = np.random.default_rng(11).normal(size=(65_536, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs_cpu = torch.from_numpy(dirs)
    for name, kw in LIVE_SKIES.items():
        params = SkyParams.hosek(**kw)
        elevation = kw.get("elevation", float(torch.arcsin(params.sun_direction[2])))
        point = (kw["turbidity"], kw["albedo"], elevation)
        hw_card = sky.hosek_config(*(torch.tensor(v, device=dev) for v in point)).cpu()
        hw_cpu = params.hw_params
        got = sky.sky_color_toward(params, dirs_cpu.to(dev)).cpu()
        ref = sky.sky_color_toward(params, dirs_cpu)
        hw_ok = bool(torch.allclose(hw_card, hw_cpu, rtol=SKY_RTOL, atol=SKY_ATOL))
        sky_ok = bool(torch.allclose(got, ref, rtol=SKY_RTOL, atol=SKY_ATOL))
        print(f"[sky] hosek({', '.join(f'{k}={v}' for k, v in kw.items())}): hosek_config on the "
              f"card against the CPU max|d| {float((hw_card - hw_cpu).abs().max()):.3e}; "
              f"sky_color_toward on {dirs.shape[0]} directions max|d| "
              f"{float((got - ref).abs().max()):.3e}, mean {float(ref.mean()):.4f}")
        check(hw_ok and sky_ok and bool(torch.isfinite(got).all()),
              f"the live sky {name} differs between the card and the CPU")
    scene, camera, cfg = bench_cover_config()
    scene.sky = SkyParams.hosek(**LIVE_SKIES["config4"])
    mk.LAUNCHES = 0
    img, m = render_image(scene, camera, cfg, device=dev)
    launches = mk.LAUNCHES
    check(launches == 1, "the live-sky cover frame did not go through K1")
    sync(dev)
    t0 = time.perf_counter()
    plain = mk.render_megakernel_plain(scene, camera, cfg, cfg.samples_per_pixel, 0, cfg.seed)
    sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    h, w = img.shape[:2]
    same = np.array_equal(img, plain.reshape(h, w, 3).cpu().numpy())
    _, ms = timer(lambda: mk.render_megakernel(scene, camera, cfg, cfg.samples_per_pixel, 0,
                                               cfg.seed), 5)
    print(f"[sky] bench cover frame {w}x{h} {cfg.samples_per_pixel} spp under hosek(3.0, 0.3, 0.8) "
          f"on {card}: render_image {m['wall_s']:.4f} s, K1 launches {launches}, equal to plain "
          f"{same} (image mean {float(img.mean()):.4f}); K1 {ms:.3f} ms per launch, plain "
          f"{plain_ms:.0f} ms (wall)")
    check(same and bool(np.isfinite(img).all()), "K1 under the live sky disagrees with plain")
    return launches, ms, plain_ms


def gltf_frames_phase(dev, card: str, fixtures: dict, timer, runs: int = 4):
    """BASELINE config 4 (bench_scenes.py:144-170): the armor-class glb at
    its full size (3 parts, 54,720 triangles, 2 ground triangles) under
    hosek(3.0, 0.3, 0.8) at 800x450, depth 16, cut to MESH_SPP: two
    ``render_image`` frames through K5, bit-identical, equal to K5's timed
    launch; and K5 against plain on ``runs`` 16-pixel runs down the
    diagonal.  Returns (K5 launches of the render_image calls, k5_phase's
    result)."""
    import numpy as np

    import bench_scenes_cuda as bsc
    from rt_tpu_torch import megakernel as mk
    from rt_tpu_torch.render import render_image

    timings = {}
    scene, camera, cfg = bsc.config4_setup(fixtures, timings=timings)
    cfg = cfg.replace(samples_per_pixel=MESH_SPP)
    cl = scene.clusters
    print(f"[config4] {fixtures['glb']}: {scene.num_triangles} triangles, loaded in "
          f"{timings['load_s']:.2f} s, tables, cluster tables and BVH built on the host in "
          f"{timings['build_s']:.2f} s: {cl.tri_cluster.shape[0]} triangle clusters, slot table "
          f"{tuple(cl.shade_table.shape)}, atlas {tuple(scene.atlas.shape)}")
    check(scene.num_triangles == 54_722 and scene.has_image_textures
          and mk.eligible_clustered(scene, cfg), "config 4's scene is not the full fixture")
    scene.to(dev)
    mk.LAUNCHES_CLUSTERED = 0
    img, m = render_image(scene, camera, cfg, device=dev)
    again, m2 = render_image(scene, camera, cfg, device=dev)
    launches = mk.LAUNCHES_CLUSTERED
    w, h = camera.image_width, camera.image_height
    print(f"[config4] armor {w}x{h} {MESH_SPP} spp (the config's 64 cut to {MESH_SPP}) depth "
          f"{cfg.max_depth} under hosek(3.0, 0.3, 0.8) on {card}: render_image {m['wall_s']:.4f} s "
          f"({m['mray_per_s']:.3f} Mray/s), repeat {m2['wall_s']:.4f} s ({m2['mray_per_s']:.3f} "
          f"Mray/s), image mean {float(img.mean()):.4f}; K5 launches {launches}")
    check(launches == 2, "the config-4 frames did not go through K5")
    check(img.shape == (h, w, 3) and bool(np.isfinite(img).all())
          and 0.01 < float(img.mean()) < 5.0, "config 4: implausible image")
    check(np.array_equal(img, again), "config 4: two render_image frames differ")
    frame, ms = timer(lambda: mk.render_megakernel(scene, camera, cfg, MESH_SPP, 0, cfg.seed), 5)
    check(np.array_equal(frame.reshape(h, w, 3).cpu().numpy(), img),
          "config 4: K5's timed launch differs from render_image's frame")
    print(f"[config4] K5 {ms:.3f} ms per launch (CUDA events, mean of 5 after a warm-up), "
          f"{MESH_SPP * w * h / ms / 1e3:.3f} Mray/s in the kernel")
    return launches, k5_phase(dev, "config-4 armor", scene, camera, cfg, frame, ms, runs=runs)


# BASELINE config 5 cut: 1920x1080, depth 12, 20 spp in five 4-spp sweeps
# (the config's 256 in 64); bench_scenes_cuda.config5_schedule then writes a
# checkpoint every 2 sweeps, so the resume at the midpoint (sweep 3) starts
# from sweep 2's checkpoint and renders sweep 3 again.
CONFIG5_SPP = 20


def progressive_gltf_phase(dev, card: str, fixtures: dict, timer, runs: int = 3):
    """BASELINE config 5 (bench_scenes.py:173-259): the car-class glb at its
    full size (5 parts, 162,560 triangles, 2 ground triangles) under the
    low-sun sky at 1920x1080, progressive on the "mega" engine (K5): an
    uninterrupted run of CONFIG5_SPP spp, and bench_scenes_cuda's run
    resumed at mid-run by a fresh renderer from an earlier checkpoint, its
    accumulator bit-identical to the uninterrupted one; then K5's 4-spp
    sweep launch timed and held against plain on ``runs`` 16-pixel runs
    down the diagonal and on the frame's last 16 pixels (K5's pixel claims
    and output rows reach the end of its largest launch); then the sweep-sum
    kernel, counted from 0 just before, adding that sweep's colours into the
    uninterrupted run's sum on the card, bit-equal to numpy's, and timed
    beside the plain two-op form.
    Returns (K5 launches of the uninterrupted run, k5_phase's result, the
    uninterrupted run's wall s, the sweep sum's (launches of the
    uninterrupted run, max abs error, ms, plain ms, bound ms, bound by))."""
    import numpy as np
    import torch

    import bench_scenes_cuda as bsc
    from rt_tpu_torch import megakernel as mk
    from rt_tpu_torch import progressive
    from rt_tpu_torch.progressive import ProgressiveRenderer

    timings = {}
    scene, camera, cfg = bsc.config5_setup(fixtures, timings=timings)
    cl = scene.clusters
    print(f"[config5] {fixtures['car']}: {scene.num_triangles} triangles, loaded in "
          f"{timings['load_s']:.2f} s, tables, cluster tables and BVH built on the host in "
          f"{timings['build_s']:.2f} s: {cl.tri_cluster.shape[0]} triangle clusters, slot table "
          f"{tuple(cl.shade_table.shape)}, atlas {tuple(scene.atlas.shape)}")
    check(scene.num_triangles == 162_562 and scene.has_image_textures,
          "config 5's scene is not the full fixture")
    scene.to(dev)
    w, h = camera.image_width, camera.image_height
    schedule, every = bsc.config5_schedule(CONFIG5_SPP)
    mk.LAUNCHES_CLUSTERED = progressive.DEVICE_SUMS = 0
    sync(dev)
    t0 = time.perf_counter()
    whole = ProgressiveRenderer(scene, camera, cfg, schedule=schedule, engine="mega", device=dev)
    whole.run()
    whole_s = time.perf_counter() - t0
    launches = mk.LAUNCHES_CLUSTERED
    rays = CONFIG5_SPP * w * h
    print(f"[config5] car {w}x{h} depth {cfg.max_depth}, {len(schedule.passes())} sweeps of "
          f"{schedule.passes()[0]} spp ({CONFIG5_SPP} spp, the config's 256 cut) on {card}: "
          f"{whole_s:.3f} s, {rays / whole_s / 1e6:.3f} Mray/s; K5 launches {launches}, "
          f"sums on the card {progressive.DEVICE_SUMS}; image mean "
          f"{float(whole.state.image.mean()):.4f}")
    check(whole.engine == "mega" and launches == len(schedule.passes())
          and progressive.DEVICE_SUMS == launches
          and whole.state.total_spp == CONFIG5_SPP and bool(np.isfinite(whole.state.accum).all()),
          "config 5: the progressive run did not go through K5 and the sweep sum")
    ckpt = os.path.join("build", "config5_smoke.npz")
    mk.LAUNCHES_CLUSTERED = progressive.DEVICE_SUMS = 0
    resumed, spp, resumed_s = bsc.run_config5(scene, camera, cfg, CONFIG5_SPP, ckpt, dev)
    same = np.array_equal(resumed.state.accum, whole.state.accum)
    print(f"[config5] checkpoint every {every} sweeps, resumed at the midpoint by a fresh "
          f"renderer: {resumed_s:.3f} s, K5 launches {mk.LAUNCHES_CLUSTERED} (a re-rendered "
          f"sweep), sums on the card {progressive.DEVICE_SUMS}; accumulator "
          f"({resumed.state.accum.nbytes / 1e6:.1f} MB) bit-identical to the uninterrupted run "
          f"{same}")
    check(same and spp == CONFIG5_SPP and mk.LAUNCHES_CLUSTERED == launches + 1
          and progressive.DEVICE_SUMS == launches + 1,
          "config 5: the resumed run differs from the uninterrupted run")
    sweep_cfg = cfg.replace(samples_per_pixel=schedule.passes()[0])
    spw = sweep_cfg.samples_per_pixel
    frame, ms = timer(lambda: mk.render_megakernel(scene, camera, sweep_cfg, spw, 0, cfg.seed), 3)
    print(f"[config5] K5 {ms:.3f} ms per {spw}-spp sweep launch at {w}x{h} (CUDA events, mean of "
          f"3 after a warm-up), {spw * w * h / ms / 1e3:.3f} Mray/s in the kernel")
    k5 = k5_phase(dev, "config-5 car", scene, camera, sweep_cfg, frame, ms, runs=runs,
                  last_run=True)

    # The sweep sum: this sweep's colours into the run's (non-zero) sum.
    want = whole.state.accum + frame.cpu().numpy().reshape(h, w, 3) * spw
    acc = torch.from_numpy(whole.state.accum.copy()).to(dev)
    progressive.DEVICE_SUMS = 0
    progressive.accumulate_sweep(acc, frame, spw)
    got = acc.cpu().numpy()
    sum_err = float(np.abs(got - want).max())
    check(np.array_equal(got, want) and progressive.DEVICE_SUMS == 1,
          "config 5: the sweep-sum kernel differs from numpy's sum")
    _, sum_ms = timer(lambda: progressive.accumulate_sweep(acc, frame, spw), 20)
    _, sum_plain_ms = timer(lambda: acc.add_(frame.reshape(acc.shape) * spw), 20)
    # Two operations a float; colours and the sum read once, the sum written once.
    sum_bound = bound(2 * 3 * w * h, 3 * w * h * 12)
    print(f"[config5] sweep sum at {w}x{h}: bit-equal to numpy on the sweep's colours and the "
          f"run's sum (max abs err {sum_err}); kernel {sum_ms * 1e3:.2f} us, plain two-op form "
          f"{sum_plain_ms * 1e3:.2f} us (CUDA events, mean of 20 after a warm-up), bound "
          f"{sum_bound[0] * 1e3:.2f} us by {sum_bound[1]} ({100 * sum_bound[0] / sum_ms:.1f}% "
          f"reached)")
    return launches, k5, whole_s, (launches, sum_err, sum_ms, sum_plain_ms, *sum_bound)


def bench_lines_phase(dev):
    """bench_cuda.main and bench_grad_cuda.main at their defaults on the
    card (their JSON lines are printed), through K1 and K2."""
    import bench_cuda
    import bench_grad_cuda
    from rt_tpu_torch import megakernel as mk
    from rt_tpu_torch import nearest_ops

    mk.LAUNCHES = 0
    check(bench_cuda.main([]) == 0, "bench_cuda.py failed")
    k1 = mk.LAUNCHES
    for name in nearest_ops.LAUNCHES:
        nearest_ops.LAUNCHES[name] = 0
    check(bench_grad_cuda.main([]) == 0, "bench_grad_cuda.py failed")
    k2 = nearest_ops.LAUNCHES["sphere_nearest"]
    print(f"[bench] K1 launches in bench_cuda.main {k1}, K2 launches in bench_grad_cuda.main {k2}")
    check(k1 == 4 and k2 > 0, "the bench scripts did not go through K1 and K2")


# The sphere covers of cluster_bench_cuda.py (tools/cluster_bench.py:69-73)
# at its 800x450 and depth 50; the sample count is cut from 64 to 4 to fit
# this script's time.
SPHERE_W, SPHERE_H, SPHERE_DEPTH, SPHERE_SPP = 800, 450, 50, 4


def sphere_cluster_phase(dev, card: str, timer) -> dict:
    """Sphere-cluster scenes on the card: the 40k- and 360k-sphere covers of
    cluster_bench_cuda.py at 800x450, depth 50 and 4 spp.  Each: the host's
    scene build (``SceneBuilder.build`` apart) and the tables' bytes on the
    card; ``render_image`` through K5 (launches counted from 0 just
    before), equal to the timed K5 launch; K5 against plain on 4 runs of 16
    pixels down the diagonal and the frame's last 16; the clustered
    wavefront at 1 spp (K4 launches counted from 0 just before) against
    K5's 1-spp image; and K4 against plain on the frame's rays (the whole
    ``cluster_phase`` on the 40k cover).  Returns {"40k"|"360k": results},
    the 40k scene, camera, cfg and image kept for the sharding phase."""
    import numpy as np
    import torch

    from cluster_bench_cuda import SPHERE_COVERS, table_bytes, timed_scene
    from rt_tpu_torch import cluster_ops, megakernel as mk, scenes, wavefront
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.render import render_image, render_pixel_colors

    camera = scenes.cam1(SPHERE_W, SPHERE_H)
    cfg = RenderConfig(width=SPHERE_W, height=SPHERE_H, samples_per_pixel=SPHERE_SPP,
                       max_depth=SPHERE_DEPTH)
    out = {}
    for key in ("40k", "360k"):
        name, grid = SPHERE_COVERS[key]
        scene, scene_s, build_s = timed_scene(
            lambda: scenes.cover_scene(grid, grid, camera, z=-0.2, seed=0))
        scene.to(dev)
        cl = scene.clusters
        nbytes = table_bytes(scene)
        print(f"[spheres] {name}: {scene.num_spheres} spheres + {scene.num_triangles} triangles; "
              f"scene on the host {scene_s:.2f} s, of which SceneBuilder.build {build_s:.2f} s; "
              f"tables {nbytes / 1e6:.1f} MB on {card} ({cl.sph_cluster.shape[0]} sphere and "
              f"{cl.tri_cluster.shape[0]} triangle cluster rows, {cl.shade_table.shape[1]} slots, "
              f"{len(cluster_pages(cl))} pages)")
        check(mk.eligible_clustered(scene, cfg), f"{name}: no cluster tables")
        mk.LAUNCHES_CLUSTERED = 0
        img, m = render_image(scene, camera, cfg, device=dev)
        k5_launches = mk.LAUNCHES_CLUSTERED
        print(f"[spheres] {name} {SPHERE_W}x{SPHERE_H} {SPHERE_SPP} spp (cluster_bench's 64 cut "
              f"to {SPHERE_SPP}) depth {SPHERE_DEPTH}: render_image {m['wall_s']:.4f} s "
              f"({m['mray_per_s']:.3f} Mray/s), image mean {float(img.mean()):.4f}; K5 launches "
              f"{k5_launches}")
        check(k5_launches == 1 and bool(np.isfinite(img).all()) and 0.01 < float(img.mean()) < 5,
              f"{name}: render_image did not go through K5, or its image is implausible")
        frame, ms = timer(lambda: mk.render_megakernel(scene, camera, cfg, SPHERE_SPP, 0,
                                                       cfg.seed), 3)
        check(np.array_equal(frame.reshape(SPHERE_H, SPHERE_W, 3).cpu().numpy(), img),
              f"{name}: render_image differs from the timed K5 launch")
        print(f"[spheres] {name}: K5 {ms:.3f} ms per launch (CUDA events, mean of 3 after a "
              f"warm-up), {SPHERE_SPP * SPHERE_W * SPHERE_H / ms / 1e3:.3f} Mray/s in the kernel")
        k5 = k5_phase(dev, f"{name} cover", scene, camera, cfg, frame, ms, runs=4, last_run=True)
        for fn in cluster_ops.LAUNCHES:
            cluster_ops.LAUNCHES[fn] = 0
        wavefront.COUNTS.update(iterations=0, segments=0)
        sync(dev)
        t0 = time.perf_counter()
        wf = render_pixel_colors(scene, camera, cfg.replace(renderer="wavefront"), device=dev,
                                 spp=1).cpu().numpy()
        wf_s = time.perf_counter() - t0
        k4_launches = cluster_ops.LAUNCHES["cluster_worklist_nearest"]
        ref1 = mk.render_megakernel(scene, camera, cfg, 1, 0, cfg.seed)
        ref1 = ref1.reshape(SPHERE_H, SPHERE_W, 3).cpu().numpy()
        d = np.abs(wf - ref1)
        within = float((d <= ATOL + RTOL * np.abs(ref1)).all(axis=-1).mean())
        print(f"[spheres] {name}: the clustered wavefront at 1 spp {wf_s:.3f} s, iterations "
              f"{wavefront.COUNTS['iterations']}, K4 launches {k4_launches}; against K5's "
              f"1-spp image max|d| {d.max():.3e}, pixels within 1e-3 {within:.4%}")
        check(k4_launches == wavefront.COUNTS["iterations"] > 0 and within >= 0.999,
              f"{name}: the clustered wavefront did not run K4 an iteration, or differs from K5")
        if key == "40k":
            k4, _ = cluster_phase(dev, scene, camera, cfg, timer)
        else:
            k4 = k4_rays_phase(dev, scene, camera, cfg, timer)[0]
        out[key] = {"k5": k5, "k5_launches": k5_launches, "k4": k4, "k4_launches": k4_launches,
                    "scene_s": scene_s, "build_s": build_s, "bytes": nbytes,
                    "mray": m["mray_per_s"]}
        if key == "40k":
            out["cover40k"] = (scene, camera, cfg, img)
        else:
            del scene, frame
            torch.cuda.empty_cache()
    return out


def front_end_phase(dev, card: str):
    """The front ends on the card: ``cli --probe`` against the CPU probe
    (floats within 1e-5); a "mega" progressive run (K1) feeding
    ``PreviewServer`` through ``on_sweep``: ``/frame.png`` decodes to the
    image the run writes, ``/probe`` answers as the CPU probe; and the CLI
    with ``--progressive --engine mega --serve 0 --term-preview``, its
    output captured.  Returns K1's launches in the viewer's run."""
    import io
    import urllib.request

    import numpy as np

    from rt_tpu_torch import cli, megakernel as mk, scenes
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.debug import debug_pixel
    from rt_tpu_torch.io import write_png
    from rt_tpu_torch.io.png_io import decode_png
    from rt_tpu_torch.progressive import ProgressiveRenderer
    from rt_tpu_torch.viewer import PreviewServer

    def same_probe(got, ref) -> bool:
        for k, v in ref.items():
            if isinstance(v, list) or isinstance(v, float):
                a, b = np.asarray(got[k], np.float64), np.asarray(v, np.float64)
                if not (np.abs(a - b) <= 1e-5 + 1e-5 * np.abs(b)).all():
                    return False
            elif got[k] != v:
                return False
        return set(got) == set(ref)

    def get(url):
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.read()

    w, h, xy = 400, 225, (200, 150)
    camera = scenes.cam1(w, h)
    scene = scenes.cover_scene(11, 11, camera, z=-0.2, seed=0)
    cfg = RenderConfig(width=w, height=h, max_depth=50)
    cpu_probe = debug_pixel(scene, camera, *xy, cfg, device="cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        rc = cli.main(["--scene", "cover", "--size", f"{w}x{h}", "--probe", "%d,%d" % xy])
    card_probe = json.loads(out.getvalue())
    print(f"[front] cli --probe {xy[0]},{xy[1]} on the card: rc {rc}, {card_probe['material']} "
          f"prim {card_probe['prim']} t {card_probe['t']:.6f}; equal to the CPU probe within "
          f"1e-5: {same_probe(card_probe, cpu_probe)}")
    check(rc == 0 and same_probe(card_probe, cpu_probe), "cli --probe: card and CPU disagree")

    scene.to(dev)
    prog = ProgressiveRenderer(scene, camera, cfg, engine="mega", device=dev)
    server = PreviewServer(0, probe=lambda x, y: debug_pixel(scene, camera, x, y, cfg,
                                                              device=dev)).start()
    served, probes = [], []
    try:
        base = f"http://localhost:{server.port}"

        def on_sweep(image, metrics):
            server.update(image, metrics)
            served.append(decode_png(get(base + "/frame.png")))
            probes.append(json.loads(get(base + "/probe?x=%d&y=%d" % xy)))

        mk.LAUNCHES = 0
        with contextlib.redirect_stdout(io.StringIO()):
            image = prog.run(max_passes=2, on_sweep=on_sweep)
        k1 = mk.LAUNCHES
        status = json.loads(get(base + "/status"))
    finally:
        server.stop()
    png = os.path.join("build", "serve_mega.png")
    write_png(png, image)
    with open(png, "rb") as f:
        written = decode_png(f.read())
    ok = (len(served) == 2 and np.array_equal(served[-1], written) and status["total_spp"] == 3
          and all(same_probe(p, cpu_probe) for p in probes))
    print(f"[front] 'mega' progressive, 2 passes through PreviewServer on :{server.port}: K1 "
          f"launches {k1}; /frame.png of the last sweep equal to the PNG the run wrote, /status "
          f"total_spp {status['total_spp']}, /probe equal to the CPU probe: {ok}")
    check(ok and k1 == 2, "the viewer's frames or probe are wrong")

    png2 = os.path.join("build", "cli_serve.png")
    out, err = io.StringIO(), io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(["--scene", "cover", "--size", f"{w}x{h}", "--max-depth", "50",
                       "--progressive", "--engine", "mega", "--passes", "2", "--serve", "0",
                       "--term-preview", "--out", png2])
    with open(png2, "rb") as f:
        cli_png = decode_png(f.read())
    text = out.getvalue()
    frames = text.count("\x1b[38;2;") >= 2 * 100 or text.count("\x1b_Ga=T") == 2  # ANSI or kitty
    ok = (rc == 0 and "preview at http://localhost:" in err.getvalue() and frames
          and "F\x1b[J" in text and "total_spp=3" in text
          and np.array_equal(cli_png, written))
    print(f"[front] cli --progressive --engine mega --passes 2 --serve 0 --term-preview: rc {rc}, "
          f"{time.perf_counter() - t0:.2f} s, {len(text)} characters of terminal frames, PNG "
          f"equal to the viewer run's: {ok}")
    check(ok, "the CLI's --serve/--term-preview run failed")
    return k1


@contextlib.contextmanager
def recorded_launches(calls: list):
    """Within the block, every launch of K2's and K3's wrappers
    (``nearest_ops._launch``, ``prim_ops._launch``) appends (name, copies of
    its inputs, copies of its outputs) to ``calls``.  The launches run and
    count as before; the copies keep what a caller later overwrites."""
    import torch

    from rt_tpu_torch import nearest_ops, prim_ops

    copy = lambda xs: [x.clone() if torch.is_tensor(x) else x for x in xs]
    saved = {m: m._launch for m in (nearest_ops, prim_ops)}

    def recording(launch):
        def record(name, *args):
            out = launch(name, *args)
            calls.append((name, copy(args), copy(out)))
            return out
        return record

    for m, launch in saved.items():
        m._launch = recording(launch)
    try:
        yield calls
    finally:
        for m, launch in saved.items():
            m._launch = launch


def hold_recorded(calls: list) -> dict:
    """Each recorded K2 or K3 launch against its plain version on the same
    inputs, bit for bit (t, ids and, for K3, the shade columns).  Returns
    {name: number of launches held}; fails on any difference."""
    import torch

    from rt_tpu_torch import nearest_ops, prim_ops

    def plain(name, args):
        if name == "sphere_nearest":
            org, dirn, sph, t_min, t_max = args
            return nearest_ops.sphere_nearest_plain(org, dirn, sph[:, :3], sph[:, 3], t_min, t_max)
        check(name == "prim_nearest_shaded", f"{name}: not a launch of these paths")
        return prim_ops.prim_nearest_shaded_plain(*args)

    held, bad = {}, []
    for name, args, out in calls:
        if not all(torch.equal(a, b) for a, b in zip(out, plain(name, args), strict=True)):
            bad.append((name, tuple(args[0].shape)))
        held[name] = held.get(name, 0) + 1
    check(not bad and bool(held), f"K2/K3 launches differ from their plain versions: {bad}")
    return held


def dryrun_kernels_phase(dev, results: list) -> dict:
    """The kernels of ``dryrun_multichip(n)``'s ranks held against their
    plain versions at the dryrun's shapes: every shard of its mesh run here
    on the card as the ranks run them (``render_shard``, ``wavefront_shard``
    and ``train_shard`` with its backward pass: K2 and K3, each launch
    recorded and held against plain on its inputs by ``hold_recorded``;
    ``megakernel_shard``: K5, each range against ``render_megakernel_plain``).
    The shards assembled equal rank 0's three frames, and the training
    shards' loss its loss, bit for bit, and each kernel's launches here
    number the ranks' together, so these are the ranks' launches.  The
    launch counts are restored afterwards.  Returns {kernel: launches
    held}."""
    import numpy as np
    import torch

    from rt_tpu_torch import grad as grad_mod
    from rt_tpu_torch import megakernel as mk, nearest_ops, prim_ops, rng
    from rt_tpu_torch.graft_entry import DRYRUN_SPP, dryrun_setup
    from rt_tpu_torch.parallel import (
        assemble_render, megakernel_range, megakernel_shard, render_shard, tile_squared_error,
        train_shard, wavefront_shard,
    )

    n, rank0 = len(results), results[0]
    ranks = {k: sum(r["launches"][k] for r in results) for k in rank0["launches"]}
    counts = dict(nearest_ops.LAUNCHES), dict(prim_ops.LAUNCHES), mk.LAUNCHES_CLUSTERED
    shape, (scene, camera, cfg), (scene_cl, cam_cl, cfg_cl) = dryrun_setup(n)
    scene.to(dev)
    scene_cl.to(dev)
    (t, s), spp, key = shape, DRYRUN_SPP, rng.key(cfg.seed)
    w, h = camera.image_width, camera.image_height
    frames = rank0["frames"]
    calls = []
    with recorded_launches(calls):
        total = lambda xs: sum(xs[1:], xs[0])  # the collectives' order for two ranks
        sums = [total([render_shard(scene, camera, cfg, shape, (i, j), spp, key)
                       for j in range(s)]) for i in range(t)]
        img = assemble_render(sums, camera, spp, shape).cpu().numpy()
        wf = torch.cat([wavefront_shard(scene, camera, cfg, n, r, spp, key) for r in range(n)])
        wf = wf[: w * h].reshape(h, w, 3).cpu().numpy()
        params = grad_mod.SceneParams(*(p.detach().requires_grad_()
                                        for p in grad_mod.get_params(scene)))
        pix = torch.arange(w * h, dtype=torch.int32, device=dev)
        target = torch.as_tensor(frames["render_sharded"].reshape(w * h, 3), device=dev)
        rows = (w * h) // t
        sq = total([tile_squared_error(
            total([train_shard(params, scene, camera, cfg, shape, (i, j), pix, spp, key)
                   for j in range(s)]), target[i * rows : (i + 1) * rows], spp, s)
                    for i in range(t)])
        loss = float(sq.detach() / (w * h * 3))
        torch.autograd.grad(sq, params, allow_unused=True)  # its launches too
    held = hold_recorded(calls)
    key_cl, n_cl = rng.key(cfg_cl.seed), cam_cl.image_width * cam_cl.image_height
    k5_same, parts = True, []
    for r in range(n):
        base, count = megakernel_range(n_cl, n, r)
        got = megakernel_shard(scene_cl, cam_cl, cfg_cl, n, r, 1, key_cl)
        ref = mk.render_megakernel_plain(scene_cl, cam_cl, cfg_cl, 1, 0, rng.key_seed(key_cl),
                                         pixel_base=base, n_pixels=count)
        k5_same = k5_same and torch.equal(got, ref)
        parts.append(got)
    cl = torch.cat(parts).reshape(cam_cl.image_height, cam_cl.image_width, 3).cpu().numpy()
    held["megakernel_clustered"] = n if k5_same else 0
    nearest_ops.LAUNCHES.update(counts[0])
    prim_ops.LAUNCHES.update(counts[1])
    mk.LAUNCHES_CLUSTERED = counts[2]
    same = {"render_sharded": np.array_equal(img, frames["render_sharded"]),
            "render_sharded_wavefront": np.array_equal(wf, frames["render_sharded_wavefront"]),
            "render_sharded_megakernel": np.array_equal(cl, frames["render_sharded_megakernel"]),
            "loss": loss == rank0["loss"]}
    print(f"[shard] the dryrun's {t}x{s} mesh, its shards run here on the card: equal to rank "
          f"0's frames and loss {same}; launches held bit for bit against plain on their "
          f"inputs {held}, the ranks' launches together {ranks}")
    check(all(same.values()) and k5_same and held == ranks and ranks["sphere_nearest"] > 0
          and ranks["prim_nearest_shaded"] > 0,
          "the dryrun's kernels differ from their plain versions, or its shards from its ranks")
    return held


def inverse_phase(dev, card: str, steps: int = 10):
    """examples/inverse_rendering_torch.py, ``steps`` Adam steps on the card
    (K2 launches counted from 0 just before, each held against plain on its
    inputs): the loss falls, and step 0's loss equals a CPU run's at rtol
    1e-5 (tests/test_torch_grad.py).
    Returns (K2 launches, mean wall s of the warm steps)."""
    import importlib.util

    from rt_tpu_torch import nearest_ops

    spec = importlib.util.spec_from_file_location(
        "inverse_rendering_torch", os.path.join("examples", "inverse_rendering_torch.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    for fn in nearest_ops.LAUNCHES:
        nearest_ops.LAUNCHES[fn] = 0
    calls = []
    with recorded_launches(calls):
        res = example.run(steps, device=dev, log=lambda line: print(f"[inverse] {line}"))
    k2 = nearest_ops.LAUNCHES["sphere_nearest"]
    held = hold_recorded(calls)
    print(f"[inverse] the run's launches held bit for bit against plain on their inputs: {held}")
    check(held == {"sphere_nearest": k2}, "the example's K2 launches were not all held")
    cpu = example.run(1, device="cpu", log=lambda line: None)
    losses = res["losses"]
    step_s = sum(res["step_s"][1:]) / (steps - 1)
    rel = abs(losses[0] - cpu["losses"][0]) / cpu["losses"][0]
    print(f"[inverse] {steps} steps on {card}: loss {losses[0]:.6f} -> {losses[-1]:.6f}; step 0 "
          f"against the CPU's {cpu['losses'][0]:.6f}: rel {rel:.2e}; first step "
          f"{res['step_s'][0]:.3f} s, warm steps {step_s:.4f} s each (wall); K2 launches {k2}")
    check(losses[-1] < losses[0] and rel <= 1e-5 and k2 > 0,
          "the inverse-rendering example did not fit, or its card and CPU losses disagree")
    return k2, step_s


def sharding_phase(dev, card: str, cover40k) -> dict:
    """parallel.render_sharded_megakernel on one NCCL rank, bit-equal to
    render_image's frames: the bench cover (K1) and the 40k sphere cover
    (K5), launches counted from 0 just before each; then
    graft_entry.dryrun_multichip(2): two gloo ranks on the one card, each
    running K2, K3 and K5, every sharded frame equal to its serial shards;
    then ``dryrun_kernels_phase``, the ranks' kernels against their plain
    versions.  Returns the launches and the dryrun's results."""
    import numpy as np
    import torch.distributed as dist

    from rt_tpu_torch import megakernel as mk, parallel
    from rt_tpu_torch.graft_entry import dryrun_multichip
    from rt_tpu_torch.render import render_image
    from rt_tpu_torch.scenes import bench_cover_config

    parallel.initialize_multihost(f"localhost:{parallel.free_port()}", 1, 0, backend="nccl")
    try:
        mesh = parallel.make_mesh()
        scene, camera, cfg = bench_cover_config()
        ref, _ = render_image(scene, camera, cfg, device=dev)
        mk.LAUNCHES = 0
        got = parallel.render_sharded_megakernel(scene, camera, cfg, mesh, device=dev)
        k1 = mk.LAUNCHES
        same_k1 = np.array_equal(got.cpu().numpy(), ref)
        scene40k, cam40k, cfg40k, img40k = cover40k
        mk.LAUNCHES_CLUSTERED = 0
        got = parallel.render_sharded_megakernel(scene40k, cam40k, cfg40k, mesh, device=dev)
        k5 = mk.LAUNCHES_CLUSTERED
        same_k5 = np.array_equal(got.cpu().numpy(), img40k)
        print(f"[shard] render_sharded_megakernel on a mesh {tuple(mesh.shape)} of one NCCL "
              f"({dist.get_backend()}) rank: the bench cover equal to render_image's frame "
              f"{same_k1} (K1 launches {k1}); the 40k sphere cover equal {same_k5} (K5 launches "
              f"{k5})")
        check(same_k1 and same_k5 and k1 == 1 and k5 == 1,
              "the sharded megakernel differs from render_image")
    finally:
        dist.destroy_process_group()
    t0 = time.perf_counter()
    results = dryrun_multichip(2)
    seconds = time.perf_counter() - t0
    for r in results:
        print(f"[shard] dryrun rank {r['rank']} on {r['device']}: mesh {r['mesh']}, loss "
              f"{r['loss']:.6f}, K5 launches of its sharded megakernel {r['k5_sharded']}, kernel "
              f"launches of its run {r['launches']}, frames equal to the serial shards "
              f"{r['serial_equal']}")
    print(f"[shard] dryrun_multichip(2) on {card}: {seconds:.1f} s (two spawned ranks)")
    check(all(r["k5_sharded"] == 1 and r["device"].startswith("cuda")
              and r["launches"]["sphere_nearest"] > 0 and r["launches"]["prim_nearest_shaded"] > 0
              for r in results) and all(results[0]["serial_equal"].values()),
          "dryrun_multichip(2): a rank did not run its kernels, or the frame depends on the mesh")
    held = dryrun_kernels_phase(dev, results)
    return {"k1": k1, "k5": k5, "dryrun": results, "dryrun_s": seconds, "dryrun_held": held}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    from rt_tpu_torch import _build, megakernel as mk
    from rt_tpu_torch.config import RenderConfig
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

    # -- 2. build K1-K5 from the repository's sources ---------------------------------
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
        same = bool(torch.equal(got, ref))
        print(f"[parity] {name:17s} 32x24 2spp: equal to plain {same}, max|d| {err:.3e}")
        check(same, f"{name}: kernel and plain version disagree")
    k1_ring_phase(dev)

    scene, camera, cfg = bench_cover_config()
    scene.to(dev)
    spp = cfg.samples_per_pixel
    k1_work = {"segments": 0, "admitted": 0}
    plain = mk.render_megakernel_plain(scene, camera, cfg, spp, 0, cfg.seed,
                                       search=counting_search(k1_work))
    print(f"[K1] the plain run searched {k1_work['segments']} ray segments, "
          f"{k1_work['admitted']} of their sphere pairs admitted")
    got, kernel_ms = timed_cuda(lambda: mk.render_megakernel(scene, camera, cfg, spp, 0, cfg.seed), 5)
    bench_err, _, _ = compare(got, plain)
    same = bool(torch.equal(got, plain))
    print(f"[parity] bench cover 400x225 {spp}spp depth {cfg.max_depth}: equal to plain {same}, "
          f"max|d| {bench_err:.3e}")
    check(same, "bench frame: kernel and plain version disagree")
    print(f"[time] bench frame {spp} spp on {card}: kernel {kernel_ms:.3f} ms "
          f"(CUDA events, mean of 5 after a warm-up)")
    k1_frame = got.reshape(225, 400, 3).cpu().numpy()
    k1_640, k1_640_ms = timed_cuda(
        lambda: mk.render_megakernel(scene, camera, cfg, 640, 0, cfg.seed), 2)
    ring = mk.K1_RING
    print(f"[time] K1 bench frame 640 spp (one render_megakernel call: {ring['launches']} launch, "
          f"{ring['slots']} slots x {ring['generations']} generations, {int(ring['waits'])} "
          f"waited steps) on {card}: kernel {k1_640_ms:.3f} ms, "
          f"{640 * 400 * 225 / k1_640_ms / 1e3:.2f} Mray/s (CUDA events, mean of 2 after a "
          f"warm-up)")
    k1_wide_ms, k1_wide_bound = k1_wide_phase(dev, card)

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
    check(np.array_equal(img640, k1_640.reshape(225, 400, 3).cpu().numpy()),
          "render_image at 640 spp differs from phase 3's timed launch")
    print("[main] the 640-spp image equals phase 3's timed 640-spp launch bit for bit")
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
    (k2_err, k2_ms, k2_plain_ms), (k2b_err, k2b_ms, k2b_plain_ms), k2_admitted = nearest_phase(
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

    # -- 11. K3/K3b kernel vs plain on the card ------------------------------------
    scene, camera, cfg = bench_cover_config()
    scene.to(dev)
    k3, k3b = prim_phase(dev, scene, camera, cfg, timed_cuda)
    print(f"[time] K3 prim_nearest_shaded 65536 rays x {scene.num_spheres} spheres + "
          f"{scene.num_triangles} triangles on {card}: kernel {k3[1]:.4f} ms, plain {k3[2]:.4f} ms, "
          f"bound {k3[3]:.4f} ms (CUDA events, mean of 5 after a warm-up)")
    print(f"[time] K3b prim_nearest_packed, the same rays on {card}: kernel {k3b[1]:.4f} ms, "
          f"plain {k3b[2]:.4f} ms, bound {k3b[3]:.4f} ms")

    # -- 12. the persistent wavefront (K3) --------------------------------------------
    wf_launches, _, wf_s = wavefront_phase(dev, k1_frame)

    # -- 13. the wavefront's generic path (K2) ----------------------------------------
    generic_phase(dev)

    # -- 14. where the wavefront's time goes (torch.profiler) ---------------------------
    profile_phase(dev, card)

    # -- 15. progressive rendering, and its CLI ----------------------------------------
    progressive_phase(dev, card)
    cli_progressive_phase()

    # -- 16. mesh scenes: the BVH builder, the config-3 fixtures and scenes ------------
    fixtures = mesh_setup()
    blob = mesh_scene(fixtures["obj"], dev)
    heightfield = mesh_scene(fixtures["heightfield"], dev)
    mesh_cfg = RenderConfig(width=MESH_W, height=MESH_H, samples_per_pixel=MESH_SPP,
                            max_depth=MESH_DEPTH)
    mesh_camera = mesh_cam(MESH_W, MESH_H)

    # -- 17. K4/K4b kernel vs plain on the card ------------------------------------------
    k4, k4b = cluster_phase(dev, blob, mesh_camera, mesh_cfg, timed_cuda)
    print(f"[time] K4 cluster_worklist_nearest, 65536 rays x the blob's whole tables (one "
          f"wavefront intersect) on {card}: kernel {k4[1]:.4f} ms, plain {k4[2]:.2f} ms, "
          f"bound {k4[3]:.4f} ms (CUDA events, mean of 5 after a warm-up; plain: one run after one)")
    print(f"[time] K4b cluster_nearest, the same rays x the whole tables on {card}: kernel "
          f"{k4b[1]:.4f} ms, plain {k4b[2]:.2f} ms, bound {k4b[3]:.4f} ms")

    # -- 18. the slice at full width: render_image of config 3 and 3b (K5) ---------------
    k5_launches, k5_frame_ms, k5_frames = mesh_frames_phase(
        dev, card, {"blob": blob, "heightfield": heightfield}, timed_cuda)

    # -- 19. K5 kernel vs plain on the card -----------------------------------------------
    k5_small_phase(dev)
    k5 = k5_phase(dev, "config-3 blob", blob, mesh_camera, mesh_cfg, k5_frames["blob"],
                  k5_frame_ms["blob"])
    k5_hf = k5_phase(dev, "config-3 heightfield", heightfield, mesh_camera, mesh_cfg,
                     k5_frames["heightfield"], k5_frame_ms["heightfield"])
    for name, r in (("blob", k5), ("heightfield", k5_hf)):
        print(f"[time] K5 megakernel_clustered, the config-3 {name} frame ({MESH_W}x{MESH_H}, "
              f"{MESH_SPP} spp) on {card}: kernel {r[1]:.4f} ms per launch, plain {r[2]:.1f} ms "
              f"(wall) on 144 of its pixels, bound {r[3]:.4f} ms for the frame by {r[4]}")

    # -- 20. the wavefront on K4 -------------------------------------------------------------
    k4_launches, mesh_wf_counts, mesh_wf_s = mesh_wavefront_phase(dev, blob)

    # -- 21. progressive ("mega" engine) and the CLI on the mesh ----------------------------
    mesh_progressive_cli_phase(dev, blob, fixtures["obj"])

    # -- 22. K6 kernels vs plain, then the probe at its defaults ---------------------------
    k6_scatter_err = micro_parity_phase(dev)
    k6, k6_launches, k6_plain_ms, k6_long = micro_probe_phase(dev)
    k6_bound = micro_bounds(dev)
    k6_reduce_library_ms = micro_reduce_library(dev)
    # A rep's time: the slope between 8 and 1,024 reps (between 8 and 32,
    # the CLI's, a rep of ~2 us is within the timer's noise).
    per_rep = lambda r: (r["t_r2_ms"] - r["t_r1_ms"]) / (r["r2"] - r["r1"])
    k6_ms = {"reduce": per_rep(k6_long["reduce"]), "gather": per_rep(k6_long["gather[full]"]),
             "scatter": per_rep(k6_long["scatter"])}
    for name, r in k6.items():
        print(f"[time] K6 {name} on {card}: {r['ns_per_unit']:.4f} ns/unit over n={r['n']} "
              f"(r{r['r1']} {r['t_r1_ms']:.4f} ms, r{r['r2']} {r['t_r2_ms']:.4f} ms; CUDA events, "
              f"best of 3)")
    for name in ("reduce", "gather", "scatter"):
        print(f"[time] K6 {name}: {k6_ms[name]:.5f} ms per rep (8 to 1,024 reps), plain "
              f"{k6_plain_ms[name]:.4f} ms (1 rep), bound {k6_bound[name][0]:.5f} ms by "
              f"{k6_bound[name][1]}")

    # -- 23. the BVH walk kernel vs the plain walk on the blob's rays ----------------------
    walk_ms, walk_plain_ms, walk_hits = bvh_walk_phase(dev, blob, mesh_camera, mesh_cfg, timed_cuda)
    print(f"[time] BVH walk (not a TPU kernel), 65536 rays of the blob frame on {card}: kernel "
          f"{walk_ms:.4f} ms (CUDA events, mean of 5 after a warm-up), plain walk "
          f"{walk_plain_ms:.1f} ms")

    # -- 24. pixel_grad on the config-3 blob (the walk kernel) -----------------------------
    mesh_step_s = mesh_grad_phase(dev, blob, card)

    # -- 25. the chunked config-3 blob frame, and a defocused chunked frame ----------------
    mesh_chunk_s = mesh_chunked_phase(dev, blob, card, float(k5_frames["blob"].mean()))
    defocus_phase(dev, card)

    # -- 26. the live Hosek-Wilkie sky, and the cover frame under it (K1) -----------------
    sky_launches, sky_k1_ms, sky_plain_ms = live_sky_phase(dev, card, timed_cuda)

    # -- 27. BASELINE config 4: the armor-class glb under the live sky (K5) --------------
    c4_launches, k5_c4 = gltf_frames_phase(dev, card, fixtures, timed_cuda)

    # -- 28. BASELINE config 5: the car-class glb, progressive at 1080p and resumed (K5) --
    c5_launches, k5_c5, c5_s, c5_sum = progressive_gltf_phase(dev, card, fixtures, timed_cuda)
    for name, r in (("config-4 armor (800x450, 8 spp)", k5_c4),
                    ("config-5 car (1920x1080, one 4-spp sweep)", k5_c5)):
        print(f"[time] K5 megakernel_clustered, the {name} frame on {card}: kernel {r[1]:.4f} ms "
              f"per launch, plain {r[2]:.1f} ms (wall) on the sampled pixels, bound {r[3]:.4f} ms "
              f"for the frame by {r[4]}")

    # -- 29. the port's bench scripts (bench_cuda.py, bench_grad_cuda.py) ----------------
    bench_lines_phase(dev)

    # -- 30. sphere clusters: the 40k and 360k covers through K5 and K4 ------------------
    t_new = time.perf_counter()
    spheres = sphere_cluster_phase(dev, card, timed_cuda)
    for key in ("40k", "360k"):
        r = spheres[key]
        print(f"[time] K5 megakernel_clustered, the {key}-sphere cover ({SPHERE_W}x{SPHERE_H}, "
              f"{SPHERE_SPP} spp, depth {SPHERE_DEPTH}) on {card}: kernel {r['k5'][1]:.4f} ms per "
              f"launch, plain {r['k5'][2]:.1f} ms (wall) on 80 of its pixels, bound "
              f"{r['k5'][3]:.4f} ms by {r['k5'][4]}; K4 {r['k4'][1]:.4f} ms, plain "
              f"{r['k4'][2]:.1f} ms, bound {r['k4'][3]:.4f} ms by {r['k4'][4]} (65,536 rays)")

    # -- 31. the front ends: --probe, the viewer, --serve and --term-preview ---------------
    front_k1 = front_end_phase(dev, card)

    # -- 32. the inverse-rendering example (K2) -------------------------------------------
    inverse_k2, inverse_step_s = inverse_phase(dev, card)

    # -- 33. sharding: one NCCL rank, then two gloo ranks on the card ---------------------
    shard = sharding_phase(dev, card, spheres.pop("cover40k"))
    print(f"[time] phases 30-33 (sphere clusters, front ends, inverse rendering, sharding): "
          f"{time.perf_counter() - t_new:.1f} s")

    # -- 34. result -------------------------------------------------------------------
    check(all(math.isfinite(v) for v in (sky_k1_ms, sky_plain_ms, *k5_c4[:4], *k5_c5[:4], c5_s,
                                          *c5_sum[1:5])),
          "non-finite measurement")
    check(all(math.isfinite(v) for r in spheres.values() for v in (*r["k5"][:4], *r["k4"][:4]))
          and math.isfinite(inverse_step_s), "non-finite measurement")
    check(all(math.isfinite(v) for v in (bench_err, kernel_ms, k1_640_ms, k1_wide_ms,
                                          k1_wide_bound[0], plain_ms,
                                          k2_ms, k2_plain_ms,
                                          k2b_ms, k2b_plain_ms, *k3[:4], *k3b[:4], wf_s,
                                          *k4[:4], *k4b[:4], *k5[:4], *k5_hf[:4], mesh_wf_s,
                                          *k5_frame_ms.values(), *k6_ms.values(),
                                          *k6_plain_ms.values(), k6_scatter_err,
                                          k6_reduce_library_ms, walk_ms,
                                          walk_plain_ms, mesh_step_s, mesh_chunk_s)),
          "non-finite measurement")
    # Least times: K1 does at least the pair tests of the ray segments its
    # plain run searched for the same frame (the same paths), and the roots
    # of their admitted sphere pairs; K2/K2b the pair tests of phase 7's rays
    # (90,000, and 90,112 packed) with the bench scene's spheres, reading the
    # rays once and writing t and idx once.
    ns, nt = bench_scene.num_spheres, bench_scene.num_triangles
    seg = k1_work["segments"]
    k1_bound = bound(brute_flops(seg, ns, nt, k1_work["admitted"]), 90_000 * 12)
    k2_bound = bound(brute_flops(90_000, ns, 0, k2_admitted), 90_000 * (24 + 8) + ns * 16)
    k2b_bound = bound(brute_flops(90_112, ns, 0, k2_admitted), 90_112 * (24 + 8) + 512 * 16)
    print(f"[kernels] least time on this card ({PEAK_FP32 / 1e12:.0f} TFLOP/s FP32, "
          f"{PEAK_BYTES / 1e12:.2f} TB/s; {FLOPS_SPHERE_TEST} FLOP a sphere pair, "
          f"{FLOPS_SPHERE_ROOT} more for each admitted one): K1 {k1_bound[0]:.4f} ms ({seg} ray "
          f"segments, {k1_work['admitted']} admitted sphere pairs), {64 * k1_bound[0]:.4f} ms at "
          f"640 spp (64 x the 10-spp frame's; kernel {k1_640_ms:.3f} ms), {k1_wide_bound[0]:.4f} "
          f"ms at 1600x900 (kernel {k1_wide_ms:.3f} ms), "
          f"K2 {k2_bound[0]:.4f} ms, K2b {k2b_bound[0]:.4f} ms ({k2_admitted} admitted), "
          f"K3 {k3[3]:.4f} ms, K3b {k3b[3]:.4f} ms")
    print(f"[kernels] K4 {k4[3]:.4f} ms and K4b {k4b[3]:.4f} ms from the walk's counted slab and "
          f"pair tests on phase 17's rays, K5 {k5[3]:.4f} ms (blob) and {k5_hf[3]:.4f} ms "
          f"(height field) from those on phase 19's 144 pixels of each frame scaled to the "
          f"frame, {k5_c4[3]:.4f} ms (config 4) and {k5_c5[3]:.4f} ms (config 5's sweep) from "
          f"phases 27 and 28's sampled pixels ({FLOPS_SLAB} FLOP a slab test); bytes: the "
          f"clusters entered and the winners' shade rows, read once")
    print("[kernels] sphere_nearest_packed (K2b), prim_nearest_packed (K3b) and cluster_nearest "
          "(K4b) have no caller on any path, as in rt_tpu; each is held against its plain "
          "version above")

    def sphere_keys(spheres: dict, kernel: str) -> dict:
        """K5's or K4's numbers on the sphere covers, as extra keys."""
        return {f"{key}_spheres{cover}": value
                for cover, r in spheres.items()
                for key, value in zip(("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "bound_by"), (r[f"{kernel}_launches"], *r[kernel]))}

    def entry(name, source, replaces, n_launches, err, ms, p_ms, bnd, library_ms=None):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": n_launches, "max_abs_err": err, "ms": ms, "plain_ms": p_ms,
                "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": library_ms}

    print(f"[time] chip_smoke.py total: {time.perf_counter() - t_start:.1f} s")
    print(card_line())
    print(json.dumps({"kernels": [
        dict(entry("megakernel_flat", "rt_tpu_torch/csrc/megakernel.cu",
                   "rt_tpu/megakernel.py:288", launches, bench_err, kernel_ms, plain_ms, k1_bound),
             ms_1600x900=k1_wide_ms, bound_ms_1600x900=k1_wide_bound[0],
             bound_by_1600x900=k1_wide_bound[1], launches_live_sky=sky_launches,
             ms_live_sky=sky_k1_ms, plain_ms_live_sky=sky_plain_ms,
             launches_viewer_mega=front_k1, launches_sharded=shard["k1"]),
        dict(entry("sphere_nearest", "rt_tpu_torch/csrc/nearest.cu", "rt_tpu/pallas_ops.py:123",
                   grad_launches["sphere_nearest"], k2_err, k2_ms, k2_plain_ms, k2_bound),
             launches_inverse=inverse_k2,
             launches_dryrun_ranks=[r["launches"]["sphere_nearest"] for r in shard["dryrun"]],
             # Every launch of these two paths was held bit for bit against
             # plain on its inputs (inverse_phase, dryrun_kernels_phase).
             max_abs_err_inverse=0.0, max_abs_err_dryrun=0.0),
        entry("sphere_nearest_packed", "rt_tpu_torch/csrc/nearest.cu", "rt_tpu/pallas_ops.py:313",
              grad_launches["sphere_nearest_packed"], k2b_err, k2b_ms, k2b_plain_ms, k2b_bound),
        dict(entry("prim_nearest_shaded", "rt_tpu_torch/csrc/prim_nearest.cu",
                   "rt_tpu/pallas_ops.py:936", wf_launches["prim_nearest_shaded"], k3[0], k3[1],
                   k3[2], k3[3:5]),
             launches_dryrun_ranks=[r["launches"]["prim_nearest_shaded"]
                                    for r in shard["dryrun"]],
             max_abs_err_dryrun=0.0),
        entry("prim_nearest_packed", "rt_tpu_torch/csrc/prim_nearest.cu",
              "rt_tpu/pallas_ops.py:270", wf_launches["prim_nearest_packed"], k3b[0], k3b[1],
              k3b[2], k3b[3:5]),
        dict(entry("cluster_nearest", "rt_tpu_torch/csrc/cluster_nearest.cu",
                   "rt_tpu/pallas_ops.py:1015", k4_launches["cluster_worklist_nearest"], k4[0],
                   k4[1], k4[2], k4[3:5]),
             **sphere_keys(spheres, "k4")),
        entry("cluster_nearest_predicated", "rt_tpu_torch/csrc/cluster_nearest.cu",
              "rt_tpu/pallas_ops.py:533", k4_launches["cluster_nearest"], k4b[0], k4b[1], k4b[2],
              k4b[3:5]),
        dict(entry("megakernel_clustered", "rt_tpu_torch/csrc/megakernel.cu",
                   "rt_tpu/megakernel.py:3768", k5_launches, k5[0], k5[1], k5[2], k5[3:5]),
             **{f"{key}_{cfg_name}": value
                for cfg_name, n, r in (("config4", c4_launches, k5_c4), ("config5", c5_launches, k5_c5))
                for key, value in zip(("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                       "bound_by"), (n, *r))},
             **sphere_keys(spheres, "k5"),
             launches_sharded_spheres40k=shard["k5"],
             launches_dryrun_ranks=[r["k5_sharded"] for r in shard["dryrun"]],
             max_abs_err_dryrun=0.0),
        entry("micro_reduce", "rt_tpu_torch/csrc/micro_probe.cu", "tools/micro_probe.py:41",
              k6_launches["micro_reduce"], 0.0, k6_ms["reduce"], k6_plain_ms["reduce"],
              k6_bound["reduce"], k6_reduce_library_ms),
        entry("micro_gather", "rt_tpu_torch/csrc/micro_probe.cu", "tools/micro_probe.py:66",
              k6_launches["micro_gather"], 0.0, k6_ms["gather"], k6_plain_ms["gather"],
              k6_bound["gather"]),
        entry("micro_scatter", "rt_tpu_torch/csrc/micro_probe.cu", "tools/micro_probe.py:131",
              k6_launches["micro_scatter"], k6_scatter_err, k6_ms["scatter"],
              k6_plain_ms["scatter"], k6_bound["scatter"]),
        # Replaces the host's numpy sum of a sweep, not a TPU kernel.
        entry("sweep_sum", "rt_tpu_torch/csrc/sweep_sum.cu", "rt_tpu/progressive.py:137",
              *c5_sum[:4], c5_sum[4:6]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
