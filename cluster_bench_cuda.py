#!/usr/bin/env python
"""Clustered-megakernel deep-frame benchmark of the PyTorch/CUDA port, the
port's counterpart of tools/cluster_bench.py (one card).

Times 800x450 frames at 64 spp and depth 50 on the standard API and prints
tools/cluster_bench.py's line for each scene:

- the sphere covers ``cover_scene(100|300|500, ...)`` (40k, 360k and 1M
  spheres; ``SceneBuilder.build`` gives them cluster tables, so they run
  K5) through one ``render_pixel_colors`` call at full spp;
- the 100k-triangle height field and the 100k-triangle blob with its area
  light through ``render_image`` (K5 too).

A frame's time is the best of 2 warm calls, ended when the frame is on the
host; Mray/s counts camera samples (window.rs:315-324).  On the card a
line gives K5's own time for the frame's launch (CUDA events).  Each scene also
gets a line with its host set-up: the seconds of the whole scene function,
of ``SceneBuilder.build`` within it, and the bytes of the scene's tables
on the device.  The fixtures are rt_tpu_torch.fixtures', written once to
build/fixtures (or --fixtures).  ``--bin`` is accepted and ignored, as the
other TPU knobs are (the JAX script's lane binning).

    python cluster_bench_cuda.py [40k|360k|1m|heightfield|mesh|all] [--spp N]
"""

import argparse
import os
import sys
import time

from bench_cuda import device_name, sync

REPO = os.path.dirname(os.path.abspath(__file__))
SPHERE_COVERS = {"40k": ("40k spheres", 100), "360k": ("360k spheres", 300),
                 "1m": ("1M spheres", 500)}


def timed_scene(make):
    """(scene, seconds of ``make()``, seconds of SceneBuilder.build in
    it)."""
    from rt_tpu_torch.scene import SceneBuilder

    builds = []
    build = SceneBuilder.build

    def timed_build(self, *args, **kw):
        t0 = time.perf_counter()
        try:
            return build(self, *args, **kw)
        finally:
            builds.append(time.perf_counter() - t0)

    SceneBuilder.build = timed_build
    try:
        t0 = time.perf_counter()
        scene = make()
        return scene, time.perf_counter() - t0, sum(builds)
    finally:
        SceneBuilder.build = build


def table_bytes(scene) -> int:
    """Bytes of every table of the scene (cluster tables and BVH included)."""
    return sum(b.numel() * b.element_size() for b in scene.buffers())


def scene_line(name, scene, total_s, build_s, device) -> str:
    scene.to(device)
    cl = scene.clusters
    tables = "no cluster tables" if cl is None else (
        f"{cl.sph_cluster.shape[0] + cl.tri_cluster.shape[0]} cluster rows, "
        f"{cl.shade_table.shape[1]} slots")
    return (f"{name}: scene {total_s:.2f} s (SceneBuilder.build {build_s:.2f} s), "
            f"{table_bytes(scene) / 1e6:.1f} MB of tables on {device_name(device)} ({tables})")


def bench(name, scene, camera, device, spp=64, depth=50, trials=2, chunked=False) -> float:
    """Print tools/cluster_bench.py's line for ``scene``; returns the best
    wall seconds.  ``chunked`` frames go through render_image at
    ``spp``, the others through one render_pixel_colors call."""
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.render import render_image, render_pixel_colors

    w, h = camera.image_width, camera.image_height
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp if chunked else 1,
                       max_depth=depth)
    if chunked:
        frame = lambda: render_image(scene, camera, cfg, device=device)
    else:
        frame = lambda: render_pixel_colors(scene, camera, cfg, device=device, spp=spp).cpu()
    frame()  # warm: uploads the tables, loads the kernels
    best = float("inf")
    for _ in range(trials):
        sync(device)
        t0 = time.perf_counter()
        frame()
        best = min(best, time.perf_counter() - t0)
    mray = spp * w * h / 1e6 / best
    prims = scene.num_spheres + scene.num_triangles
    print(f"{name}: {mray:.2f} Mray/s ({best:.2f} s, prims={prims})", flush=True)
    if device.type == "cuda":
        import torch

        from rt_tpu_torch import megakernel

        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        megakernel.render_megakernel(scene, camera, cfg, spp, 0, cfg.seed)
        end.record()
        torch.cuda.synchronize(device)
        print(f"{name}: K5 {start.elapsed_time(end):.3f} ms for the frame's {spp}-spp launch "
              f"(CUDA events)", flush=True)
    return best


def main(argv=None) -> int:
    import torch

    from rt_tpu_torch import scenes
    from rt_tpu_torch.fixtures import ensure_fixtures
    from rt_tpu_torch.render import _device

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("which", nargs="?", default="all",
                        choices=[*SPHERE_COVERS, "heightfield", "mesh", "all"])
    parser.add_argument("--spp", type=int, default=64)
    parser.add_argument("--bin", default=None, help="accepted, no effect (a TPU knob)")
    parser.add_argument("--device", default="cuda", help="cuda | cuda:N | cpu")
    parser.add_argument("--size", default="800x450", help="WIDTHxHEIGHT")
    parser.add_argument("--fixtures", default=os.path.join(REPO, "build", "fixtures"))
    args = parser.parse_args(argv)

    device = _device(args.device)
    w, h = (int(v) for v in args.size.split("x"))
    cam = scenes.cam1(w, h)
    print(f"cluster_bench_cuda on {device_name(device)}, torch {torch.__version__}", flush=True)
    todo = list(SPHERE_COVERS) + ["heightfield", "mesh"] if args.which == "all" else [args.which]
    for which in todo:
        if which in SPHERE_COVERS:
            name, grid = SPHERE_COVERS[which]
            scene, total, build = timed_scene(
                lambda: scenes.cover_scene(grid, grid, cam, z=-0.2, seed=0))
            print(scene_line(name, scene, total, build, device), flush=True)
            bench(name, scene, cam, device, spp=args.spp)
        else:
            fx = ensure_fixtures(args.fixtures)
            if which == "heightfield":
                name = "100k-tri heightfield"
                make = lambda: scenes.mesh_scene({"plaster": fx["heightfield"]})
            else:
                name = "100k-tri blob+light"
                make = lambda: scenes.mesh_with_area_light(fx["obj"])
            scene, total, build = timed_scene(make)
            print(scene_line(name, scene, total, build, device), flush=True)
            bench(name, scene, cam, device, spp=args.spp, chunked=True)
        del scene
    return 0


if __name__ == "__main__":
    sys.exit(main())
