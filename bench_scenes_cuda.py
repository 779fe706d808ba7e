#!/usr/bin/env python
"""BASELINE configs 2-5 as named, timed workloads of the PyTorch/CUDA
port, the port's counterpart of bench_scenes.py (one card).

Config 1 (RTIOW cover) is bench_cuda.py.  This script times the other
BASELINE.json configs end to end and prints one JSON line per config, with
bench_scenes.py's metric names:

  2. cover textures + frosted glass, depth 8, 400x225 @ 640 spp (K1);
  3. skull-class OBJ mesh (99,908 triangles) + emissive area light,
     800x450 @ 64 spp (K5); 3b, the height field (100,356 triangles);
  4. armor-class glTF (3 textured parts, 54,720 triangles) + live
     Hosek-Wilkie sky (turbidity 3, albedo 0.3, elevation 0.8), 800x450 @
     64 spp (K5);
  5. night-car-class glTF (5 parts, 162,560 triangles) + low-sun H-W sky,
     1920x1080 @ 256 spp, progressive on the "mega" engine (K5) in 4-spp
     sweeps, checkpointed and resumed by a fresh renderer at mid-run
     (--quick: 8 spp).

A frame's time is ``render_image``'s wall time (the frame ends on the
host), warm, the best of 2; Mray/s is camera samples over it
(window.rs:315-324).  Config 5's time covers the whole progressive run,
the resume and its re-rendered sweeps included.  The fixtures are the
port's procedural stand-ins (rt_tpu_torch.fixtures), written once to
build/fixtures (or --fixtures), where config 5 also keeps its checkpoint.

One departure from bench_scenes.py: it writes config 5's checkpoint every
16 sweeps, so under --quick (2 sweeps) no checkpoint exists at the
midpoint and its resume check fails.  Here the checkpoint interval is at
most half the sweeps.

    python bench_scenes_cuda.py [--quick] [--only N]          # on the card
    python bench_scenes_cuda.py --device cpu --fixtures DIR --size 16x9 --spp 1
"""

import argparse
import json
import os
import sys
import time

from bench_cuda import device_name, sync

REPO = os.path.dirname(os.path.abspath(__file__))


def emit(name, rays, seconds, extra=None):
    rec = {
        "metric": f"mray_per_s_{name}",
        "value": round(rays / 1.0e6 / seconds, 3),
        "unit": "Mray/s",
        "wall_s": round(seconds, 3),
    }
    if extra:
        rec.update(extra)
    print(json.dumps(rec), flush=True)


def time_frame(scene, camera, cfg, spp, device, trials=2):
    """(camera samples, best warm wall s) of render_image at ``spp``."""
    from rt_tpu_torch.render import render_image

    cfg = cfg.replace(samples_per_pixel=spp)
    render_image(scene, camera, cfg, device=device)  # warm-up
    best = float("inf")
    for _ in range(trials):
        _, m = render_image(scene, camera, cfg, device=device)
        best = min(best, m["wall_s"])
    return spp * camera.image_width * camera.image_height, best


def mesh_cam(w, h, dist=5.5, height=2.2):
    """bench_scenes.py's ``_mesh_cam``."""
    from rt_tpu_torch.camera import make_camera

    return make_camera((dist, -dist, height), (0.0, 0.0, 1.0), (0.0, 0.0, 1.0),
                       focus_distance=float((2 * dist * dist + (height - 1) ** 2) ** 0.5),
                       defocus_angle=0.0, image_width=w, image_height=h, vertical_fov=32.0)


def gltf_scene(path, even, odd, sky, timings=None):
    """A glTF file over bench_scenes.py's checkered ground plane, with the
    corrected material mapping (metallic >= 0.5 is metal) and ``sky``.
    ``timings``, when given, gets the host seconds of the load ("load_s")
    and of the build of the tables, cluster tables and BVH ("build_s")."""
    from rt_tpu_torch import scenes
    from rt_tpu_torch.io.gltf_loader import add_gltf_to_scene
    from rt_tpu_torch.scene import SceneBuilder

    t0 = time.perf_counter()
    b = SceneBuilder()
    ground = b.lambertian(b.checker(0.75, b.solid_color(even), b.solid_color(odd)))
    scenes.add_ground_plane(b, 10000.0, 10000.0, -0.2, ground, True)
    add_gltf_to_scene(b, path, compat_all_metal=False)
    t1 = time.perf_counter()
    scene = b.build(sky=sky)
    if timings is not None:
        timings.update(load_s=t1 - t0, build_s=time.perf_counter() - t1)
    return scene


def config4_setup(fixtures, size=(800, 450), timings=None):
    """(scene, camera, cfg) of config 4 at 64 spp (bench_scenes.py:144-170);
    ``timings`` as for gltf_scene."""
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.sky import SkyParams

    scene = gltf_scene(fixtures["glb"], (0.1, 0.1, 0.1), (0.95, 0.95, 0.95),
                       SkyParams.hosek(turbidity=3.0, albedo=0.3, elevation=0.8), timings)
    w, h = size
    return scene, mesh_cam(w, h), RenderConfig(width=w, height=h, samples_per_pixel=64,
                                               max_depth=16)


def config5_setup(fixtures, size=(1920, 1080), timings=None):
    """(scene, camera, cfg) of config 5 (bench_scenes.py:173-259): the
    night car under a sun 4 degrees up, heavy turbidity, dim exposure;
    ``timings`` as for gltf_scene."""
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.sky import SkyParams

    scene = gltf_scene(fixtures["car"], (0.02, 0.02, 0.03), (0.25, 0.25, 0.3),
                       SkyParams.hosek(turbidity=8.0, albedo=0.1, elevation=0.07, exposure=0.35),
                       timings)
    w, h = size
    return scene, mesh_cam(w, h, dist=7.0, height=2.6), RenderConfig(
        width=w, height=h, samples_per_pixel=1, max_depth=12)


def config5_schedule(spp_target):
    """(schedule, checkpoint interval) of config 5: 4-spp sweeps (1-spp if
    the target is not a multiple of 4), a checkpoint every 16 sweeps or
    every half of the sweeps, whichever is fewer, so that one exists at
    the midpoint."""
    from rt_tpu_torch.config import ProgressiveSchedule

    spw = 4 if spp_target % 4 == 0 else 1
    sweeps = spp_target // spw
    schedule = ProgressiveSchedule(ramp=(spw,) * sweeps, sustain_64=0, sustain_128=0,
                                   sustain_256=0)
    return schedule, max(1, min(16, sweeps // 2))


def run_config5(scene, camera, cfg, spp_target, ckpt, device):
    """Config 5's progressive run on the "mega" engine: at the first sweep
    that reaches half of ``spp_target``, a fresh renderer resumes from the
    checkpoint and finishes the run.  Returns (the finishing renderer,
    total spp, wall s)."""
    from rt_tpu_torch.progressive import ProgressiveRenderer

    schedule, every = config5_schedule(spp_target)
    if os.path.exists(ckpt):
        os.remove(ckpt)
    make = lambda: ProgressiveRenderer(scene, camera, cfg, schedule=schedule,
                                       checkpoint_path=ckpt, engine="mega",
                                       checkpoint_every=every, device=device)
    t0 = time.perf_counter()
    pr = make()
    if pr.engine != "mega":
        raise RuntimeError("config 5: the scene is not eligible for the clustered megakernel")
    resumed = False
    while pr.step() is not None:
        done = pr.state.total_spp
        if not resumed and done >= spp_target // 2:
            fresh = make()
            if not 0 < fresh.state.total_spp <= done:
                raise RuntimeError(f"config 5: no checkpoint to resume at {done} spp")
            if fresh.state.pass_index <= pr.state.pass_index - every:
                raise RuntimeError("config 5: the checkpoint is stale")
            pr, resumed = fresh, True
    return pr, pr.state.total_spp, time.perf_counter() - t0


def config2(device, size, spp):
    from rt_tpu_torch import scenes
    from rt_tpu_torch.config import RenderConfig

    w, h = size
    camera = scenes.cam1(w, h)
    scene = scenes.cover_scene(11, 11, camera, z=-0.2, seed=0)
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=10, max_depth=8)
    rays, dt = time_frame(scene, camera, cfg, spp or 640, device)
    emit("config2_cover_textures_d8_400x225_640spp", rays, dt, {"device": device_name(device)})


def config3(fixtures, device, size, spp, depthcheck=False):
    import numpy as np

    from rt_tpu_torch import scenes
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.render import render_image

    w, h = size
    camera = mesh_cam(w, h)
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=64, max_depth=16)
    spp = spp or 64
    scene = scenes.mesh_with_area_light(fixtures["obj"])
    rays, dt = time_frame(scene, camera, cfg, spp, device)
    extra = {"tris": int(scene.num_triangles), "device": device_name(device)}
    if depthcheck:
        # The depth-16 label against the reference's MAX_DEPTH=100
        # (scenes.rs:15): under Russian roulette the depth-16 and depth-50
        # images agree within the seed-to-seed noise at the same spp.
        c16 = cfg.replace(samples_per_pixel=max(spp // 2, 1), max_depth=16)
        a16, _ = render_image(scene, camera, c16, device=device)
        b16, _ = render_image(scene, camera, c16.replace(seed=1), device=device)
        a50, _ = render_image(scene, camera, c16.replace(max_depth=50), device=device)
        noise = float(np.abs(a16 - b16).mean())
        delta = float(np.abs(a16 - a50).mean())
        extra.update({
            "depth16_vs_depth50_mad": round(delta, 6),
            f"seed_noise_mad_{c16.samples_per_pixel}spp": round(noise, 6),
            "depth_delta_over_noise": round(delta / max(noise, 1e-12), 3),
        })
    emit("config3_skull_class_obj_area_light_800x450_64spp", rays, dt, extra)
    hf = scenes.mesh_with_area_light(fixtures["heightfield"])
    rays, dt = time_frame(hf, camera, cfg, spp, device)
    emit("config3b_heightfield_obj_area_light_800x450_64spp", rays, dt,
         {"tris": int(hf.num_triangles), "device": device_name(device)})


def config4(fixtures, device, size, spp):
    scene, camera, cfg = config4_setup(fixtures, size)
    rays, dt = time_frame(scene, camera, cfg, spp or cfg.samples_per_pixel, device)
    emit("config4_armor_class_gltf_hw_sky_800x450_64spp", rays, dt,
         {"tris": int(scene.num_triangles), "device": device_name(device)})


def config5(fixtures, device, size, ckpt, quick=False, spp5=0):
    import numpy as np

    scene, camera, cfg = config5_setup(fixtures, size)
    spp_target = spp5 or (8 if quick else 256)
    scene.to(device)
    pr, done_spp, dt = run_config5(scene, camera, cfg, spp_target, ckpt, device)
    if not np.isfinite(pr.state.accum).all():
        raise RuntimeError("config 5: non-finite accumulator")
    emit(f"config5_night_car_class_1080p_{done_spp}spp_progressive",
         done_spp * camera.image_width * camera.image_height, dt,
         {"tris": int(scene.num_triangles), "resumed_mid_run": True,
          "device": device_name(device)})


def main(argv=None) -> int:
    from rt_tpu_torch.fixtures import ensure_fixtures
    from rt_tpu_torch.render import _device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="cap config 5 at 8 spp")
    ap.add_argument("--spp5", type=int, default=0, help="override config 5 spp")
    ap.add_argument("--only", type=int, default=0)
    ap.add_argument("--depthcheck", action="store_true",
                    help="config 3: also record depth-16 vs depth-50 agreement")
    ap.add_argument("--device", default="cuda", help="cuda | cuda:N | cpu")
    ap.add_argument("--fixtures", default=os.path.join(REPO, "build", "fixtures"),
                    help="directory of the fixtures (written there if missing)")
    ap.add_argument("--size", default=None,
                    help="WIDTHxHEIGHT for every config (default: each config's own)")
    ap.add_argument("--spp", type=int, default=0, help="override the spp of configs 2-4")
    args = ap.parse_args(argv)

    device = _device(args.device)
    if device.type == "cuda":
        from rt_tpu_torch import _build

        _build.library()  # the kernels' build is set-up, not config 5's time
    size = tuple(int(v) for v in args.size.split("x")) if args.size else None
    fixtures = ensure_fixtures(args.fixtures)
    ckpt = os.path.join(args.fixtures, "bench_config5.ckpt.npz")
    todo = [args.only] if args.only else [2, 3, 4, 5]
    if 2 in todo:
        config2(device, size or (400, 225), args.spp)
    if 3 in todo:
        config3(fixtures, device, size or (800, 450), args.spp, args.depthcheck)
    if 4 in todo:
        config4(fixtures, device, size or (800, 450), args.spp)
    if 5 in todo:
        config5(fixtures, device, size or (1920, 1080), ckpt, args.quick, args.spp5)
    sync(device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
