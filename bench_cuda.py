#!/usr/bin/env python
"""Benchmark of the PyTorch/CUDA port: Mray/s on the RTIOW cover scene
(BASELINE.json config 1), the port's counterpart of bench.py.

Prints ONE JSON line with bench.py's keys, {"metric", "value", "unit",
"vs_baseline"}, and the shape and device it ran at.  The metric is the
reference's own throughput counter (window.rs:315-324): rays = spp * W * H
camera samples (bounce rays not counted) over wall seconds.  vs_baseline is
against the BASELINE.json north-star target of 100 Mray/s.

The frame is ``scenes.bench_cover_config()`` (cover_scene 11x11, cam1 at
400x225, depth 50) rendered by ``render_pixel_colors(spp=640)``, the bench
config's 10 spp x 64 sweeps in one call: on a card one launch of the flat
megakernel (K1).  One warm-up, then the best of 3 calls, each ended by a
device synchronize.

    python bench_cuda.py                       # on the card
    python bench_cuda.py --device cpu --size 64x36 --spp 1 --trials 1
"""

import argparse
import json
import sys
import time

NORTH_STAR_MRAY_S = 100.0
METRIC = "mray_per_s_cover_400x225_640spp"


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device) -> str:
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def bench_frame(width: int, height: int):
    """(scene, camera, cfg) of the bench, at another size if asked."""
    from rt_tpu_torch import scenes

    scene, camera, cfg = scenes.bench_cover_config()
    if (width, height) != (camera.image_width, camera.image_height):
        camera = scenes.cam1(width, height)
        scene = scenes.cover_scene(11, 11, camera, z=-0.2, seed=0)
        cfg = cfg.replace(width=width, height=height)
    return scene, camera, cfg


def main(argv=None) -> int:
    import torch

    from rt_tpu_torch.render import _device, render_pixel_colors

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda | cuda:N | cpu")
    parser.add_argument("--size", default="400x225", help="WIDTHxHEIGHT")
    parser.add_argument("--spp", type=int, default=640, help="samples per pixel of one call")
    parser.add_argument("--trials", type=int, default=3)
    args = parser.parse_args(argv)

    device = _device(args.device)
    width, height = (int(v) for v in args.size.split("x"))
    scene, camera, cfg = bench_frame(width, height)
    scene.to(device)
    burst = lambda: render_pixel_colors(scene, camera, cfg, device=device, spp=args.spp)

    burst()  # warm-up: builds and loads the kernels on a card
    sync(device)
    best = float("inf")
    for _ in range(args.trials):
        t0 = time.perf_counter()
        img = burst()
        sync(device)
        best = min(best, time.perf_counter() - t0)
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("the bench frame has non-finite values")

    rays = args.spp * width * height
    mray_s = rays / 1.0e6 / best
    print(json.dumps({
        "metric": METRIC,
        "value": round(mray_s, 3),
        "unit": "Mray/s",
        "vs_baseline": round(mray_s / NORTH_STAR_MRAY_S, 4),
        "width": width,
        "height": height,
        "spp": args.spp,
        "wall_s": best,
        "device": device_name(device),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
