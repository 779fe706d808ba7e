#!/usr/bin/env python
"""Gradient benchmark of the PyTorch/CUDA port: pixel-grad backward-pass
time per 1-spp frame, the port's counterpart of bench_grad.py.

The second BASELINE.json metric ("pixel-grad backward pass time per 1spp
frame tracked"), at bench_grad.py's shape: the cover scene
(cover_scene(11, 11, cam1(400, 225), z=-0.2, seed=0)), every pixel at 1
spp, diff_max_depth 6, the MSE loss against a zero target under key 0,
differentiated with respect to all seven ``SceneParams`` leaves (texture
colours, atlas, fuzz, IOR, sun, turbidity, exposure).  The backward time
is one ``grad.pixel_grad`` (loss and gradients, as jax.value_and_grad);
the forward time one ``grad.pixel_loss`` without autograd.  On a card the
sphere search is K2 (csrc/nearest.cu).  Each time is the best of 5 after a
warm-up, each call ended by a device synchronize.

Prints ONE JSON line with bench_grad.py's keys, {"metric", "value",
"unit", "vs_baseline"} (vs_baseline: the backward/forward ratio), and the
forward time, shape and device.

    python bench_grad_cuda.py                  # on the card
    python bench_grad_cuda.py --device cpu --size 16x9 --reps 1
"""

import argparse
import json
import sys
import time

from bench_cuda import device_name, sync

METRIC = "pixel_grad_backward_s_400x225_1spp"


def main(argv=None) -> int:
    import torch

    from rt_tpu_torch import grad, rng, scenes
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.render import _device

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", help="cuda | cuda:N | cpu")
    parser.add_argument("--size", default="400x225", help="WIDTHxHEIGHT")
    parser.add_argument("--reps", type=int, default=5)
    args = parser.parse_args(argv)

    device = _device(args.device)
    width, height = (int(v) for v in args.size.split("x"))
    camera = scenes.cam1(width, height)
    scene = scenes.cover_scene(11, 11, camera, z=-0.2, seed=0).to(device)
    cfg = RenderConfig(width=width, height=height, diff_max_depth=6)
    n = width * height
    pixel_idx = torch.arange(n, device=device)
    target = torch.zeros((n, 3), device=device)
    key = rng.key(0)
    inputs = (scene, camera, cfg, pixel_idx, target, key)
    params = grad.get_params(scene)

    def fwd():
        with torch.no_grad():
            return grad.pixel_loss(params, *inputs, spp=1)

    def bwd():
        return grad.pixel_grad(*inputs, spp=1)

    def best_of(fn):
        fn()  # warm-up
        sync(device)
        best, out = float("inf"), None
        for _ in range(args.reps):
            t0 = time.perf_counter()
            out = fn()
            sync(device)
            best = min(best, time.perf_counter() - t0)
        return best, out

    t_fwd, _ = best_of(fwd)
    t_bwd, (loss, g) = best_of(bwd)
    if not (bool(torch.isfinite(loss)) and all(bool(torch.isfinite(v).all()) for v in g)):
        raise RuntimeError("non-finite loss or gradient")
    print(json.dumps({
        "metric": METRIC,
        "value": round(t_bwd, 4),
        "unit": "s",
        "vs_baseline": round(t_bwd / t_fwd, 3),  # backward/forward ratio
        "forward_s": t_fwd,
        "backward_s": t_bwd,
        "width": width,
        "height": height,
        "device": device_name(device),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
