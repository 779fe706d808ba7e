#!/usr/bin/env python
"""Inverse rendering demo on the PyTorch port: recover material and sky
parameters from pixels (the port of examples/inverse_rendering.py).

Renders a target image with known parameters, perturbs them (a wrong
albedo, a wrong sky exposure), and runs Adam through the differentiable
path tracer (``render_chunk(differentiable=True)``, K2 on the card) until
the render matches: the end-to-end capability the reference, a
forward-only CPU tracer, has no analog of.  ``torch.optim.Adam`` takes the
place of optax's, with the same learning rate and defaults.

    python examples/inverse_rendering_torch.py [--steps 60] [--device cpu] [--out DIR]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from rt_tpu_torch import grad as grad_mod  # noqa: E402
from rt_tpu_torch import rng, scenes  # noqa: E402
from rt_tpu_torch.config import CompatConfig, RenderConfig  # noqa: E402
from rt_tpu_torch.render import _device, render_chunk  # noqa: E402
from rt_tpu_torch.scene import SceneBuilder  # noqa: E402

W, H, SPP = 48, 32, 4


def setup(device):
    """(scene, camera, cfg, pixel_idx, key) of the demo on ``device``."""
    b = SceneBuilder()
    lam = b.lambertian_rgb(0.75, 0.25, 0.2)  # ground-truth albedo
    metal = b.metal_solid((0.7, 0.6, 0.5), 0.15)
    b.add_sphere((-0.6, 0.4, 0.0), 0.7, lam)
    b.add_sphere((0.7, -0.3, 0.1), 0.6, metal)
    scene = b.build(use_bvh=False).to(device)
    camera = scenes.cam1(W, H)
    cfg = RenderConfig(width=W, height=H, diff_max_depth=4, detach_sampling=False,
                       compat=CompatConfig(rr_clamp=0.6))
    pixel_idx = torch.arange(W * H, dtype=torch.int32, device=device)
    return scene, camera, cfg, pixel_idx, rng.key(0)


def perturbed(params: grad_mod.SceneParams) -> grad_mod.SceneParams:
    """The starting point: albedo (0.2, 0.7, 0.7) and 1.8 x the exposure."""
    tex = params.tex_color.detach().clone()
    tex[0] = torch.tensor([0.2, 0.7, 0.7])
    return params._replace(tex_color=tex, sky_exposure=params.sky_exposure.detach() * 1.8)


def run(steps: int, device="cuda", log=print) -> dict:
    """Fit for ``steps`` Adam steps.  Returns the loss before each step,
    the albedo after each, the wall seconds of each step (ended by the
    loss on the host), the truth, and the final parameters."""
    device = _device(device)
    scene, camera, cfg, pixel_idx, key = setup(device)
    true_params = grad_mod.get_params(scene)
    with torch.no_grad():
        target = render_chunk(scene, camera, pixel_idx, cfg, SPP, 0, key, differentiable=True)
    params = grad_mod.SceneParams(*(p.detach().clone().requires_grad_()
                                    for p in perturbed(true_params)))
    opt = torch.optim.Adam(params, lr=5e-2)
    losses, albedos, step_s = [], [], []
    for i in range(steps):
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = grad_mod.pixel_loss(params, scene, camera, cfg, pixel_idx, target, key, SPP)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))  # waits for the device
        step_s.append(time.perf_counter() - t0)
        albedos.append(params.tex_color[0].detach().cpu().numpy().copy())
        if i % 10 == 0 or i == steps - 1:
            log(f"step {i:3d}  loss {losses[-1]:.6f}  albedo {albedos[-1].round(3)}  "
                f"exposure {float(params.sky_exposure.detach()):.3f}")
    return {"losses": losses, "albedos": albedos, "step_s": step_s,
            "truth": true_params.tex_color[0].cpu().numpy(), "params": params,
            "setup": (scene, camera, cfg, pixel_idx, key), "target": target}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--device", default="cuda", help="cuda | cuda:N | cpu")
    parser.add_argument("--out", default=None, help="optional before/after PNG dir")
    args = parser.parse_args(argv)

    res = run(args.steps, args.device)
    got, want = res["albedos"][-1], res["truth"]
    print(f"recovered albedo {got.round(3)} vs truth {want.round(3)} "
          f"(max err {np.abs(got - want).max():.3f})")
    if args.out:
        from rt_tpu_torch.io import write_png

        os.makedirs(args.out, exist_ok=True)
        scene, camera, cfg, pixel_idx, key = res["setup"]
        with torch.no_grad():
            final = render_chunk(grad_mod.set_params(scene, res["params"]), camera, pixel_idx,
                                 cfg, SPP, 0, key, differentiable=True)
        for name, img in (("target", res["target"]), ("recovered", final)):
            write_png(os.path.join(args.out, f"{name}.png"), img.cpu().numpy().reshape(H, W, 3))
    return 0


if __name__ == "__main__":
    sys.exit(main())
