"""Click-to-inspect debug probe (rt_tpu/debug.py).

Reference analog: the preview window's left-click handler fires a
center-of-pixel ray and prints the Intersection plus the scatter result
(window.rs:141-172 -> camera.rs:256-277).  The probe is a function that
returns a plain dict, for the CLI (``--probe``), the HTTP viewer's
``/probe`` route or a notebook.  It draws the scatter under
``rng.key(cfg.seed)``, the threefry key the JAX package draws it under, so
both packages return the same dict.
"""

from __future__ import annotations

import torch

from rt_tpu_torch import materials, rng
from rt_tpu_torch.camera import Camera
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.geometry import nearest_hit
from rt_tpu_torch.render import _device
from rt_tpu_torch.scene import SceneData

_MAT_NAMES = {0: "Lambertian", 1: "Metal", 2: "Dielectric"}


def debug_pixel(
    scene: SceneData,
    camera: Camera,
    x: float,
    y: float,
    cfg: RenderConfig = RenderConfig(),
    *,
    device="cuda",
) -> dict | None:
    """One-bounce probe at pixel (x, y) on ``device`` (the scene's tables
    are moved there); None when the ray hits the sky (the reference prints
    "Ray missed any objects (hit the skybox).", window.rs:168).  On a scene
    with a BVH the search is the BVH walk, otherwise the brute force, as in
    the JAX package."""
    device = _device(device)
    scene.to(device)
    org, dirn = (v.to(device)[None, :] for v in camera.debug_ray(x, y))
    with torch.no_grad():
        rec = nearest_hit(scene, org, dirn, cfg.t_min, cfg.t_max, cfg.compat)
        if not bool(rec.hit[0]):
            return None
        attenuation, scattered = materials.scatter(scene, rec, dirn, rng.key(cfg.seed))
    mat_id = min(max(int(rec.material[0]), 0), scene.mat_kind.shape[0] - 1)
    mat_kind = int(scene.mat_kind[mat_id])
    floats = lambda v: [float(c) for c in v[0].cpu()]
    return {
        "point": floats(rec.point),
        "normal": floats(rec.normal),
        "t": float(rec.t[0]),
        "prim": int(rec.prim[0]),
        "is_front_face": bool(rec.front[0]),
        "uv": floats(rec.uv),
        "material": _MAT_NAMES.get(mat_kind, str(mat_kind)),
        "material_id": int(rec.material[0]),
        "attenuation": floats(attenuation),
        "scattered_dir": floats(scattered),
    }
