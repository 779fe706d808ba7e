"""Nearest-hit search of the chunked and gradient paths.

Counterparts of the JAX package's rt_tpu/geometry.py:

- ``triangle_candidate`` (geometry.py:149): Möller–Trumbore per (ray,
  triangle) pair over [N, T] broadcasts (t only: no caller reads the
  barycentrics);
- ``_nearest_kernel`` (``_nearest_pallas``, :361-385): K2 for the spheres,
  then brute-force triangles, merged to the global nearest (sphere ids
  first; a triangle wins only when strictly nearer);
- ``nearest_search_detached`` (:336-358): the winner search runs on
  detached inputs, and only the winner's t is recomputed differentiably
  (bvh/traverse.py ``_prim_t``), so the backward pass never holds the
  [N, P] candidate tensors.

``sphere_nearest`` is K2 (nearest_ops.sphere_nearest): the CUDA kernel on
the card, its plain version on the CPU.  Passing
``nearest_ops.sphere_nearest_plain`` runs the plain version on the card,
to hold the kernel against it.
"""

from __future__ import annotations

import torch

from rt_tpu_torch import nearest_ops
from rt_tpu_torch.bvh.traverse import TRI_EPS, _prim_t
from rt_tpu_torch.config import CompatConfig
from rt_tpu_torch.elementwise import cross3, div, dot3

BIG = 3.0e38


def triangle_candidate(org, dirn, a, b, c, t_min, t_max, compat: CompatConfig):
    """Möller–Trumbore for every (ray, triangle) pair: org, dirn f32[N,3];
    a, b, c f32[T,3].  Returns t f32[N,T], a miss as BIG."""
    o = [org[:, k, None] for k in range(3)]  # [N, 1]
    d = [dirn[:, k, None] for k in range(3)]
    av = [a[None, :, k] for k in range(3)]  # [1, T]
    e1 = [b[None, :, k] - a[None, :, k] for k in range(3)]
    e2 = [c[None, :, k] - a[None, :, k] for k in range(3)]
    u_vec = cross3(d, e2)
    det = dot3(e1, u_vec)
    det_ok = det > TRI_EPS if compat.triangle_backface_cull else torch.abs(det) > TRI_EPS
    inv_det = div(1.0, torch.where(det_ok, det, 1.0))
    ao = [o[k] - av[k] for k in range(3)]
    u = dot3(ao, u_vec) * inv_det
    v_vec = cross3(ao, e1)
    v = dot3(d, v_vec) * inv_det
    t = dot3(e2, v_vec) * inv_det
    valid = (
        det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t >= t_min) & (t < t_max) & (t > TRI_EPS)  # hittable.rs:461
    )
    return torch.where(valid, t, BIG)


def _nearest_kernel(scene, org, dirn, t_min, t_max, compat: CompatConfig,
                    sphere_nearest=nearest_ops.sphere_nearest):
    """K2 spheres + brute-force triangles, merged to the global nearest:
    (t f32[N], prim int32[N], -1 on a miss)."""
    n = org.shape[0]
    t_best = torch.full((n,), BIG, device=org.device)
    prim_best = torch.full((n,), -1, dtype=torch.int32, device=org.device)
    if scene.num_spheres > 0:
        s_t, s_idx = sphere_nearest(org, dirn, scene.sph_center, scene.sph_radius,
                                    float(t_min), float(t_max))
        better = s_t < t_best
        t_best = torch.where(better, s_t, t_best)
        prim_best = torch.where(better & (s_idx >= 0), s_idx, prim_best)
    if scene.num_triangles > 0:
        tt = triangle_candidate(org, dirn, scene.tri_a, scene.tri_b, scene.tri_c,
                                t_min, t_max, compat)
        t_t, t_idx = torch.min(tt, dim=-1)  # first minimum, as jnp.argmin
        better = t_t < t_best
        t_best = torch.where(better, t_t, t_best)
        prim_best = torch.where(better, t_idx.to(torch.int32) + scene.num_spheres, prim_best)
    return t_best, prim_best


def nearest_search_detached(scene, org, dirn, t_min, t_max, compat: CompatConfig,
                            sphere_nearest=nearest_ops.sphere_nearest):
    """Differentiable (t f32[N], prim int32[N]) by the detached-decision
    estimator: the search runs without gradients, and the winner's t is
    recomputed from the live rays.  Gradients match the brute-force path
    almost everywhere (the argmin winner is locally constant)."""
    with torch.no_grad():
        _, prim = _nearest_kernel(scene, org.detach(), dirn.detach(), t_min, t_max, compat,
                                  sphere_nearest)
    t = _prim_t(scene, torch.clamp(prim, min=0), org, dirn, t_min, t_max, compat)
    return torch.where(prim >= 0, t, BIG), prim
