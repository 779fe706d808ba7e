"""Per-ray candidate t of one given primitive (rt_tpu/bvh/traverse.py:31-102).

These are the differentiable recompute of the winner's t on the gradient
path: the search picks the primitive without gradients, and ``_prim_t``
evaluates that one primitive again on the live rays.  The BVH walk of the
JAX module is a later slice of the port.
"""

from __future__ import annotations

import torch

from rt_tpu_torch.config import CompatConfig
from rt_tpu_torch.elementwise import cross3, div, dot3, maximum

BIG = 3.0e38
TRI_EPS = 1.0e-7


def _sub(a, b):
    return [x - y for x, y in zip(a, b)]


def _sphere_t_single(org, dirn, center, radius, t_min, t_limit):
    """Per-ray single-sphere candidate t (hittable.rs:318-338); inputs
    gathered per ray: center f32[N,3], radius f32[N]."""
    d = dirn.unbind(1)
    oc = _sub(center.unbind(1), org.unbind(1))
    a = dot3(d, d)
    h = dot3(d, oc)
    c = dot3(oc, oc) - radius * radius
    disc = h * h - a * c
    sqrt_disc = torch.sqrt(maximum(disc, 1.0e-30))  # finite gradient at disc = 0
    t0 = (h - sqrt_disc) / a
    t1 = (h + sqrt_disc) / a
    t_cand = torch.where(t0 >= t_min, t0, t1)
    ok = (disc >= 0.0) & (radius > 0.0) & (t_cand >= t_min) & (t_cand < t_limit)
    return torch.where(ok, t_cand, BIG)


def _triangle_t_single(org, dirn, a, b, c, t_min, t_limit, compat: CompatConfig):
    """Per-ray single-triangle Möller–Trumbore (hittable.rs:408-461)."""
    a, d = a.unbind(1), dirn.unbind(1)
    e1 = _sub(b.unbind(1), a)
    e2 = _sub(c.unbind(1), a)
    u_vec = cross3(d, e2)
    det = dot3(e1, u_vec)
    det_ok = det > TRI_EPS if compat.triangle_backface_cull else torch.abs(det) > TRI_EPS
    inv_det = div(1.0, torch.where(det_ok, det, 1.0))
    ao = _sub(org.unbind(1), a)
    u = dot3(ao, u_vec) * inv_det
    v_vec = cross3(ao, e1)
    v = dot3(d, v_vec) * inv_det
    t = dot3(e2, v_vec) * inv_det
    ok = (
        det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
        & (t >= t_min) & (t < t_limit) & (t > TRI_EPS)
    )
    return torch.where(ok, t, BIG)


def _prim_t(scene, pid, org, dirn, t_min, t_limit, compat):
    """Candidate t for global prim id ``pid`` int[N] (sphere ids first)."""
    ns, nt = scene.num_spheres, scene.num_triangles
    pid = pid.to(torch.int64)
    is_sphere = pid < ns
    s_idx = torch.clamp(pid, 0, max(ns - 1, 0))
    t_idx = torch.clamp(pid - ns, 0, max(nt - 1, 0))
    big = torch.full(pid.shape, BIG, device=org.device)
    ts = (
        _sphere_t_single(org, dirn, scene.sph_center[s_idx], scene.sph_radius[s_idx], t_min, t_limit)
        if ns > 0 else big
    )
    tt = (
        _triangle_t_single(org, dirn, scene.tri_a[t_idx], scene.tri_b[t_idx], scene.tri_c[t_idx],
                           t_min, t_limit, compat)
        if nt > 0 else big
    )
    return torch.where(is_sphere, ts, tt)
