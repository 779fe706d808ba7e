"""Nearest-hit search and hit attributes.

Counterparts of the JAX package's rt_tpu/geometry.py:

- ``HitRecord``, ``hit_attributes`` (:40, :239): the full hit payload of
  the winners (point, flipped normal, front face, UV, material);
- ``sphere_candidate_t`` (:59), the matrix-product form of the sphere
  test, and ``nearest_hit_bruteforce`` (:207) over it;
- ``unit_sphere_uv``, ``sphere_uv_facing``, ``triangle_uv`` (:89-199);
- ``nearest_hit`` (:294): on a scene with a BVH, whatever the ``impl``,
  the BVH walk with the winner's t recomputed differentiably
  (bvh/traverse.py ``nearest_hit_bvh_diff``); otherwise "pallas" is
  ``_nearest_kernel``, "detached" ``nearest_search_detached`` and "auto"
  the brute force;
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

``sphere_nearest`` is K2 (nearest_ops.sphere_nearest) and ``bvh_walk`` the
BVH walk (bvh/traverse.bvh_walk): each the CUDA kernel on the card, its
plain version on the CPU.  Passing ``nearest_ops.sphere_nearest_plain`` or
``traverse.bvh_walk_plain`` runs the plain version on the card, to hold
the kernel against it.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from rt_tpu_torch import nearest_ops
from rt_tpu_torch.bvh import traverse
from rt_tpu_torch.bvh.traverse import TRI_EPS, _prim_t
from rt_tpu_torch.config import CompatConfig
from rt_tpu_torch.elementwise import cross3, div, dot3

BIG = 3.0e38


@dataclasses.dataclass
class HitRecord:
    """Hit payload of N rays (intersection.rs:8-15; a miss is hit False,
    t BIG, prim -1)."""

    t: torch.Tensor  # f32[N]
    prim: torch.Tensor  # int[N] global primitive id (spheres, then triangles)
    hit: torch.Tensor  # bool[N]
    point: torch.Tensor  # f32[N, 3]
    normal: torch.Tensor  # f32[N, 3], flipped against the ray for spheres
    front: torch.Tensor  # bool[N]
    uv: torch.Tensor  # f32[N, 2]
    material: torch.Tensor  # int32[N]


def _rows_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of 3-vectors, in jnp.sum's order."""
    p = a * b
    return p[..., 0] + p[..., 1] + p[..., 2]


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """jnp.cross over the last axis."""
    return torch.stack(cross3([a[..., k] for k in range(3)], [b[..., k] for k in range(3)]), dim=-1)


def sphere_candidate_t(org, dirn, center, radius, t_min, t_max):
    """Candidate t per (ray, sphere) pair, f32[N, S] (BIG on a miss), in
    the JAX package's matrix-product form: d.c and o.c as [N,3] x [3,S]
    products, the near root if in range, else the far root
    (hittable.rs:330-338)."""
    d_dot_c = dirn @ center.T
    o_dot_c = org @ center.T
    a = (dirn * dirn).sum(dim=-1)
    d_dot_o = (dirn * org).sum(dim=-1)
    c_sq = (center * center).sum(dim=-1)
    o_sq = (org * org).sum(dim=-1)
    h = d_dot_c - d_dot_o[:, None]
    c_coef = c_sq[None, :] - 2.0 * o_dot_c + o_sq[:, None] - (radius * radius)[None, :]
    disc = h * h - a[:, None] * c_coef
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=1.0e-30))
    inv_a = div(1.0, a[:, None])
    t0 = (h - sqrt_disc) * inv_a
    t1 = (h + sqrt_disc) * inv_a
    ok = (disc >= 0.0) & (radius > 0.0)[None, :]
    in0 = ok & (t0 >= t_min) & (t0 < t_max)
    in1 = ok & (t1 >= t_min) & (t1 < t_max)
    return torch.where(in0, t0, torch.where(in1, t1, BIG))


def _uv_rotated(px, py, pz, cy, sy, cp, sp, rotation=0.0):
    """UV of a unit-sphere point under Ry(pitch) @ Rz(-yaw), given the
    angles' cosines and sines (hittable.rs:367-406).  The pole guard keeps
    atan2 off (0, 0); the acos input is clamped, so no UV is NaN."""
    qx = cy * px + sy * py
    qy = -sy * px + cy * py
    rx = cp * qx + sp * pz
    ry = qy
    rz = -sp * qx + cp * pz
    rx = torch.where(rx * rx + ry * ry < 1.0e-12, 1.0, rx)
    theta = torch.arccos(torch.clamp(-rz, -1.0 + 1.0e-7, 1.0 - 1.0e-7))
    phi = torch.remainder(torch.atan2(ry, rx) + math.pi + rotation, 2.0 * math.pi)
    return torch.stack([phi / (2.0 * math.pi), theta / math.pi], dim=-1)


def unit_sphere_uv(point, pitch_rads, yaw_rads, rotation_rads):
    """UV of a unit-sphere ``point`` f32[..., 3] with the texture pitched,
    yawed and rotated (hittable.rs:367-388); angles in radians, tensors
    broadcastable against the points."""
    pitch, yaw = torch.as_tensor(pitch_rads), torch.as_tensor(yaw_rads)
    return _uv_rotated(point[..., 0], point[..., 1], point[..., 2], torch.cos(yaw),
                       torch.sin(yaw), torch.cos(pitch), torch.sin(pitch), rotation_rads)


def sphere_uv_facing(p, face_dir):
    """UV of unit-sphere points ``p`` with the texture facing ``face_dir``
    (both f32[..., 3]; hittable.rs:367-406)."""
    fx, fy, fz = face_dir[..., 0], face_dir[..., 1], face_dir[..., 2]
    pitch = torch.atan2(fz, torch.sqrt(fx * fx + fy * fy + 1.0e-20))
    yaw = torch.atan2(fy, fx)
    return _uv_rotated(p[..., 0], p[..., 1], p[..., 2], torch.cos(yaw), torch.sin(yaw),
                       torch.cos(pitch), torch.sin(pitch))


def triangle_uv(uv_abc, u, v, compat: CompatConfig):
    """Hit UV from barycentrics (u, v) and vertex UVs f32[..., 3, 2].  With
    ``compat.triangle_uv_bbox_remap`` (the reference quirk,
    hittable.rs:466-481) (u, v) is mapped into the bounding box of the
    three UVs; otherwise it is interpolated."""
    if compat.triangle_uv_bbox_remap:
        lo = uv_abc.amin(dim=-2)
        hi = uv_abc.amax(dim=-2)
        return lo + (hi - lo) * torch.stack([u, v], dim=-1)
    w = 1.0 - u - v
    return w[..., None] * uv_abc[..., 0, :] + u[..., None] * uv_abc[..., 1, :] \
        + v[..., None] * uv_abc[..., 2, :]


def nearest_hit_bruteforce(scene, org, dirn, t_min, t_max, compat: CompatConfig):
    """(t f32[N], prim int32[N]) over every primitive: the spheres in the
    matrix-product form, then the triangles; a triangle wins only when
    strictly nearer."""
    n = org.shape[0]
    t_best = torch.full((n,), BIG, device=org.device)
    prim_best = torch.full((n,), -1, dtype=torch.int32, device=org.device)
    if scene.num_spheres > 0:
        ts = sphere_candidate_t(org, dirn, scene.sph_center, scene.sph_radius, t_min, t_max)
        s_t, s_idx = torch.min(ts, dim=-1)
        better = s_t < t_best
        t_best = torch.where(better, s_t, t_best)
        prim_best = torch.where(better, s_idx.to(torch.int32), prim_best)
    if scene.num_triangles > 0:
        tt = triangle_candidate(org, dirn, scene.tri_a, scene.tri_b, scene.tri_c, t_min, t_max,
                                compat)
        t_t, t_idx = torch.min(tt, dim=-1)
        better = t_t < t_best
        t_best = torch.where(better, t_t, t_best)
        prim_best = torch.where(better, t_idx.to(torch.int32) + scene.num_spheres, prim_best)
    return t_best, prim_best


def hit_attributes(scene, org, dirn, t, prim, compat: CompatConfig) -> HitRecord:
    """The full hit payload of the winners (t, prim) (hittable.rs:340-363,
    462-490), with the barycentrics recomputed for the winning triangle."""
    hit = (prim >= 0) & (t < BIG)
    t_safe = torch.where(hit, t, 0.0)
    point = org + t_safe[:, None] * dirn
    ns, nt = scene.num_spheres, scene.num_triangles
    prim = prim.to(torch.int64)
    is_sphere = (prim >= 0) & (prim < ns)
    s_idx = torch.clamp(prim, 0, max(ns - 1, 0))
    t_idx = torch.clamp(prim - ns, 0, max(nt - 1, 0))

    s_center = scene.sph_center[s_idx]
    s_radius = torch.clamp(scene.sph_radius[s_idx], min=1.0e-20)
    s_normal_out = (point - s_center) / s_radius[:, None]
    s_front = _rows_dot(dirn, s_normal_out) < 0.0
    s_normal = torch.where(s_front[:, None], s_normal_out, -s_normal_out)
    s_uv = sphere_uv_facing(s_normal, scene.sph_front_dir[s_idx])

    a, b, c = scene.tri_a[t_idx], scene.tri_b[t_idx], scene.tri_c[t_idx]
    e1, e2 = b - a, c - a
    u_vec = _cross(dirn, e2)
    det = _rows_dot(e1, u_vec)
    inv_det = div(1.0, torch.where(torch.abs(det) > 1.0e-20, det, 1.0))
    ao = org - a
    bu = _rows_dot(ao, u_vec) * inv_det
    bv = _rows_dot(dirn, _cross(ao, e1)) * inv_det
    t_normal = scene.tri_normal[t_idx]
    t_front = _rows_dot(dirn, t_normal) <= 0.0  # hittable.rs:464
    t_uv = triangle_uv(scene.tri_uv[t_idx], bu, bv, compat)

    sphere_mask = is_sphere[:, None]
    material = torch.where(is_sphere, scene.sph_material[s_idx], scene.tri_material[t_idx])
    return HitRecord(
        t=t,
        prim=torch.where(hit, prim, -1),
        hit=hit,
        point=point,
        normal=torch.where(sphere_mask, s_normal, t_normal),
        front=torch.where(is_sphere, s_front, t_front),
        uv=torch.where(sphere_mask, s_uv, t_uv),
        material=material.to(torch.int32),
    )


def nearest_hit(scene, org, dirn, t_min, t_max, compat: CompatConfig = CompatConfig(),
                impl: str = "auto", *, sphere_nearest=nearest_ops.sphere_nearest,
                bvh_walk=traverse.bvh_walk) -> HitRecord:
    """The nearest hit of each ray, with its attributes (World::hit,
    hittable.rs:135-149).  A scene with a BVH walks it for every ``impl``
    (``nearest_hit_bvh_diff``: differentiable in t), as the JAX package
    does.  Otherwise ``impl``: "pallas" searches with K2 for the spheres
    (``_nearest_kernel``), "detached" too but differentiable in t
    (``nearest_search_detached``), "auto" by brute force; all give the same
    winners up to rounding."""
    if impl not in ("pallas", "detached", "auto"):
        raise ValueError(f"unknown nearest_hit impl {impl!r}")
    if scene.bvh is not None:
        t, prim = traverse.nearest_hit_bvh_diff(scene, org, dirn, t_min, t_max, compat,
                                                walk=bvh_walk)
    elif impl == "pallas":
        t, prim = _nearest_kernel(scene, org, dirn, t_min, t_max, compat, sphere_nearest)
    elif impl == "detached":
        t, prim = nearest_search_detached(scene, org, dirn, t_min, t_max, compat, sphere_nearest)
    else:
        t, prim = nearest_hit_bruteforce(scene, org, dirn, t_min, t_max, compat)
    return hit_attributes(scene, org, dirn, t, prim, compat)


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
