"""Nearest hit through a scene's BVH (rt_tpu/bvh/traverse.py).

- ``_prim_t`` and its sphere and triangle tests (:31-102): the candidate t
  of one given primitive per ray.  The gradient path recomputes the
  winner's t with it on the live rays;
- ``bvh_walk`` (``nearest_hit_bvh``, :105-165): the stackless threaded
  walk.  Every ray carries a node cursor; a node whose box the ray enters
  closer than its best t is descended (``hit_next``), any other is skipped
  (``miss_next``); a leaf tests its up to ``LEAF_SIZE`` primitives with a
  strict ``<`` against min(best t, t_max).  On a CUDA tensor it is one
  launch of the hand-written kernel of csrc/bvh_walk.cu, one thread per
  ray; on a CPU tensor it is ``bvh_walk_plain``, the JAX package's
  ``while_loop`` as a Python loop over node steps, vectorized over rays and
  bit-equal to the kernel.  Neither is a TPU kernel: JAX runs the loop as
  one XLA program;
- ``nearest_hit_bvh_diff`` (:168-185): the walk without gradients picks
  the winner, and only the winner's t is recomputed differentiably.
"""

from __future__ import annotations

import numpy as np
import torch

from rt_tpu_torch import _build
from rt_tpu_torch.bvh.builder import LEAF_SIZE
from rt_tpu_torch.config import CompatConfig
from rt_tpu_torch.elementwise import cross3, div, dot3, maximum, minimum

BIG = 3.0e38
TRI_EPS = 1.0e-7
TINY = 1.0e-20  # the walk's floor on |direction| components

# Launches of the walk kernel since the last reset.  Only the wrapper
# changes it, once per launch; callers read and reset it to show that a run
# went through the kernel.
LAUNCHES = {"bvh_walk": 0}


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


def _t_init(t_max: float) -> float:
    """The walk's starting best t, min(BIG, t_max) in f32."""
    return float(np.minimum(np.float32(BIG), np.float32(t_max)))


def bvh_walk_plain(scene, org, dirn, t_min, t_max, compat: CompatConfig):
    """The walk's plain version: (t f32[N], prim int32[N], -1 and BIG on a
    miss) of rays org, dirn f32[N, 3], one node step of every ray per
    iteration until no cursor is left."""
    bvh = scene.bvh
    n, device = org.shape[0], org.device
    n_nodes, n_order = bvh.node_min.shape[0], bvh.prim_order.shape[0]
    tiny = torch.tensor(TINY, dtype=torch.float32)
    inv_dir = div(1.0, torch.where(torch.abs(dirn) > tiny, dirn, tiny.to(device)))
    t_max32 = float(np.float32(t_max))
    cur = torch.zeros((n,), dtype=torch.int64, device=device)
    t_best = torch.full((n,), _t_init(t_max), device=device)
    prim_best = torch.full((n,), -1, dtype=torch.int32, device=device)
    while bool((cur >= 0).any()):
        active = cur >= 0
        node = torch.clamp(cur, 0, n_nodes - 1)
        t_lo = (bvh.node_min[node] - org) * inv_dir
        t_hi = (bvh.node_max[node] - org) * inv_dir
        t_near = torch.clamp(torch.minimum(t_lo, t_hi).amax(dim=-1), min=0.0)
        t_far = torch.maximum(t_lo, t_hi).amin(dim=-1)
        box_hit = active & (t_near <= t_far) & (t_far >= 0.0) & (t_near < t_best)
        start = bvh.leaf_start[node].to(torch.int64)
        count = bvh.leaf_count[node]
        is_leaf = start >= 0
        do_leaf = box_hit & is_leaf
        t_limit = minimum(t_best, t_max32)
        for i in range(LEAF_SIZE):
            pid = bvh.prim_order[torch.clamp(start + i, 0, n_order - 1)]
            t_cand = _prim_t(scene, pid, org, dirn, t_min, t_limit, compat)
            better = do_leaf & (i < count) & (t_cand < t_limit)
            t_best = torch.where(better, t_cand, t_best)
            prim_best = torch.where(better, pid.to(torch.int32), prim_best)
            t_limit = minimum(t_best, t_max32)
        nxt = torch.where(box_hit & ~is_leaf, bvh.hit_next[node], bvh.miss_next[node])
        cur = torch.where(active, nxt.to(torch.int64), -1)
    return torch.where(prim_best >= 0, t_best, BIG), prim_best


def bvh_walk(scene, org, dirn, t_min, t_max, compat: CompatConfig):
    """(t f32[N], prim int32[N]) of the nearest hit through ``scene.bvh``:
    the CUDA kernel on a CUDA tensor, the plain version on a CPU tensor."""
    if org.device.type == "cpu":
        return bvh_walk_plain(scene, org, dirn, t_min, t_max, compat)
    return _launch(scene, org, dirn, t_min, t_max, compat)


def _launch(scene, org, dirn, t_min, t_max, compat: CompatConfig):
    """Wrapper of the walk kernel: checks its inputs, allocates the outputs
    and launches on the current stream.  Raises on any failure."""
    device = org.device
    if device.type != "cuda":
        raise ValueError(f"bvh_walk: no kernel for device {device}")
    n = org.shape[0]
    if org.shape != (n, 3) or dirn.shape != (n, 3):
        raise ValueError(f"bvh_walk: need org, dirn [N, 3], got {tuple(org.shape)}, "
                         f"{tuple(dirn.shape)}")
    org = _build.require(org.detach().to(torch.float32).contiguous(), "bvh_walk: org", device)
    dirn = _build.require(dirn.detach().to(torch.float32).contiguous(), "bvh_walk: dirn", device)
    bvh = scene.bvh
    tables = [_build.require(getattr(bvh, k), f"bvh_walk: {k}", device, dtype)
              for k, dtype in (("node_min", torch.float32), ("node_max", torch.float32),
                               ("hit_next", torch.int32), ("miss_next", torch.int32),
                               ("leaf_start", torch.int32), ("leaf_count", torch.int32),
                               ("prim_order", torch.int32))]
    prims = [_build.require(getattr(scene, k).detach(), f"bvh_walk: {k}", device)
             for k in ("sph_center", "sph_radius", "tri_a", "tri_b", "tri_c")]
    ns, nt = scene.num_spheres, scene.num_triangles
    if prims[0].shape[0] < ns or prims[2].shape[0] < nt:
        raise ValueError("bvh_walk: primitive tables are shorter than the counts")
    t_out = torch.empty((n,), dtype=torch.float32, device=device)
    prim = torch.empty((n,), dtype=torch.int32, device=device)
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.rt_bvh_walk(
            org.data_ptr(), dirn.data_ptr(), n, *(t.data_ptr() for t in tables),
            bvh.node_min.shape[0], bvh.prim_order.shape[0], prims[0].data_ptr(),
            prims[1].data_ptr(), ns, prims[2].data_ptr(), prims[3].data_ptr(),
            prims[4].data_ptr(), nt, t_min, t_max, _t_init(t_max),
            int(bool(compat.triangle_backface_cull)), t_out.data_ptr(), prim.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"bvh_walk launch failed with CUDA error {err}")
    LAUNCHES["bvh_walk"] += 1
    return t_out, prim


def nearest_hit_bvh_diff(scene, org, dirn, t_min, t_max, compat: CompatConfig, walk=bvh_walk):
    """Differentiable nearest hit for BVH scenes: the walk runs without
    gradients and picks the winner; the winner's t is recomputed from the
    live rays, so gradients flow through t (the detached-decision
    estimator)."""
    with torch.no_grad():
        _, prim = walk(scene, org.detach(), dirn.detach(), t_min, t_max, compat)
    t = _prim_t(scene, torch.clamp(prim, min=0), org, dirn, t_min, t_max, compat)
    return torch.where(prim >= 0, t, BIG), prim
