"""Path-tracing integrators of the chunked and gradient paths.

Counterparts of the JAX package's rt_tpu/integrator.py on its fast-shade
branch (scenes with a shade table and no BVH):

- ``trace_radiance`` (integrator.py:91-120): forward radiance with early
  exit once every path has ended, up to ``cfg.max_depth``;
- ``trace_radiance_diff`` (:143-161, 188-213): differentiable radiance
  over exactly ``cfg.diff_max_depth + 1`` bounces, each bounce under
  ``torch.utils.checkpoint`` as JAX uses ``jax.checkpoint``, so the
  backward pass keeps one bounce's state at a time and recomputes the rest
  (K2 included: each bounce launches it again in the backward pass).

Both drive ``_fast_trace_setup``'s bounce step, so they agree at equal
depth.  Each bounce runs the detached winner search (geometry, with K2),
the differentiable t recompute, one one-hot parameter fetch over the
differentiably re-assembled shade table, and the scalarized shading
(fast_shade).  Draws key on the lane id ``arange(N)`` of the chunk's rays,
pixel-major, and on the bounce depth.

Discrete events (hit ids, RR survival, reflect vs refract) are decided
with detached quantities; the continuous factors carry gradients.
A scene without a shade table needs the generic bounce step, and a scene
with a BVH the BVH traversal; neither is ported yet, and both raise.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from rt_tpu_torch import fast_shade, nearest_ops, rng
from rt_tpu_torch.geometry import nearest_search_detached


def _fast_trace_setup(scene, origins, directions, key, cfg, sphere_nearest):
    """(step, initial state) shared by both integrators: the state is
    (rays f32[8,N], throughput rows f32[3,N], radiance rows f32[3,N],
    alive bool[N])."""
    if scene.shade_table is None:
        raise NotImplementedError(
            "scenes without a packed shade table need the generic bounce step "
            "(materials/textures), which is not ported yet"
        )
    if scene.bvh is not None:
        raise NotImplementedError(
            "scenes with a BVH take the JAX package's BVH traversal here, which is not "
            "ported yet"
        )
    n = origins.shape[0]
    device = origins.device
    table = fast_shade.build_shade_table_diff(scene)
    seed = rng.key_seed(key)
    work = torch.arange(n, device=device)
    z = torch.zeros((n,), device=device)
    rays0 = torch.stack([*origins.T, *directions.T, z, z], dim=0)
    init = (
        rays0,
        torch.ones((3, n), device=device),
        torch.zeros((3, n), device=device),
        torch.ones((n,), dtype=torch.bool, device=device),
    )

    def step(state, depth: int, max_depth: int):
        rays, tp, rad, alive = state
        t, prim = nearest_search_detached(
            scene, rays[0:3].T, rays[3:6].T, cfg.t_min, cfg.t_max, cfg.compat, sphere_nearest
        )
        out = fast_shade.shade_bounce(scene, rays, t, prim, seed, work, depth, cfg, table=table)
        miss = alive & ~out["hit"]
        emis = alive & out["hit"] & out["emissive"]
        cont = alive & out["hit"] & out["survive"] & ~out["emissive"]
        if depth >= max_depth:
            cont = torch.zeros_like(cont)
        rad = rad + torch.where(miss[None, :], tp * torch.stack(out["sky"]), 0.0)
        rad = rad + torch.where(emis[None, :], tp * torch.stack(out["emit"]), 0.0)
        tp = torch.where(cont[None, :], tp * torch.stack(out["att"]), tp)
        rays = torch.where(cont[None, :], out["new_rays"], rays)
        return rays, tp, rad, cont

    return step, init


def trace_radiance(scene, origins, directions, key, cfg,
                   sphere_nearest=nearest_ops.sphere_nearest) -> torch.Tensor:
    """Forward radiance f32[N,3] of rays (origins, directions f32[N,3])
    under ``key`` (rng.key).  Not differentiable, as JAX's while loop is
    not: it runs without gradients."""
    with torch.no_grad():
        step, state = _fast_trace_setup(scene, origins, directions, key, cfg, sphere_nearest)
        depth = 0
        while depth <= cfg.max_depth and bool(state[3].any()):
            state = step(state, depth, cfg.max_depth)
            depth += 1
    return state[2].T


def trace_radiance_diff(scene, origins, directions, key, cfg,
                        sphere_nearest=nearest_ops.sphere_nearest) -> torch.Tensor:
    """Differentiable radiance f32[N,3]: ``cfg.diff_max_depth + 1``
    checkpointed bounces."""
    step, state = _fast_trace_setup(scene, origins, directions, key, cfg, sphere_nearest)
    for depth in range(cfg.diff_max_depth + 1):
        state = checkpoint(step, state, depth, cfg.diff_max_depth,
                           use_reentrant=False, preserve_rng_state=False)
    return state[2].T
