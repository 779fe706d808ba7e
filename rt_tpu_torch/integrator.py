"""Path-tracing integrators of the chunked and gradient paths
(rt_tpu/integrator.py).

- ``trace_radiance`` (integrator.py:91-140): forward radiance with early
  exit once every path has ended, up to ``cfg.max_depth``;
- ``trace_radiance_diff`` (:143-213): differentiable radiance over exactly
  ``cfg.diff_max_depth + 1`` bounces, each bounce under
  ``torch.utils.checkpoint`` as JAX uses ``jax.checkpoint``, so the
  backward pass keeps one bounce's state at a time and recomputes the rest
  (the winner search included: each bounce launches it again in the
  backward pass).

Each has two branches, chosen as the JAX package chooses them (:105,
:160):

- the fast-shade branch, on scenes with a shade table and no BVH
  (``_fast_trace_setup``): the detached winner search (geometry, with K2),
  the differentiable t recompute, one one-hot parameter fetch over the
  differentiably re-assembled shade table, and the scalarized shading
  (fast_shade).  Draws key on the counter hash of the lane id
  ``arange(N)`` of the chunk's rays, pixel-major, and on the bounce depth;
- the generic branch, on scenes with a BVH or without a shade table
  (``_bounce_step``, :43-88): ``geometry.nearest_hit`` (the BVH walk,
  csrc/bvh_walk.cu on the card, on a BVH scene), the readable materials,
  textures and sky, and ``jax.random``'s threefry stream: bounce ``d``
  draws under fold_in(key, d), the scatter under its purposes 1-3 and the
  Russian roulette under 0x52.

Both integrators take ``work``, int64[N]: the rays' rows in a larger batch
(a shard's rows in the whole mesh's batch, parallel.py).  It replaces the
lane id ``arange(N)`` of the hash and the threefry counters ``0..N-1``, so
each row draws what it draws in that batch; None changes nothing.

Both branches drive one bounce step from both integrators, so the two
agree at equal depth.  Discrete events (hit ids, RR survival, reflect vs
refract) are decided with detached quantities; the continuous factors
carry gradients.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from rt_tpu_torch import fast_shade, materials, nearest_ops, rng, sky
from rt_tpu_torch.bvh import traverse
from rt_tpu_torch.elementwise import clip, maximum
from rt_tpu_torch.geometry import nearest_hit, nearest_search_detached
from rt_tpu_torch.scene import MAT_EMISSIVE
from rt_tpu_torch.textures import texture_value


def _generic(scene) -> bool:
    """The JAX package's branch rule: the generic bounce step on scenes
    with a BVH or without a shade table."""
    return scene.bvh is not None or scene.shade_table is None


def _bounce_step(scene, cfg, state, bounce_key, depth: int, impl: str = "auto", *,
                 sphere_nearest=nearest_ops.sphere_nearest, bvh_walk=traverse.bvh_walk,
                 work=None):
    """One generic bounce (rt_tpu/integrator.py:43-88): intersect, add the
    sky on a miss and the emission on an emissive hit, then scatter and
    Russian roulette on a hit.  ``state`` is (origins f32[N,3], directions
    f32[N,3], throughput f32[N,3], radiance f32[N,3], alive bool[N]);
    ``bounce_key`` the bounce's rng key; ``work`` the rows' ids (module
    docstring)."""
    org, dirn, throughput, radiance, alive = state
    compat = cfg.compat
    rec = nearest_hit(scene, org, dirn, cfg.t_min, cfg.t_max, compat, impl=impl,
                      sphere_nearest=sphere_nearest, bvh_walk=bvh_walk)

    unit_dir = dirn / maximum(materials.norm3(dirn), 1e-20)
    sky_rgb = sky.sky_color_toward(scene.sky, unit_dir)
    miss = alive & ~rec.hit
    radiance = radiance + torch.where(miss[:, None], throughput * sky_rgb, 0.0)

    mat_id = torch.clamp(rec.material.to(torch.int64), 0, scene.mat_kind.shape[0] - 1)
    is_emissive = scene.mat_kind[mat_id] == MAT_EMISSIVE
    emit_rgb = texture_value(scene, scene.mat_texture[mat_id], rec.uv, rec.point)
    emit_hit = alive & rec.hit & is_emissive
    radiance = radiance + torch.where(emit_hit[:, None], throughput * emit_rgb, 0.0)

    attenuation, new_dir = materials.scatter(scene, rec, dirn, bounce_key, work)
    p = clip(attenuation.amax(dim=-1), 0.0, compat.rr_clamp)
    if cfg.detach_sampling:
        p = p.detach()
    u = rng.random_uniform(rng.fold_in(bounce_key, 0x52), p.shape, device=p.device, counters=work)
    cont = alive & rec.hit & (u < p) & ~is_emissive
    if depth >= cfg.max_depth:  # camera.rs:300
        cont = torch.zeros_like(cont)

    throughput = torch.where(cont[:, None], throughput * attenuation / maximum(p, 1e-12)[:, None],
                             throughput)
    # Scale-aware origin offset along the outgoing side of the surface.
    point_scale = maximum(torch.abs(rec.point).amax(dim=-1, keepdim=True), 1.0)
    side = torch.sign(materials._dot(new_dir, rec.normal))
    new_org = rec.point + cfg.origin_offset * point_scale * side * rec.normal
    org = torch.where(cont[:, None], new_org, org)
    dirn = torch.where(cont[:, None], new_dir, dirn)
    return org, dirn, throughput, radiance, cont


def _generic_trace_setup(scene, origins, directions, key, cfg, impl, sphere_nearest, bvh_walk,
                         work):
    """(step, initial state, radiance of a state) of the generic branch:
    the state is (origins f32[N,3], directions f32[N,3], throughput
    f32[N,3], radiance f32[N,3], alive bool[N]); bounce ``depth`` draws
    under fold_in(key, depth)."""
    n, device = origins.shape[0], origins.device
    init = (origins, directions, torch.ones((n, 3), device=device),
            torch.zeros((n, 3), device=device), torch.ones((n,), dtype=torch.bool, device=device))

    def step(state, depth: int, max_depth: int):
        step_cfg = cfg if max_depth == cfg.max_depth else cfg.replace(max_depth=max_depth)
        return _bounce_step(scene, step_cfg, state, rng.fold_in(key, depth), depth, impl,
                            sphere_nearest=sphere_nearest, bvh_walk=bvh_walk, work=work)

    return step, init, lambda state: state[3]


def _fast_trace_setup(scene, origins, directions, key, cfg, sphere_nearest, work):
    """(step, initial state, radiance of a state) of the fast-shade branch:
    the state is (rays f32[8,N], throughput rows f32[3,N], radiance rows
    f32[3,N], alive bool[N])."""
    n = origins.shape[0]
    device = origins.device
    table = fast_shade.build_shade_table_diff(scene)
    seed = rng.key_seed(key)
    if work is None:
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

    return step, init, lambda state: state[2].T


def _trace_setup(scene, origins, directions, key, cfg, impl, sphere_nearest, bvh_walk, work):
    """(step, initial state, radiance of a state) of the branch the JAX
    package takes for ``scene`` (rt_tpu/integrator.py:105, :160), shared by
    both integrators: ``step(state, depth, max_depth)`` runs bounce
    ``depth``, and the state's last entry is the alive mask."""
    if _generic(scene):
        return _generic_trace_setup(scene, origins, directions, key, cfg, impl, sphere_nearest,
                                    bvh_walk, work)
    return _fast_trace_setup(scene, origins, directions, key, cfg, sphere_nearest, work)


def trace_radiance(scene, origins, directions, key, cfg,
                   sphere_nearest=nearest_ops.sphere_nearest, *,
                   bvh_walk=traverse.bvh_walk, work=None) -> torch.Tensor:
    """Forward radiance f32[N,3] of rays (origins, directions f32[N,3])
    under ``key`` (rng.key).  Not differentiable, as JAX's while loop is
    not: it runs without gradients.  ``sphere_nearest`` (K2) and
    ``bvh_walk`` choose the kernels or their plain versions (geometry);
    ``work`` gives the rays' rows (module docstring)."""
    with torch.no_grad():
        step, state, radiance = _trace_setup(scene, origins, directions, key, cfg, "auto",
                                             sphere_nearest, bvh_walk, work)
        depth = 0
        while depth <= cfg.max_depth and bool(state[-1].any()):
            state = step(state, depth, cfg.max_depth)
            depth += 1
    return radiance(state)


def trace_radiance_diff(scene, origins, directions, key, cfg,
                        sphere_nearest=nearest_ops.sphere_nearest, *,
                        bvh_walk=traverse.bvh_walk, work=None) -> torch.Tensor:
    """Differentiable radiance f32[N,3]: ``cfg.diff_max_depth + 1``
    checkpointed bounces; ``work`` as in ``trace_radiance``."""
    # "detached": the winner search under no_grad on the generic branch,
    # as rt_tpu/integrator.py:180 asks for it.
    step, state, radiance = _trace_setup(scene, origins, directions, key, cfg, "detached",
                                         sphere_nearest, bvh_walk, work)
    for depth in range(cfg.diff_max_depth + 1):
        state = checkpoint(step, state, depth, cfg.diff_max_depth,
                           use_reentrant=False, preserve_rng_state=False)
    return radiance(state)
