"""Persistent-wavefront integrator with ray regeneration (rt_tpu/wavefront.py).

A fixed-size pool of B lanes holds path segments in flight.  Each loop
iteration advances every active lane by one bounce; a lane whose path ended
(a sky miss, an emissive hit, absorption, Russian roulette, the depth
limit) claims the next (pixel, sample) work item and starts a new camera
ray, so the pool stays full while work remains.  A path's radiance lands
once, at its end, in a per-work-item buffer, and the pixel means are one
reduction at the end.

Two implementations share that skeleton, as in the JAX package:

- ``_render_fast``: ray state as f32[8, B] rows, shading on component
  rows (``fast_shade.shade_bounce``).  On a flat scene the intersection
  and the shade-table fetch are one launch of K3
  (``prim_ops.prim_nearest_shaded``, the CUDA kernel on the card, its
  plain version on the CPU); on a clustered scene the intersection is one
  launch of K4 (``cluster_ops.cluster_worklist_nearest``) over the whole
  cluster tables, with slot bases 0 as K5 reads them (the JAX package
  launches it once per cluster page and merges the pages' winners, which
  gives the same winners), and the winners' columns are gathered from the
  slot-ordered shade table by slot id.  Needs a shade table;
- ``_render_generic``: [B, 3] state, ``geometry.nearest_hit`` with K2 and
  the readable ``materials``/``textures``; the route for scenes without a
  shade table (a checker whose children are not solid) and the port's own
  reference for the fast path.

Every draw comes from the counter hash keyed on (seed, global work id
``sample * W * H + pixel``, depth, purpose), so the image does not depend
on the pool size, on the order of the claims or on the implementation.
The seed is the key's last word (``rng.key_seed``, JAX's
``_seed_from_key``); camera rays, with the Halton jitter (JAX's
``_camera_jitter``) and the defocus draws of purposes 21/22, come from
``camera.generate_rays``, as both JAX paths draw them.

JAX's ``lax.while_loop`` becomes a Python loop.  The host knows how many
lanes each iteration claims (the idle count and the queue position), so the
only device-to-host read per iteration is the count of lanes still active,
which decides whether to go on.  ``COUNTS`` accumulates the iterations
(one K3 launch each on a flat scene's fast path, one K4 launch on a
clustered scene's) and the ray segments intersected.
"""

from __future__ import annotations

import torch

from rt_tpu_torch import cluster_ops, fast_shade, materials, nearest_ops, prim_ops, profiling
from rt_tpu_torch import rng, sky
from rt_tpu_torch.camera import Camera, generate_rays
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.geometry import nearest_hit
from rt_tpu_torch.scene import MAT_EMISSIVE, SceneData
from rt_tpu_torch.textures import texture_value

MAX_FAST_TRIANGLES = 128  # brute-force triangle budget of the fast path
TAIL = 4096  # lanes of the fast path's second phase

# Iterations (K3 launches on the fast path) and ray segments intersected,
# accumulated over calls; callers reset them.
COUNTS = {"iterations": 0, "segments": 0}


def render_wavefront(
    scene: SceneData,
    camera: Camera,
    pixel_idx: torch.Tensor,
    cfg: RenderConfig,
    spp: int,
    sample_offset: int,
    key,
    pool_size: int = 1 << 16,
    *,
    prim_nearest=prim_ops.prim_nearest_shaded,
    cluster_nearest=cluster_ops.cluster_worklist_nearest,
) -> torch.Tensor:
    """Mean radiance f32[P, 3] per pixel of ``pixel_idx`` int[P] (y * W +
    x, on the scene's device) over samples [sample_offset, sample_offset +
    spp).  ``key`` is an rng.key; its last word seeds the hash.
    ``prim_nearest`` is K3 and ``cluster_nearest`` K4 (the fast path's
    intersection on flat and on clustered scenes)."""
    fast_ok = scene.shade_table is not None and (
        scene.clusters is not None
        or (scene.num_triangles <= MAX_FAST_TRIANGLES and scene.num_prims <= 4096))
    if fast_ok:
        return _render_fast(scene, camera, pixel_idx, cfg, spp, sample_offset, key, pool_size,
                            prim_nearest=prim_nearest, cluster_nearest=cluster_nearest)
    return _render_generic(scene, camera, pixel_idx, cfg, spp, sample_offset, key, pool_size)


def _rank_of_idle(idle: torch.Tensor) -> torch.Tensor:
    """Exclusive prefix count of idle lanes, cumsum(idle) - 1 (int64)."""
    return torch.cumsum(idle, dim=0) - 1


class _Pool:
    """Work claims of one wavefront: which lanes start which work items."""

    def __init__(self, pixel_idx: torch.Tensor, spp: int, sample_offset: int, lanes: int):
        self.pixel_idx = pixel_idx
        self.p = pixel_idx.shape[0]
        self.total = self.p * spp
        self.sample_offset = int(sample_offset)
        self.next_work = 0
        self.lane_ids = torch.arange(lanes, device=pixel_idx.device)

    def claim(self, active: torch.Tensor, n_active: int):
        """Claim work for the first idle lanes in lane order: returns (lane
        ids int64[k], work ids int64[k], pixel ids, sample ids), or None
        when nothing is claimed.  The host knows k, so nothing is read back
        from the device."""
        n_claim = min(active.shape[0] - n_active, self.total - self.next_work)
        if n_claim <= 0:
            return None
        idle = ~active
        rank = _rank_of_idle(idle)
        slot = torch.where(idle & (rank < n_claim), rank, n_claim)
        # Lane of each claim rank; every other lane writes the sentinel slot.
        lane_of = torch.empty((n_claim + 1,), dtype=torch.int64, device=active.device)
        lane_of.index_copy_(0, slot, self.lane_ids)
        work = self.next_work + torch.arange(n_claim, device=active.device)
        self.next_work += n_claim
        pix = self.pixel_idx[work % self.p].to(torch.int64)
        sample = work // self.p + self.sample_offset
        return lane_of[:n_claim], work, pix, sample

    def mean(self, acc: torch.Tensor, spp: int) -> torch.Tensor:
        """Per-pixel mean of the per-work radiance (the sentinel row cut)."""
        return acc[: self.total].reshape(spp, self.p, 3).sum(dim=0) / float(spp)


@torch.no_grad()
def _render_fast(
    scene: SceneData,
    camera: Camera,
    pixel_idx: torch.Tensor,
    cfg: RenderConfig,
    spp: int,
    sample_offset: int,
    key,
    pool_size: int = 1 << 16,
    *,
    prim_nearest=prim_ops.prim_nearest_shaded,
    cluster_nearest=cluster_ops.cluster_worklist_nearest,
) -> torch.Tensor:
    """The fast path (wavefront.py:112-467).  The pool is rounded up to
    the kernels' tile of 256 lanes; the image does not depend on its
    size."""
    device = pixel_idx.device
    tile = prim_ops.RAY_TILE
    total = pixel_idx.shape[0] * spp
    b = -(-min(pool_size, max(-(-total // tile) * tile, tile)) // tile) * tile
    pool = _Pool(pixel_idx, spp, sample_offset, b)
    seed = rng.key_seed(key)
    sph, tri, table = scene.sph_packed, scene.tri_packed, scene.shade_table
    cull = cfg.compat.triangle_backface_cull
    cl = scene.clusters
    cl_tables = None if cl is None else cluster_ops.cluster_tables(cl)

    def intersect(rays):
        """(t, winner id, the winners' shade columns f32[F, B])."""
        if cl is None:
            return prim_nearest(rays, sph, tri, table, scene.num_spheres, cfg.t_min, cfg.t_max,
                                cull)
        t, slot = cluster_nearest(rays, *cl_tables, cl.n_sph_slots, cfg.t_min, cfg.t_max, cull)
        return t, slot, cl.shade_table.index_select(1, torch.clamp(slot, min=0))

    acc = torch.zeros((pool.total + 1, 3), device=device)  # the last row is the sentinel
    rays = torch.cat([torch.zeros((3, b), device=device), torch.ones((5, b), device=device)])
    tp = torch.zeros((3, b), device=device)
    work = torch.zeros((b,), dtype=torch.int64, device=device)
    gid = torch.zeros_like(work)
    depth = torch.zeros_like(work)
    active = torch.zeros((b,), dtype=torch.bool, device=device)
    n_active = 0

    def bounce(claiming: bool):
        nonlocal rays, tp, depth, active, n_active
        if claiming:
            claimed = pool.claim(active, n_active)
            if claimed is not None:
                lanes, w_ids, pix, sample = claimed
                org, dirn, g = generate_rays(camera, pix, sample, seed, cfg.compat)
                fresh = torch.cat([org.T, dirn.T, torch.zeros((2, lanes.shape[0]), device=device)])
                rays.index_copy_(1, lanes, fresh)
                tp.index_fill_(1, lanes, 1.0)
                work.index_copy_(0, lanes, w_ids)
                gid.index_copy_(0, lanes, g)
                depth.index_fill_(0, lanes, 0)
                active.index_fill_(0, lanes, True)
                n_active += lanes.shape[0]
        COUNTS["iterations"] += 1
        COUNTS["segments"] += n_active

        t, prim, params = intersect(rays)
        out = fast_shade.shade_bounce(scene, rays, t, prim, seed, gid, depth, cfg, params=params)
        miss = active & ~out["hit"]
        emis = active & out["hit"] & out["emissive"]
        cont = active & out["hit"] & out["survive"] & (depth < cfg.max_depth) & ~out["emissive"]
        # A path deposits once, at its sky miss or emissive hit; every other
        # lane writes the sentinel row, whose value is dropped.
        dep = torch.stack([tp[k] * torch.where(miss, out["sky"][k], out["emit"][k])
                           for k in range(3)], dim=1)
        acc.index_copy_(0, torch.where(miss | emis, work, pool.total), dep)
        att = torch.stack([tp[k] * out["att"][k] for k in range(3)])
        tp = torch.where(cont[None, :], att, tp)
        rays = torch.where(cont[None, :], out["new_rays"], rays)
        depth = depth + 1
        active = cont
        n_active = int(cont.sum())  # the iteration's one read from the device

    if b >= TAIL * 4:
        # Phase 1 keeps the pool full while work remains, then bounces on
        # until the survivors fit the tail pool; phase 2 drains them there.
        while pool.next_work < pool.total or n_active > TAIL:
            with profiling.span("wavefront.iteration"):
                bounce(True)
        order = torch.argsort((~active).to(torch.int8), stable=True)[:TAIL]
        rays, tp = rays[:, order].contiguous(), tp[:, order]
        work, gid, depth, active = work[order], gid[order], depth[order], active[order]
        while n_active > 0:
            with profiling.span("wavefront.iteration"):
                bounce(False)
    else:
        while pool.next_work < pool.total or n_active > 0:
            with profiling.span("wavefront.iteration"):
                bounce(True)
    return pool.mean(acc, spp)


@torch.no_grad()
def _render_generic(
    scene: SceneData,
    camera: Camera,
    pixel_idx: torch.Tensor,
    cfg: RenderConfig,
    spp: int,
    sample_offset: int,
    key,
    pool_size: int = 1 << 16,
    *,
    sphere_nearest=nearest_ops.sphere_nearest,
) -> torch.Tensor:
    """The generic path (wavefront.py:475-607): [B, 3] lane state,
    ``geometry.nearest_hit(impl="pallas")`` with K2 (``sphere_nearest``),
    the sky, textures and BSDFs of the readable modules."""
    device = pixel_idx.device
    b = min(pool_size, max(pixel_idx.shape[0] * spp, 1))
    pool = _Pool(pixel_idx, spp, sample_offset, b)
    seed = rng.key_seed(key)
    compat = cfg.compat
    n_mat = scene.mat_kind.shape[0]

    acc = torch.zeros((pool.total + 1, 3), device=device)
    org = torch.zeros((b, 3), device=device)
    dirn = torch.ones((b, 3), device=device)
    throughput = torch.zeros((b, 3), device=device)
    work = torch.zeros((b,), dtype=torch.int64, device=device)
    gid = torch.zeros_like(work)
    depth = torch.zeros_like(work)
    active = torch.zeros((b,), dtype=torch.bool, device=device)
    n_active = 0

    while pool.next_work < pool.total or n_active > 0:
        with profiling.span("wavefront.iteration"):
            claimed = pool.claim(active, n_active)
            if claimed is not None:
                lanes, w_ids, pix, sample = claimed
                o, d, g = generate_rays(camera, pix, sample, seed, compat)
                org.index_copy_(0, lanes, o.contiguous())
                dirn.index_copy_(0, lanes, d)
                throughput.index_fill_(0, lanes, 1.0)
                work.index_copy_(0, lanes, w_ids)
                gid.index_copy_(0, lanes, g)
                depth.index_fill_(0, lanes, 0)
                active.index_fill_(0, lanes, True)
                n_active += lanes.shape[0]
            COUNTS["iterations"] += 1
            COUNTS["segments"] += n_active

            rec = nearest_hit(scene, org, dirn, cfg.t_min, cfg.t_max, compat, impl="pallas",
                              sphere_nearest=sphere_nearest)
            unit_dir = dirn / torch.clamp(materials.norm3(dirn), min=1e-20)
            sky_rgb = sky.sky_color_toward(scene.sky, unit_dir)
            miss = active & ~rec.hit

            # Emissive hits end the path with a deposit (MAT_EMISSIVE).
            mat_id = torch.clamp(rec.material.to(torch.int64), 0, n_mat - 1)
            is_emissive = scene.mat_kind[mat_id] == MAT_EMISSIVE
            emis = active & rec.hit & is_emissive
            emit_rgb = texture_value(scene, scene.mat_texture[mat_id], rec.uv, rec.point)

            attenuation, new_dir = materials.scatter_hashed(scene, rec, dirn, seed, gid, depth)
            rr_p = torch.clamp(attenuation.amax(dim=-1), 0.0, compat.rr_clamp)
            survive = rng.uniform(seed, gid, depth, 10) < rr_p
            cont = active & rec.hit & survive & (depth < cfg.max_depth) & ~is_emissive

            contribution = throughput * torch.where(miss[:, None], sky_rgb, emit_rgb)
            acc.index_copy_(0, torch.where(miss | emis, work, pool.total), contribution)
            throughput = torch.where(
                cont[:, None], throughput * attenuation / torch.clamp(rr_p, min=1e-12)[:, None],
                throughput)
            point_scale = torch.clamp(rec.point.abs().amax(dim=-1, keepdim=True), min=1.0)
            side = torch.sign((new_dir * rec.normal).sum(dim=-1, keepdim=True))
            new_org = rec.point + cfg.origin_offset * point_scale * side * rec.normal
            org = torch.where(cont[:, None], new_org, org)
            dirn = torch.where(cont[:, None], new_dir, dirn)
            depth = depth + 1
            active = cont
            n_active = int(cont.sum())
    return pool.mean(acc, spp)
