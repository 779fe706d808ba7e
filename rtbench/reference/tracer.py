"""The plain path tracer of the reference: the upstream renderer's camera,
nearest-hit search by brute force, materials, textures and sky, in plain
PyTorch on any device and in a stated float type.

It follows the upstream ``thabnir/rt`` (camera.rs, hittable.rs,
material.rs, texture.rs), as the renderer under test does, with the
renderer's f32 robustness rules (origins offset along the normal after a
bounce, scaled with the hit point) and its random streams: every draw of a
path comes from the counter hash keyed on the path's work id ``sample * W
* H + pixel`` (int32 wrap-around), the bounce depth and a purpose number,
under the frame's 32-bit seed; the camera jitters by the Halton pair of the
sample index.  A path is traced until it misses (the sky is added), hits
an emitter, fails Russian roulette or passes ``max_depth``.

``render_pixels`` gives the mean radiance of pixels over a run of samples,
each pixel's samples summed in sample order.  ``dtype`` is the type every
float step runs in: float32 for the reference, bfloat16 for the control.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rtbench.reference import rng, sky as sky_mod
from rtbench.reference.scene import Prims
from rtbench.reference.sky import _clip, _max, _min

BIG = 3.0e38
TRI_EPS = 1e-7
# Elements of one [primitives, rays] temporary of the search.
SEARCH_BUDGET = 1 << 23


def camera_frame(cam: dict, width: int, height: int) -> dict:
    """The camera's frame (camera.rs:169-227) in f32: w = normalize(center
    - lookat), u = normalize(up x w), v = w x u, the viewport sized by the
    vertical field of view at the focus distance, pixel00 at the top-left
    pixel's centre.  ``cam``: center, lookat, up, vfov, focus_distance;
    a defocused camera is not supported."""
    if float(cam.get("defocus_angle", 0.0)) > 0.0:
        raise ValueError("the reference camera has no defocus")
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    center, lookat, up = f32(cam["center"]), f32(cam["lookat"]), f32(cam["up"])
    w = center - lookat
    w = w / torch.linalg.vector_norm(w)
    u = torch.linalg.cross(up, w)
    u = u / torch.linalg.vector_norm(u)
    v = torch.linalg.cross(w, u)
    focus = float(cam["focus_distance"])
    h = np.tan(np.deg2rad(np.float32(cam["vfov"])) / np.float32(2.0))
    vp_h = np.float32(2.0) * h * np.float32(focus)
    vp_w = vp_h * np.float32(width / height)
    vp_u = u * float(vp_w)
    vp_v = -v * float(vp_h)
    du, dv = vp_u / width, vp_v / height
    upper_left = center - w * focus - vp_u / 2.0 - vp_v / 2.0
    return dict(center=center, pixel00=upper_left + (du + dv) / 2.0, du=du, dv=dv,
                width=width, height=height)


def camera_rays(frame: dict, pix: torch.Tensor, sample: torch.Tensor):
    """(origins f32[N, 3], directions f32[N, 3], work ids int64[N]) of flat
    pixel ids and sample indices."""
    dev = pix.device
    pix, sample = torch.broadcast_tensors(pix.to(torch.int64), sample.to(torch.int64))
    n_global = frame["width"] * frame["height"]
    work = (sample * n_global + pix) & rng.MASK
    ju, jv = rng.halton_pair(sample)
    fx = (pix % frame["width"]).to(torch.float32) + ju
    fy = (pix // frame["width"]).to(torch.float32) + jv
    target = (frame["pixel00"].to(dev)[None] + fx[:, None] * frame["du"].to(dev)[None]
              + fy[:, None] * frame["dv"].to(dev)[None])
    origin = frame["center"].to(dev)[None].expand(target.shape)
    return origin, target - origin, work


def _spheres(r, sph, t_min, t_max, count=None):
    """Nearest sphere per ray over a [S, N] broadcast (hittable.rs:318-338)."""
    ox, oy, oz, dx, dy, dz = (r[k][None] for k in range(6))
    cx, cy, cz, rad = sph[:, 0:1], sph[:, 1:2], sph[:, 2:3], sph[:, 3:4]
    a = dx * dx + dy * dy + dz * dz
    inv_a = torch.full_like(a, 1.0) / a
    ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
    h = dx * ocx + dy * ocy + dz * ocz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    disc = h * h - a * cc
    sd = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (h - sd) * inv_a
    t1 = (h + sd) * inv_a
    t = torch.where(t0 >= t_min, t0, t1)
    admitted = (disc >= 0.0) & (rad > 0.0)
    if count is not None:
        count["admitted"] += int(admitted.sum())
    ok = admitted & (t >= t_min) & (t < t_max)
    return torch.min(torch.where(ok, t, BIG), dim=0)


def _triangles(r, tri, t_min, t_max, cull: bool):
    """Nearest triangle per ray over a [T, N] broadcast: Moeller-Trumbore
    (hittable.rs:411-461), back faces culled when ``cull``."""
    ox, oy, oz, dx, dy, dz = (r[k][None] for k in range(6))
    ax, ay, az = tri[:, 0:1], tri[:, 1:2], tri[:, 2:3]
    e1x, e1y, e1z = tri[:, 3:4], tri[:, 4:5], tri[:, 5:6]
    e2x, e2y, e2z = tri[:, 6:7], tri[:, 7:8], tri[:, 8:9]
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    det_ok = det > TRI_EPS if cull else torch.abs(det) > TRI_EPS
    inv = torch.full_like(det, 1.0) / torch.where(det_ok, det, 1.0)
    sx, sy, sz = ox - ax, oy - ay, oz - az
    u = (sx * px + sy * py + sz * pz) * inv
    qx = sy * e1z - sz * e1y
    qy = sz * e1x - sx * e1z
    qz = sx * e1y - sy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv
    t = (e2x * qx + e2y * qy + e2z * qz) * inv
    ok = (det_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0) & (t >= t_min)
          & (t < t_max) & (t > TRI_EPS))
    return torch.min(torch.where(ok, t, BIG), dim=0)


def nearest(prims: Prims, rays: torch.Tensor, p: dict, count: dict | None = None):
    """(t [N], BIG on a miss; global primitive id int64 [N], -1 on a miss)
    for rays f32[6, N].  Among equal t the lowest sphere wins, a triangle
    wins only when strictly nearer, and among triangles the lowest id.
    ``count``, when given, adds up the ray segments searched and the
    sphere pairs admitted (discriminant >= 0)."""
    n, dev = rays.shape[1], rays.device
    if count is not None:
        count["segments"] += n
    t_best = torch.full((n,), BIG, dtype=rays.dtype, device=dev)
    best = torch.full((n,), -1, dtype=torch.int64, device=dev)
    rows = max(prims.ns, prims.nt, 1)
    ray_chunk = max(1, min(n, SEARCH_BUDGET // rows))
    tri_chunk = max(1, SEARCH_BUDGET // ray_chunk)
    for r0 in range(0, n, ray_chunk):
        r = rays[:, r0:r0 + ray_chunk]
        tb = torch.full((r.shape[1],), BIG, dtype=rays.dtype, device=dev)
        ib = torch.full((r.shape[1],), -1, dtype=torch.int64, device=dev)
        if prims.ns:
            ts, js = _spheres(r, prims.sph, p["t_min"], p["t_max"], count)
            tb, ib = ts, torch.where(ts < BIG, js, -1)
        tt = torch.full_like(tb, BIG)
        it = torch.full_like(ib, -1)
        for k0 in range(0, prims.nt, tri_chunk):
            tc, jc = _triangles(r, prims.tri[k0:k0 + tri_chunk], p["t_min"], p["t_max"], p["cull"])
            better = tc < tt
            tt = torch.where(better, tc, tt)
            it = torch.where(better, jc + k0, it)
        nearer = tt < tb
        t_best[r0:r0 + ray_chunk] = torch.where(nearer, tt, tb)
        best[r0:r0 + ray_chunk] = torch.where(nearer, it + prims.ns, ib)
    return t_best, best


def bounce(rows: dict, rays, t, prim, seed: int, gid, depth, p: dict, sky_fn, has_images: bool):
    """One bounce after the search, for every ray: the hit point, normal and
    face, the texture (solid, checker, image), the scatter of the material
    (Lambertian, metal with fuzz, dielectric with Schlick's reflectance and
    frost), Russian roulette on the largest attenuation, and the sky toward
    the unit direction.  ``rows`` are the per-primitive rows
    (``Prims.rows``), ``gid`` the paths' work ids and ``depth`` the bounce
    depth (an int or an int tensor).  ``sky_fn(dx, dy, dz)`` gives the sky
    rows.  Clamps against constants split the derivative at a tie, as a
    max/min pair does.
    ``p["fast_shade"]`` takes the operation order of the renderer's
    scalarized bounce (the wavefront's and the gradient path's) where it
    differs from the megakernel's: Schlick's fifth power, the UV's wrap,
    the throughput's product, and the sky from its live parameters.  Returns a dict of new rays [6, N], att, inv_p, sky, emit rows
    and the hit, emissive and survive masks."""
    dt = rays.dtype
    ox, oy, oz, dx, dy, dz = (rays[k] for k in range(6))
    hit = t < BIG
    prim = torch.where(hit, prim, 0)
    f = {k: v[prim] for k, v in rows.items() if k != "images"}
    ts = torch.where(hit, t, 0.0)
    px, py, pz = ox + ts * dx, oy + ts * dy, oz + ts * dz

    is_sphere = f["is_sphere"] > 0.5
    inv_r = 1.0 / _max(f["radius"], 1e-20)
    snx, sny, snz = (px - f["ax"]) * inv_r, (py - f["ay"]) * inv_r, (pz - f["az"]) * inv_r
    s_front = dx * snx + dy * sny + dz * snz < 0.0
    sgn = torch.where(s_front, 1.0, -1.0).to(dt)
    snx, sny, snz = snx * sgn, sny * sgn, snz * sgn
    tnx, tny, tnz = f["nx"], f["ny"], f["nz"]
    t_front = dx * tnx + dy * tny + dz * tnz <= 0.0
    nx = torch.where(is_sphere, snx, tnx)
    ny = torch.where(is_sphere, sny, tny)
    nz = torch.where(is_sphere, snz, tnz)
    front = torch.where(is_sphere, s_front, t_front)

    tex_kind = f["tex_kind"]
    inv_scale = f["inv_scale"]
    cells = (torch.floor(inv_scale * px).to(torch.int32) + torch.floor(inv_scale * py).to(torch.int32)
             + torch.floor(inv_scale * pz).to(torch.int32))
    use_even = (tex_kind < 0.5) | ((cells & 1) == 0)
    tr = torch.where(use_even, f["ce0"], f["co0"])
    tg = torch.where(use_even, f["ce1"], f["co1"])
    tb = torch.where(use_even, f["ce2"], f["co2"])
    if has_images:
        # Sphere UV from the texture's facing direction (hittable.rs:367-406).
        qx = f["cyw"] * snx + f["syw"] * sny
        qy = -f["syw"] * snx + f["cyw"] * sny
        rx = f["cp"] * qx + f["sp"] * snz
        ry = qy
        rz = -f["sp"] * qx + f["cp"] * snz
        rx = torch.where(rx * rx + ry * ry < 1e-12, 1.0, rx)
        theta = torch.arccos(_clip(-rz, -1.0 + 1e-7, 1.0 - 1e-7))
        phi = torch.atan2(ry, rx) + math.pi
        two_pi = 2.0 * math.pi
        if p.get("fast_shade"):
            s_u = torch.remainder(phi, two_pi) * (0.5 / math.pi)
        else:
            s_u = (phi - torch.floor(phi / two_pi) * two_pi) * (0.5 / math.pi)
        s_v = theta * (1.0 / math.pi)
        # Triangle barycentrics of the winner (hittable.rs:433-452), the UVs
        # remapped into the vertices' UV box (hittable.rs:466-481).
        e1x, e1y, e1z = f["bx"] - f["ax"], f["by"] - f["ay"], f["bz"] - f["az"]
        e2x, e2y, e2z = f["cx"] - f["ax"], f["cy"] - f["ay"], f["cz"] - f["az"]
        uvx, uvy, uvz = dy * e2z - dz * e2y, dz * e2x - dx * e2z, dx * e2y - dy * e2x
        det = e1x * uvx + e1y * uvy + e1z * uvz
        inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det, 1.0)
        aox, aoy, aoz = ox - f["ax"], oy - f["ay"], oz - f["az"]
        bu = (aox * uvx + aoy * uvy + aoz * uvz) * inv_det
        vvx, vvy, vvz = aoy * e1z - aoz * e1y, aoz * e1x - aox * e1z, aox * e1y - aoy * e1x
        bv = (dx * vvx + dy * vvy + dz * vvz) * inv_det
        ua, va, ub, vb, uc, vc = (f[f"uv{k}"] for k in range(6))
        if p["uv_bbox_remap"]:
            lo_u = torch.minimum(torch.minimum(ua, ub), uc)
            hi_u = torch.maximum(torch.maximum(ua, ub), uc)
            lo_v = torch.minimum(torch.minimum(va, vb), vc)
            hi_v = torch.maximum(torch.maximum(va, vb), vc)
            t_u, t_v = lo_u + (hi_u - lo_u) * bu, lo_v + (hi_v - lo_v) * bv
        else:
            w0 = 1.0 - bu - bv
            t_u, t_v = w0 * ua + bu * ub + bv * uc, w0 * va + bu * vb + bv * vc
        u = torch.where(is_sphere, s_u, t_u)
        v = torch.where(is_sphere, s_v, t_v)
        w_img = _max(f["rw"].to(dt), 1.0)
        h_img = _max(f["rh"].to(dt), 1.0)
        ix = (_clip(u, 0.0, 1.0) * (w_img - 1.0)).to(torch.int64)
        iy = (_clip(v, 0.0, 1.0) * (h_img - 1.0)).to(torch.int64)
        images = rows["images"]
        ax = torch.clamp(f["rx0"] + ix, 0, images.shape[1] - 1)
        ay = torch.clamp(f["ry0"] + iy, 0, images.shape[0] - 1)
        texel = images[ay, ax]
        is_image = tex_kind > 1.5
        tr = torch.where(is_image, texel[:, 0], tr)
        tg = torch.where(is_image, texel[:, 1], tg)
        tb = torch.where(is_image, texel[:, 2], tb)

    draw = lambda purpose: rng.uniform(seed, gid, depth, purpose).to(dt)
    ux, uy, uz = (draw(k) * 2.0 - 1.0 for k in (3, 4, 5))
    inv1 = 1.0 / _max(torch.sqrt(ux * ux + uy * uy + uz * uz), 1e-12)
    r1x, r1y, r1z = ux * inv1, uy * inv1, uz * inv1
    vx, vy, vz = (draw(k) * 2.0 - 1.0 for k in (6, 7, 8))
    inv2 = 1.0 / _max(torch.sqrt(vx * vx + vy * vy + vz * vz), 1e-12)
    r2x, r2y, r2z = vx * inv2, vy * inv2, vz * inv2
    noise = draw(9)

    # Lambertian: normal + unit vector, the normal where that is near zero.
    lx, ly, lz = nx + r1x, ny + r1y, nz + r1z
    near_zero = (torch.abs(lx) < 3.45e-4) & (torch.abs(ly) < 3.45e-4) & (torch.abs(lz) < 3.45e-4)
    lx, ly, lz = (torch.where(near_zero, n_, l_) for n_, l_ in ((nx, lx), (ny, ly), (nz, lz)))

    # Metal: the mirror of the raw direction plus fuzz times a unit vector.
    d_dot_n = dx * nx + dy * ny + dz * nz
    fuzz = f["fuzz"]
    mx = dx - 2.0 * d_dot_n * nx + fuzz * r2x
    my = dy - 2.0 * d_dot_n * ny + fuzz * r2y
    mz = dz - 2.0 * d_dot_n * nz + fuzz * r2z

    # Dielectric: refract unless total internal reflection or Schlick says
    # reflect; frost adds fuzz to the refracted ray.
    inv_dn = 1.0 / _max(torch.sqrt(dx * dx + dy * dy + dz * dz), 1e-20)
    udx, udy, udz = dx * inv_dn, dy * inv_dn, dz * inv_dn
    ior = f["ior"]
    ri = torch.where(front, 1.0 / ior, ior)
    cos_t = _min(-(udx * nx + udy * ny + udz * nz), 1.0)
    sin_t = torch.sqrt(_max(1.0 - cos_t * cos_t, 0.0))
    cannot = ri * sin_t > 1.0
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    omc = 1.0 - cos_t
    omc2 = omc * omc
    if p.get("fast_shade"):
        reflectance = r0 + (1.0 - r0) * (omc * (omc2 * omc2))
    else:
        reflectance = r0 + (1.0 - r0) * omc2 * omc2 * omc
    reflect = cannot | (reflectance > noise)
    rpx, rpy, rpz = (udx + nx * cos_t) * ri, (udy + ny * cos_t) * ri, (udz + nz * cos_t) * ri
    par = -torch.sqrt(_max(torch.abs(1.0 - (rpx * rpx + rpy * rpy + rpz * rpz)), 1e-12))
    ud_dot_n = udx * nx + udy * ny + udz * nz
    ddx = torch.where(reflect, udx - 2.0 * ud_dot_n * nx, rpx + par * nx + fuzz * r2x)
    ddy = torch.where(reflect, udy - 2.0 * ud_dot_n * ny, rpy + par * ny + fuzz * r2y)
    ddz = torch.where(reflect, udz - 2.0 * ud_dot_n * nz, rpz + par * nz + fuzz * r2z)
    inv_dd = 1.0 / _max(torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz), 1e-20)
    ddx, ddy, ddz = ddx * inv_dd, ddy * inv_dd, ddz * inv_dd

    kind = f["kind"]
    is_lam = kind < 0.5
    is_metal = (kind > 0.5) & (kind < 1.5)
    is_diel = (kind > 1.5) & (kind < 2.5)
    new_dx = torch.where(is_lam, lx, torch.where(is_metal, mx, ddx))
    new_dy = torch.where(is_lam, ly, torch.where(is_metal, my, ddy))
    new_dz = torch.where(is_lam, lz, torch.where(is_metal, mz, ddz))
    one = torch.ones_like(tr)
    att = tuple(torch.where(is_diel, one, c) for c in (tr, tg, tb))

    p_rr = _clip(torch.maximum(torch.maximum(att[0], att[1]), att[2]), 0.0, p["rr_clamp"])
    survive = draw(10) < p_rr
    inv_p = 1.0 / _max(p_rr, 1e-12)

    scale = _max(torch.maximum(torch.abs(px), torch.maximum(torch.abs(py), torch.abs(pz))), 1.0)
    off = p["origin_offset"] * scale * torch.sign(new_dx * nx + new_dy * ny + new_dz * nz)
    new_rays = torch.stack([px + off * nx, py + off * ny, pz + off * nz, new_dx, new_dy, new_dz])
    return dict(new_rays=new_rays, att=att, inv_p=inv_p, sky=sky_fn(udx, udy, udz),
                emit=(tr, tg, tb), emissive=kind > 2.5, hit=hit, survive=survive)


def trace(prims: Prims, rows: dict, p: dict, seed, sky_fn, org, dirn, gid,
          count: dict | None = None) -> torch.Tensor:
    """Radiance [N, 3] of N camera rays with work ids ``gid`` under the
    32-bit hash ``seed`` (an int, or an int64 tensor [N] of per-path
    seeds); finished paths are compacted away after every bounce."""
    n, dev = org.shape[0], org.device
    out = torch.zeros((n, 3), dtype=prims.dtype, device=dev)
    live = torch.arange(n, device=dev)
    rays = torch.cat([org.T, dirn.T]).to(prims.dtype)
    tp = torch.ones((3, n), dtype=prims.dtype, device=dev)
    per_path = isinstance(seed, torch.Tensor)
    depth = 0
    while live.numel():
        t, prim = nearest(prims, rays, p, count)
        sh = bounce(rows, rays, t, prim, seed, gid, depth, p, sky_fn, prims.has_images)
        miss = ~sh["hit"]
        dep = miss | (sh["hit"] & sh["emissive"])
        deposit = torch.stack([tp[k] * torch.where(miss, sh["sky"][k], sh["emit"][k])
                               for k in range(3)], dim=1)
        out[live[dep]] = deposit[dep]
        cont = sh["hit"] & sh["survive"] & ~sh["emissive"] & (depth < p["max_depth"])
        if p.get("fast_shade"):
            tp = torch.stack([tp[k] * (sh["att"][k] * sh["inv_p"]) for k in range(3)])[:, cont]
        else:
            tp = torch.stack([tp[k] * sh["att"][k] * sh["inv_p"] for k in range(3)])[:, cont]
        rays, gid, live = sh["new_rays"][:, cont], gid[cont], live[cont]
        if per_path:
            seed = seed[cont]
        depth += 1
    return out


def radiance(prims: Prims, frame: dict, p: dict, sky: dict, pix: torch.Tensor,
             sample: torch.Tensor, seed: torch.Tensor, count: dict | None = None) -> torch.Tensor:
    """Radiance [N, 3] (in ``prims.dtype``) of N paths, each given by its
    flat pixel id, sample index and 32-bit hash seed (int64 tensors [N]);
    ``count`` as for ``nearest``."""
    if p.get("fast_shade"):
        sun = torch.tensor(sky.get("sun", [0.0, 0.0, 1.0]), dtype=torch.float32)
        turb, expo = torch.tensor(float(sky["turbidity"])), torch.tensor(float(sky["exposure"]))
        sky_fn = lambda dx, dy, dz: sky_mod.live_rows(sky, sun, turb, expo, dx, dy, dz)
    else:
        sk = sky_mod.frame_scalars(sky)
        sky_fn = lambda dx, dy, dz: sky_mod.rows(sk, dx, dy, dz)
    org, dirn, gid = camera_rays(frame, pix, sample)
    return trace(prims, prims.rows(), p, seed & rng.MASK, sky_fn, org, dirn, gid, count)


def pixel_means(rad: torch.Tensor, spp: int, divide: bool = False) -> torch.Tensor:
    """Per-pixel means of path radiance laid out pixel-major [P * spp, 3]:
    each pixel's samples summed in sample order, then times f32(1 / spp)
    (or divided by spp when ``divide``)."""
    r = rad.reshape(-1, spp, 3)
    acc = r[:, 0]
    for s in range(1, spp):
        acc = acc + r[:, s]
    return acc / float(spp) if divide else acc * float(np.float32(1.0 / spp))


def render_pixels(prims: Prims, frame: dict, p: dict, sky: dict, pix: torch.Tensor, spp: int,
                  sample_offset: int, seed: int) -> torch.Tensor:
    """Mean radiance [P, 3] of flat pixel ids ``pix`` over samples
    [sample_offset, sample_offset + spp) under the 32-bit ``seed``."""
    pp = pix.to(torch.int64).repeat_interleave(spp)
    sample = torch.arange(spp, device=pix.device).repeat(pix.shape[0]) + sample_offset
    rad = radiance(prims, frame, p, sky, pp, sample, torch.full_like(pp, int(seed) & rng.MASK))
    return pixel_means(rad, spp)


def render_params(cfg: dict, fast_shade: bool = False) -> dict:
    """The tracer's settings from a configuration's ``render`` block, with
    the upstream's defaults: t in [1e-3, 3e38), the origin offset 1e-4,
    Russian roulette's probability clamped to 1, back faces culled, the
    triangle UVs remapped into their box."""
    return dict(max_depth=int(cfg["max_depth"]), t_min=float(cfg.get("t_min", 1.0e-3)),
                t_max=float(cfg.get("t_max", 3.0e38)),
                origin_offset=float(cfg.get("origin_offset", 1.0e-4)),
                rr_clamp=float(cfg.get("rr_clamp", 1.0)), cull=bool(cfg.get("cull", True)),
                uv_bbox_remap=bool(cfg.get("uv_bbox_remap", True)), fast_shade=fast_shade)
