"""Per-primitive shade table and the scalarized bounce of the chunked and
gradient paths (the JAX package's ``rt_tpu/fast_shade.py``).

``build_shade_table`` packs every per-primitive shading parameter into one
dense f32[F_ROWS, P_pad] table at scene-build time, exactly as the JAX
package does (one column per global primitive id).  The CUDA megakernel
reads the winner's column directly (transposed to rows).

The torch functions below are the counterparts of the JAX functions of the
same names, differentiable with respect to the scene parameters:

- ``build_shade_table_diff`` re-assembles the parameter rows (fuzz, IOR,
  texture colors) from the live scene tensors;
- ``fetch_params`` fetches each lane's winner column with one one-hot
  matmul, whose backward is a deterministic matrix product;
- ``shade_bounce`` shades one bounce on component rows ([B] tensors) and
  ``_sky_rows`` evaluates the sky from the live ``SkyParams`` tensors, so
  that sun direction, turbidity and exposure get gradients.

Their arithmetic follows the JAX functions operation for operation, with
JAX's derivative rules at ties (``elementwise``).  ``shade_bounce`` also
serves the persistent wavefront, whose lanes sit at different depths and
whose intersection kernel (K3, prim_ops) hands it the winners' columns.
K1's bounce itself lives in ``megakernel.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rt_tpu_torch import color, rng, sky as sky_mod
from rt_tpu_torch.elementwise import clip, div, maximum, minimum, take_rows
from rt_tpu_torch.scene import MAT_DIELECTRIC, TEX_CHECKER, TEX_IMAGE, TEX_SOLID

BIG = 3.0e38

# shade_table row indices (F rows, one column per primitive).
F_IS_SPHERE = 0
F_AX, F_AY, F_AZ = 1, 2, 3  # sphere center / triangle vertex a
F_RADIUS = 4
F_NX, F_NY, F_NZ = 5, 6, 7  # sphere front_dir / triangle flat normal
F_MAT_KIND = 8
F_FUZZ = 9
F_IOR = 10
F_TEX_KIND = 11
F_INV_SCALE = 12
F_CE = 13  # color even/solid rgb: 13,14,15
F_CO = 16  # color odd rgb: 16,17,18
F_RECT = 19  # image rect x0,y0,w,h: 19..22
F_BX, F_BY, F_BZ = 23, 24, 25  # triangle vertex b
F_CX, F_CY, F_CZ = 26, 27, 28  # triangle vertex c
F_UVA = 29  # triangle uvs: a.u a.v b.u b.v c.u c.v -> 29..34
# Precomputed sphere-UV orientation trig (cos/sin of the facing dir's yaw
# and pitch, hittable.rs:379-391).
F_CYW, F_SYW, F_CP, F_SP = 35, 36, 37, 38
F_ROWS = 40

def build_shade_table(
    sph_center, sph_radius, sph_front, sph_mat,
    tri_a, tri_b, tri_c, tri_normal, tri_uv, tri_mat,
    mat_kind, mat_tex, mat_fuzz, mat_ior,
    tex_kind, tex_color, tex_inv_scale, tex_children, tex_rect,
    num_spheres: int,
    num_triangles: int,
) -> np.ndarray | None:
    """Pack per-primitive shading params into f32[F_ROWS, P_pad] (host).

    Returns None when a texture configuration is not expressible (checker
    whose children are not both solid colors).
    """
    p = num_spheres + num_triangles
    if p == 0:
        return None
    p_pad = -(-p // 128) * 128
    table = np.zeros((F_ROWS, p_pad), np.float32)
    ns, nt = num_spheres, num_triangles

    mids = np.concatenate([np.asarray(sph_mat[:ns]), np.asarray(tri_mat[:nt])]).astype(np.int64)
    kinds = np.asarray(mat_kind)[mids]
    tids = np.asarray(mat_tex)[mids]
    tkind = np.asarray(tex_kind)[tids]
    is_diel = kinds == MAT_DIELECTRIC

    checker = (tkind == TEX_CHECKER) & ~is_diel
    even = np.asarray(tex_children)[tids, 0]
    odd = np.asarray(tex_children)[tids, 1]
    bad = checker & (
        (np.asarray(tex_kind)[even] != TEX_SOLID) | (np.asarray(tex_kind)[odd] != TEX_SOLID)
    )
    if bad.any():
        return None

    cols = slice(0, p)
    table[F_MAT_KIND, cols] = kinds
    table[F_FUZZ, cols] = np.asarray(mat_fuzz)[mids]
    table[F_IOR, cols] = np.asarray(mat_ior)[mids]
    table[F_TEX_KIND, cols] = np.where(is_diel, TEX_SOLID, tkind)
    table[F_INV_SCALE, cols] = np.where(checker, np.asarray(tex_inv_scale)[tids], 0.0)
    solid_rgb = np.asarray(tex_color)[tids]
    even_rgb = np.where(checker[:, None], np.asarray(tex_color)[even], solid_rgb)
    even_rgb = np.where(is_diel[:, None], 1.0, even_rgb)
    table[F_CE : F_CE + 3, cols] = even_rgb.T
    table[F_CO : F_CO + 3, cols] = np.where(checker[:, None], np.asarray(tex_color)[odd], 0.0).T
    is_image = (tkind == TEX_IMAGE) & ~is_diel
    table[F_RECT : F_RECT + 4, cols] = np.where(
        is_image[:, None], np.asarray(tex_rect)[tids], 0
    ).T.astype(np.float32)

    table[F_IS_SPHERE, :ns] = 1.0
    table[F_AX : F_AZ + 1, :ns] = np.asarray(sph_center[:ns]).T
    table[F_RADIUS, :ns] = np.asarray(sph_radius[:ns])
    table[F_NX : F_NZ + 1, :ns] = np.asarray(sph_front[:ns]).T
    sfx, sfy, sfz = (np.asarray(sph_front[:ns], np.float32).T + 0.0)[:3]
    pitch = np.arctan2(sfz, np.sqrt(sfx * sfx + sfy * sfy + 1e-20))
    yaw = np.arctan2(sfy, sfx)
    table[F_CYW, :ns] = np.cos(yaw)
    table[F_SYW, :ns] = np.sin(yaw)
    table[F_CP, :ns] = np.cos(pitch)
    table[F_SP, :ns] = np.sin(pitch)
    tc = slice(ns, ns + nt)
    table[F_AX : F_AZ + 1, tc] = np.asarray(tri_a[:nt]).T
    table[F_BX : F_BZ + 1, tc] = np.asarray(tri_b[:nt]).T
    table[F_CX : F_CZ + 1, tc] = np.asarray(tri_c[:nt]).T
    table[F_NX : F_NZ + 1, tc] = np.asarray(tri_normal[:nt]).T
    table[F_UVA : F_UVA + 6, tc] = np.asarray(tri_uv[:nt]).reshape(nt, 6).T
    return table


def build_shade_table_diff(scene) -> torch.Tensor | None:
    """``scene.shade_table`` with its parameter rows re-assembled from the
    live scene tensors (fast_shade.py:160-199): the static rows (geometry,
    flags, trig) are the baked table's, and the rows of ``mat_fuzz``,
    ``mat_ior`` and ``tex_color`` are gathered so that gradients reach
    them.  A new tensor; the scene's table is not changed."""
    base = scene.shade_table
    if base is None:
        return None
    ns, nt = scene.num_spheres, scene.num_triangles
    p = ns + nt
    mids = torch.cat([scene.sph_material[:ns], scene.tri_material[:nt]]).to(torch.int64)
    kinds = scene.mat_kind[mids]
    tids = scene.mat_texture[mids].to(torch.int64)
    tkind = scene.tex_kind[tids]
    is_diel = kinds == MAT_DIELECTRIC
    checker = (tkind == TEX_CHECKER) & ~is_diel
    even = scene.tex_children[tids, 0].to(torch.int64)
    odd = scene.tex_children[tids, 1].to(torch.int64)
    solid_rgb = take_rows(scene.tex_color, tids)
    even_rgb = torch.where(checker[:, None], take_rows(scene.tex_color, even), solid_rgb)
    even_rgb = torch.where(is_diel[:, None], 1.0, even_rgb)
    odd_rgb = torch.where(checker[:, None], take_rows(scene.tex_color, odd), 0.0)
    table = base.clone()
    table[F_FUZZ, :p] = take_rows(scene.mat_fuzz, mids)
    table[F_IOR, :p] = take_rows(scene.mat_ior, mids)
    table[F_CE : F_CE + 3, :p] = even_rgb.T
    table[F_CO : F_CO + 3, :p] = odd_rgb.T
    return table


def fetch_params(table: torch.Tensor, prim: torch.Tensor) -> torch.Tensor:
    """Shading parameters of each lane's winning primitive, f32[F, B]: the
    one-hot product ``table @ onehot`` of fast_shade.py:207-222.  It is
    exact in float32 (one nonzero term per sum), and its backward is a
    matrix product, so the gradient of the table is deterministic.  The
    port builds flat scenes only (P_pad <= 2048), where the JAX package
    takes this branch too.  TF32 would round the parameters, so it must be
    off (PyTorch's default)."""
    if table.is_cuda and torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("fetch_params needs full-float32 matmuls: set "
                           "torch.set_float32_matmul_precision('highest')")
    ids = torch.arange(table.shape[1], device=table.device)
    onehot = (ids[:, None] == prim[None, :]).to(table.dtype)  # [P, B]
    return torch.matmul(table, onehot)


def shade_bounce(scene, rays, t, prim, seed: int, work, depth, cfg, table=None,
                 params=None) -> dict:
    """One scalarized bounce after intersection (fast_shade.py:225-457).

    ``rays`` f32[8, B] (origin xyz, direction xyz, two pad rows), ``t``
    f32[B] (BIG on a miss), ``prim`` int[B] global winner ids (-1 on a
    miss), ``seed`` the hash seed, ``work`` int64[B] the ids that key the
    draws, ``depth`` the bounce depth that keys them too (an int, or an int
    tensor [B] of per-lane depths), ``table`` the shade table (default
    ``scene.shade_table``).  ``params`` f32[F, B], when given, holds the
    winners' table columns already fetched (K3) and replaces the fetch.
    Returns new_rays f32[8, B], att (attenuation / p_rr rows), sky rows,
    emit rows, and bool rows emissive, hit and survive.
    """
    compat = cfg.compat
    if table is None:
        table = scene.shade_table
    ox, oy, oz = rays[0], rays[1], rays[2]
    dx, dy, dz = rays[3], rays[4], rays[5]

    hit = (prim >= 0) & (t < BIG)
    ts = torch.where(hit, t, 0.0)
    px = ox + ts * dx
    py = oy + ts * dy
    pz = oz + ts * dz

    f = params if params is not None else fetch_params(table, torch.where(hit, prim, 0))
    is_sphere = f[F_IS_SPHERE] > 0.5

    # Normal + front face (hittable.rs:340-346, 464).
    inv_r = div(1.0, maximum(f[F_RADIUS], 1e-20))
    snx = (px - f[F_AX]) * inv_r
    sny = (py - f[F_AY]) * inv_r
    snz = (pz - f[F_AZ]) * inv_r
    s_front = dx * snx + dy * sny + dz * snz < 0.0
    sgn = torch.where(s_front, 1.0, -1.0)
    snx, sny, snz = snx * sgn, sny * sgn, snz * sgn
    tnx, tny, tnz = f[F_NX], f[F_NY], f[F_NZ]
    t_front = dx * tnx + dy * tny + dz * tnz <= 0.0
    nx = torch.where(is_sphere, snx, tnx)
    ny = torch.where(is_sphere, sny, tny)
    nz = torch.where(is_sphere, snz, tnz)
    front = torch.where(is_sphere, s_front, t_front)

    # Texture: solid / checker (texture.rs:44-74).
    tex_kind = f[F_TEX_KIND]
    cells = (
        torch.floor(f[F_INV_SCALE] * px).to(torch.int32)
        + torch.floor(f[F_INV_SCALE] * py).to(torch.int32)
        + torch.floor(f[F_INV_SCALE] * pz).to(torch.int32)
    )
    use_even = (tex_kind < 0.5) | ((cells & 1) == 0)  # solid always uses CE rows
    tr = torch.where(use_even, f[F_CE + 0], f[F_CO + 0])
    tg = torch.where(use_even, f[F_CE + 1], f[F_CO + 1])
    tb = torch.where(use_even, f[F_CE + 2], f[F_CO + 2])
    if scene.has_image_textures:
        # UVs feed only the texel index, which carries no gradient, so they
        # are computed only where an image texture can use them.
        # Sphere UV from the per-primitive facing trig (hittable.rs:367-406).
        qx = f[F_CYW] * snx + f[F_SYW] * sny
        qy = -f[F_SYW] * snx + f[F_CYW] * sny
        rx = f[F_CP] * qx + f[F_SP] * snz
        ry = qy
        rz = -f[F_SP] * qx + f[F_CP] * snz
        rx = torch.where(rx * rx + ry * ry < 1e-12, 1.0, rx)
        theta = torch.arccos(clip(-rz, -1.0 + 1e-7, 1.0 - 1e-7))
        phi = torch.atan2(ry, rx) + math.pi
        s_u = torch.remainder(phi, 2.0 * math.pi) * (0.5 / math.pi)
        s_v = theta * (1.0 / math.pi)
        # Triangle barycentrics recomputed for the winner (hittable.rs:433-452).
        e1x, e1y, e1z = f[F_BX] - f[F_AX], f[F_BY] - f[F_AY], f[F_BZ] - f[F_AZ]
        e2x, e2y, e2z = f[F_CX] - f[F_AX], f[F_CY] - f[F_AY], f[F_CZ] - f[F_AZ]
        uvx = dy * e2z - dz * e2y
        uvy = dz * e2x - dx * e2z
        uvz = dx * e2y - dy * e2x
        det = e1x * uvx + e1y * uvy + e1z * uvz
        inv_det = div(1.0, torch.where(torch.abs(det) > 1e-20, det, 1.0))
        aox, aoy, aoz = ox - f[F_AX], oy - f[F_AY], oz - f[F_AZ]
        bu = (aox * uvx + aoy * uvy + aoz * uvz) * inv_det
        vvx = aoy * e1z - aoz * e1y
        vvy = aoz * e1x - aox * e1z
        vvz = aox * e1y - aoy * e1x
        bv = (dx * vvx + dy * vvy + dz * vvz) * inv_det
        ua_u, ua_v = f[F_UVA + 0], f[F_UVA + 1]
        ub_u, ub_v = f[F_UVA + 2], f[F_UVA + 3]
        uc_u, uc_v = f[F_UVA + 4], f[F_UVA + 5]
        if compat.triangle_uv_bbox_remap:  # reference quirk (hittable.rs:466-481)
            lo_u = torch.minimum(torch.minimum(ua_u, ub_u), uc_u)
            hi_u = torch.maximum(torch.maximum(ua_u, ub_u), uc_u)
            lo_v = torch.minimum(torch.minimum(ua_v, ub_v), uc_v)
            hi_v = torch.maximum(torch.maximum(ua_v, ub_v), uc_v)
            t_u = lo_u + (hi_u - lo_u) * bu
            t_v = lo_v + (hi_v - lo_v) * bv
        else:
            w0 = 1.0 - bu - bv
            t_u = w0 * ua_u + bu * ub_u + bv * uc_u
            t_v = w0 * ua_v + bu * ub_v + bv * uc_v
        u = torch.where(is_sphere, s_u, t_u)
        v = torch.where(is_sphere, s_v, t_v)
        # Nearest texel, clamped, index truncated (texture.rs:107-117).
        w_img = maximum(f[F_RECT + 2], 1.0)
        h_img = maximum(f[F_RECT + 3], 1.0)
        ix = (clip(u, 0.0, 1.0) * (w_img - 1.0)).to(torch.int64)
        iy = (clip(v, 0.0, 1.0) * (h_img - 1.0)).to(torch.int64)
        atlas = scene.atlas
        ax = torch.clamp(f[F_RECT + 0].to(torch.int64) + ix, 0, atlas.shape[1] - 1)
        ay = torch.clamp(f[F_RECT + 1].to(torch.int64) + iy, 0, atlas.shape[0] - 1)
        is_image = tex_kind > 1.5
        # A lane without an image texture fetches a texel chosen by its lane
        # id: the value is discarded below, and were all such lanes to fetch
        # texel 0, the backward's deterministic scatter would add their
        # zeros one after another (14 ms a bounce on an H100 at 90,000 lanes).
        n_texels = atlas.shape[0] * atlas.shape[1]
        texel_id = torch.where(is_image, ay * atlas.shape[1] + ax, work % n_texels)
        texel = take_rows(atlas.reshape(-1, 3), texel_id)  # [B, 3]
        tr = torch.where(is_image, texel[:, 0], tr)
        tg = torch.where(is_image, texel[:, 1], tg)
        tb = torch.where(is_image, texel[:, 2], tb)

    # Scatter draws, purposes 3..9 keyed on (lane, depth) (material.rs).
    kind = f[F_MAT_KIND]
    ux3 = rng.uniform(seed, work, depth, 3) * 2.0 - 1.0
    uy3 = rng.uniform(seed, work, depth, 4) * 2.0 - 1.0
    uz3 = rng.uniform(seed, work, depth, 5) * 2.0 - 1.0
    inv_n1 = div(1.0, maximum(torch.sqrt(ux3 * ux3 + uy3 * uy3 + uz3 * uz3), 1e-12))
    r1x, r1y, r1z = ux3 * inv_n1, uy3 * inv_n1, uz3 * inv_n1
    vx3 = rng.uniform(seed, work, depth, 6) * 2.0 - 1.0
    vy3 = rng.uniform(seed, work, depth, 7) * 2.0 - 1.0
    vz3 = rng.uniform(seed, work, depth, 8) * 2.0 - 1.0
    inv_n2 = div(1.0, maximum(torch.sqrt(vx3 * vx3 + vy3 * vy3 + vz3 * vz3), 1e-12))
    r2x, r2y, r2z = vx3 * inv_n2, vy3 * inv_n2, vz3 * inv_n2
    noise = rng.uniform(seed, work, depth, 9)

    # Lambertian: n + unit, near-zero fallback (material.rs:110-120).
    lx, ly, lz = nx + r1x, ny + r1y, nz + r1z
    near_zero = (torch.abs(lx) < 3.45e-4) & (torch.abs(ly) < 3.45e-4) & (torch.abs(lz) < 3.45e-4)
    lx = torch.where(near_zero, nx, lx)
    ly = torch.where(near_zero, ny, ly)
    lz = torch.where(near_zero, nz, lz)

    # Metal: reflect the raw direction + fuzz * unit (material.rs:94-107).
    d_dot_n = dx * nx + dy * ny + dz * nz
    fuzz = f[F_FUZZ]
    mx = dx - 2.0 * d_dot_n * nx + fuzz * r2x
    my = dy - 2.0 * d_dot_n * ny + fuzz * r2y
    mz = dz - 2.0 * d_dot_n * nz + fuzz * r2z

    # Dielectric (material.rs:150-178).
    inv_dn = div(1.0, maximum(torch.sqrt(dx * dx + dy * dy + dz * dz), 1e-20))
    udx, udy, udz = dx * inv_dn, dy * inv_dn, dz * inv_dn
    ri = torch.where(front, div(1.0, f[F_IOR]), f[F_IOR])
    cos_t = minimum(-(udx * nx + udy * ny + udz * nz), 1.0)
    sin_t = torch.sqrt(maximum(1.0 - cos_t * cos_t, 0.0))
    cannot = ri * sin_t > 1.0
    r0 = (1.0 - ri) / (1.0 + ri)  # Schlick on the active ratio (material.rs:181-186)
    r0 = r0 * r0
    omc = 1.0 - cos_t
    omc2 = omc * omc
    reflectance = r0 + (1.0 - r0) * (omc * (omc2 * omc2))  # x**5 as JAX's integer_pow
    choose_reflect = cannot | (reflectance > noise)
    rpx = (udx + nx * cos_t) * ri
    rpy = (udy + ny * cos_t) * ri
    rpz = (udz + nz * cos_t) * ri
    perp_sq = rpx * rpx + rpy * rpy + rpz * rpz
    par = -torch.sqrt(maximum(torch.abs(1.0 - perp_sq), 1e-12))
    fzx = rpx + par * nx + fuzz * r2x
    fzy = rpy + par * ny + fuzz * r2y
    fzz = rpz + par * nz + fuzz * r2z
    ud_dot_n = udx * nx + udy * ny + udz * nz
    rfx = udx - 2.0 * ud_dot_n * nx
    rfy = udy - 2.0 * ud_dot_n * ny
    rfz = udz - 2.0 * ud_dot_n * nz
    ddx = torch.where(choose_reflect, rfx, fzx)
    ddy = torch.where(choose_reflect, rfy, fzy)
    ddz = torch.where(choose_reflect, rfz, fzz)
    inv_dd = div(1.0, maximum(torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz), 1e-20))
    ddx, ddy, ddz = ddx * inv_dd, ddy * inv_dd, ddz * inv_dd

    is_lam = kind < 0.5
    is_metal = (kind > 0.5) & (kind < 1.5)
    is_diel = (kind > 1.5) & (kind < 2.5)
    is_emissive = kind > 2.5
    new_dx = torch.where(is_lam, lx, torch.where(is_metal, mx, ddx))
    new_dy = torch.where(is_lam, ly, torch.where(is_metal, my, ddy))
    new_dz = torch.where(is_lam, lz, torch.where(is_metal, mz, ddz))
    att_r = torch.where(is_diel, 1.0, tr)
    att_g = torch.where(is_diel, 1.0, tg)
    att_b = torch.where(is_diel, 1.0, tb)

    # Russian roulette, purpose 10 (camera.rs:280-293; clamped, never
    # panics).  Not detached: gradients flow through 1/p as in JAX, whose
    # max and clip split the cotangent at ties.
    p_rr = clip(torch.maximum(torch.maximum(att_r, att_g), att_b), 0.0, compat.rr_clamp)
    survive = rng.uniform(seed, work, depth, 10) < p_rr
    inv_p = div(1.0, maximum(p_rr, 1e-12))

    # New origin offset along the outgoing side, scaled with the hit point.
    scale = maximum(torch.maximum(torch.abs(px), torch.maximum(torch.abs(py), torch.abs(pz))), 1.0)
    side = torch.sign(new_dx * nx + new_dy * ny + new_dz * nz)
    off = cfg.origin_offset * scale * side
    zero = torch.zeros_like(px)
    new_rays = torch.stack(
        [px + off * nx, py + off * ny, pz + off * nz, new_dx, new_dy, new_dz, zero, zero], dim=0
    )

    sky_r, sky_g, sky_b = _sky_rows(scene.sky, dx * inv_dn, dy * inv_dn, dz * inv_dn)
    return dict(
        new_rays=new_rays,
        att=(att_r * inv_p, att_g * inv_p, att_b * inv_p),
        sky=(sky_r, sky_g, sky_b),
        emit=(tr, tg, tb),
        emissive=is_emissive,
        hit=hit,
        survive=survive,
    )


def _sky_rows(sky, dx, dy, dz):
    """``sky.sky_color_toward`` on unit direction rows, from the live
    ``SkyParams`` tensors (fast_shade.py:535-590): differentiable in the
    sun direction, turbidity and exposure.  The sky's tensors are moved to
    the rows' device, differentiably."""
    dev = dx.device
    sun_dir = sky.sun_direction.to(dev)
    sun = sun_dir / torch.sqrt(sun_dir[0] * sun_dir[0] + sun_dir[1] * sun_dir[1]
                               + sun_dir[2] * sun_dir[2])
    cos_theta = clip(dz, 0.01, 1.0)
    cos_gamma = clip(dx * sun[0] + dy * sun[1] + dz * sun[2], -1.0, 1.0)
    if sky.cos_gamma_as_angle:  # hittable.rs:86 quirk (sky.py)
        gamma = cos_gamma
        cos_gamma = torch.cos(gamma)
    else:
        gamma = torch.arccos(clip(cos_gamma, -1.0 + 1e-6, 1.0 - 1e-6))

    white_scale = div(1.0, color.uncharted2_tonemap(torch.tensor(11.2, device=dev)))
    tm = lambda x: maximum(white_scale * color.uncharted2_tonemap(1.1 * x), 0.0)
    exposure = sky.exposure.to(dev)
    if sky.hw_params is not None:  # Hosek-Wilkie mode (sky.py)
        r, g, b = sky_mod.hosek_radiance_rgb(sky.hw_params.to(dev), cos_theta, gamma, cos_gamma)
        return tm(r * exposure), tm(g * exposure), tm(b * exposure)
    turbidity = sky.turbidity.to(dev)
    theta_s = torch.arccos(clip(sun[2], 0.0, 1.0 - 1e-6))
    cos_theta_s = torch.cos(theta_s)
    coef_y, coef_x, coef_yc = sky_mod.perez_coefficients(turbidity)
    yz, xz, yz_c = sky_mod.zenith_values(turbidity, theta_s)
    one = torch.tensor(1.0, device=dev)

    def channel(coef, zenith):
        num = sky_mod._perez(coef, cos_theta, gamma, cos_gamma)
        den = sky_mod._perez(coef, one, theta_s, cos_theta_s)
        return zenith * num / den

    y_lum = maximum(channel(coef_y, yz), 0.0) * exposure
    x_c = channel(coef_x, xz)
    y_c = maximum(channel(coef_yc, yz_c), 1e-6)
    big_x = x_c / y_c * y_lum
    big_z = (1.0 - x_c - y_c) / y_c * y_lum
    m = sky_mod.XYZ_TO_SRGB.tolist()
    return tuple(
        tm(maximum(m[k][0] * big_x + m[k][1] * y_lum + m[k][2] * big_z, 0.0)) for k in range(3)
    )
