"""Megakernels: the whole bounce loop of every path in one kernel.

Port of the JAX package's megakernel (rt_tpu/megakernel.py `_mega_kernel`)
in its two modes: flat (K1, launched by `_mega_exec`) for scenes small
enough to brute-force, and clustered (K5, launched by
`_mega_exec_clustered`) for scenes with cluster tables, which it walks per
ray.  ``render_megakernel`` returns the mean radiance of a contiguous pixel
range, like the JAX function of the same name, through K1 where
``eligible`` holds and K5 where ``eligible_clustered`` holds:

- on a CUDA device it launches the hand-written CUDA kernel
  (csrc/megakernel.cu): K1 a persistent grid of warps whose lanes claim
  (pixel, sample) items as their paths finish, every sample in one launch,
  each pixel's samples held in a bounded ring of pixel slots
  (``ring_slots``) and summed in sample order by the lane that finishes
  the pixel; K5 a persistent grid of warps that walk their lanes' rays
  together and claim pixels as they finish;
- on the CPU it runs ``render_megakernel_plain``, the same computation in
  plain PyTorch, which the tests hold against the JAX package and the
  kernel is held against on the card.

The plain version's bounce (``_mega_bounce``, ``_mega_sky_rows``) is the
math the JAX package keeps inside ``_mega_kernel``: the winner's shade
column by direct gather, the sky from per-frame scalars, and the native
transcendentals the CUDA kernel uses.  Its arithmetic follows the TPU
megakernel operation for operation.  Every random draw comes from the
counter hash keyed on the global work id ``gwork = sample * W * H + pixel``
(int32 wrap-around), so images agree with the JAX megakernel and
``wavefront._render_generic`` per sample.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rt_tpu_torch import _build, cluster_ops, color, fast_shade, prim_ops, profiling, rng
from rt_tpu_torch.camera import Camera, generate_rays
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.elementwise import div
from rt_tpu_torch.fast_shade import (
    BIG, F_AX, F_AY, F_AZ, F_BX, F_BY, F_BZ, F_CE, F_CO, F_CP, F_CX, F_CY, F_CYW, F_CZ,
    F_FUZZ, F_INV_SCALE, F_IOR, F_IS_SPHERE, F_MAT_KIND, F_NX, F_NY, F_NZ, F_RADIUS,
    F_RECT, F_SP, F_SYW, F_TEX_KIND, F_UVA,
)
from rt_tpu_torch.scene import SceneData
from rt_tpu_torch.sky import XYZ_TO_SRGB, frame_scalars

# Launches of K1 (LAUNCHES) and of K5 (LAUNCHES_CLUSTERED) since the last
# reset.  Only the wrappers change them, once per launch; callers read and
# reset them to show that a run went through the kernel.
LAUNCHES = 0
LAUNCHES_CLUSTERED = 0

# Static switches (csrc/rt_common.cuh FLAG_*).
FLAG_BACKFACE_CULL = 1
FLAG_SHARED_JITTER = 2
FLAG_DEFOCUS = 4
FLAG_COS_GAMMA_AS_ANGLE = 8
FLAG_HOSEK = 16
FLAG_UV_BBOX_REMAP = 32
FLAG_IMAGES = 64

# Float parameter offsets (csrc/rt_common.cuh struct Params).
_P_PIX00, _P_DU, _P_DV, _P_DKU, _P_DKV, _P_CENTER, _P_SUN = 0, 3, 6, 9, 12, 15, 18
_P_COEF_Y, _P_COEF_X, _P_COEF_YC = 21, 26, 31
_P_ZY, _P_ZX, _P_ZYC = 36, 37, 38
_P_HW = 40
_P_T_MIN, _P_T_MAX, _P_ORIGIN_OFFSET, _P_RR_CLAMP = 70, 71, 72, 73
_P_WHITE_SCALE, _P_INV_SPP = 74, 75
_P_LEN = 80

# Uncharted2 white-point scale, folded in double precision as the JAX
# megakernel folds it (megakernel.py:135), then used as one f32.
WHITE_SCALE = 1.0 / color.uncharted2_tonemap(11.2)

# Rays per intersection chunk of the plain version: bounds its [prims, rays]
# temporaries (a few hundred MB at the cover scene's ~480 prims).
_PLAIN_CHUNK = 1 << 15

# K1's ring of pixel slots: its per-sample scratch f32[P, spp, 3] stays
# within SCRATCH_CAP bytes (5,592,405 samples, 41 for each of the 135,168
# lanes K1 keeps resident on an H100, so the slots in flight fill the card).
SCRATCH_CAP = 64 << 20

# K1's last call: its kernel launches, ring slots (P), generations (the
# rounds of the slot queue, ceil(n_pixels / P)), and ``waits``, a device
# int32 holding the steps its lanes waited for a slot or to hand one on
# (read it only off the main path: it syncs).
K1_RING = {"launches": 0, "slots": 0, "generations": 0, "waits": None}


def eligible(scene: SceneData, cfg: RenderConfig) -> bool:
    """True when the flat megakernel (K1) can render this scene: no cluster
    tables, brute-force sized and expressible in the packed shade table
    (the JAX package's `eligible`, minus its TPU memory budget)."""
    return (
        scene.shade_table is not None
        and scene.clusters is None
        and scene.num_prims <= 4096
        and scene.num_triangles <= 128
    )


def eligible_clustered(scene: SceneData, cfg: RenderConfig) -> bool:
    """True when the clustered megakernel (K5) can render this scene: it
    has cluster tables and a shade table (the JAX package's
    `eligible_clustered`, minus its TPU memory and worklist budgets)."""
    return scene.clusters is not None and scene.shade_table is not None


def _check_range(camera: Camera, spp: int, pixel_base: int, n_pixels: int | None) -> int:
    n_global = camera.image_width * camera.image_height
    n_pixels = n_global - pixel_base if n_pixels is None else int(n_pixels)
    if spp < 1 or n_pixels < 1 or pixel_base < 0 or pixel_base + n_pixels > n_global:
        raise ValueError(
            f"bad render range: spp={spp}, pixels [{pixel_base}, {pixel_base + n_pixels}) "
            f"of {n_global}"
        )
    return n_pixels


def render_megakernel(
    scene: SceneData,
    camera: Camera,
    cfg: RenderConfig,
    spp: int,
    sample_offset: int,
    seed: int,
    *,
    pixel_base: int = 0,
    n_pixels: int | None = None,
) -> torch.Tensor:
    """Mean radiance f32[n_pixels, 3] of pixels [pixel_base, pixel_base +
    n_pixels) over samples [sample_offset, sample_offset + spp), on the
    scene's device, through K1 or K5 (one launch).  ``seed`` is the hash
    seed: the JAX package's ``jax.random.key(seed)`` renders the same
    image."""
    clustered = eligible_clustered(scene, cfg)
    if not (clustered or eligible(scene, cfg)):
        raise NotImplementedError(
            "no megakernel for this scene: it needs a packed shade table, and cluster "
            "tables or at most 4096 primitives and 128 triangles"
        )
    device = scene.device
    if device.type == "cuda":
        if clustered:
            return _launch_clustered(scene, camera, cfg, spp, sample_offset, seed, pixel_base,
                                     n_pixels)
        return _launch(scene, camera, cfg, spp, sample_offset, seed, pixel_base, n_pixels)
    if device.type == "cpu":
        return render_megakernel_plain(
            scene, camera, cfg, spp, sample_offset, seed, pixel_base=pixel_base, n_pixels=n_pixels
        )
    raise ValueError(f"no megakernel for device {device}")


def _flags(scene: SceneData, camera: Camera, cfg: RenderConfig) -> int:
    c = cfg.compat
    sky = scene.sky
    return (
        FLAG_BACKFACE_CULL * bool(c.triangle_backface_cull)
        | FLAG_SHARED_JITTER * bool(c.shared_halton_jitter)
        | FLAG_DEFOCUS * bool(camera.defocus_on)
        | FLAG_COS_GAMMA_AS_ANGLE * bool(sky.cos_gamma_as_angle)
        | FLAG_HOSEK * (sky.hw_params is not None)
        | FLAG_UV_BBOX_REMAP * bool(c.triangle_uv_bbox_remap)
        | FLAG_IMAGES * bool(scene.has_image_textures)
    )


def kernel_params(scene: SceneData, camera: Camera, cfg: RenderConfig, spp: int) -> np.ndarray:
    """The kernel's per-frame float block, f32[80] (struct Params)."""
    sky = frame_scalars(scene.sky)
    pf = np.zeros(_P_LEN, np.float32)
    for off, name in (
        (_P_PIX00, "pixel00_loc"), (_P_DU, "pixel_du"), (_P_DV, "pixel_dv"),
        (_P_DKU, "defocus_disk_u"), (_P_DKV, "defocus_disk_v"), (_P_CENTER, "center"),
    ):
        pf[off : off + 3] = getattr(camera, name).numpy()
    pf[_P_SUN : _P_SUN + 3] = sky["sun"]
    pf[_P_COEF_Y : _P_COEF_Y + 5] = sky["coef_y"]
    pf[_P_COEF_X : _P_COEF_X + 5] = sky["coef_x"]
    pf[_P_COEF_YC : _P_COEF_YC + 5] = sky["coef_yc"]
    pf[_P_ZY], pf[_P_ZX], pf[_P_ZYC] = sky["zy"], sky["zx"], sky["zyc"]
    if sky["hw"] is not None:
        pf[_P_HW : _P_HW + 30] = np.asarray(sky["hw"], np.float32).reshape(-1)
    pf[_P_T_MIN], pf[_P_T_MAX] = cfg.t_min, cfg.t_max
    pf[_P_ORIGIN_OFFSET], pf[_P_RR_CLAMP] = cfg.origin_offset, cfg.compat.rr_clamp
    pf[_P_WHITE_SCALE] = WHITE_SCALE
    pf[_P_INV_SPP] = 1.0 / spp
    return pf


def ring_slots(n_pixels: int, spp: int) -> int:
    """K1's pixel slots for a launch of ``n_pixels`` pixels at ``spp``: as
    many pixels' samples, f32[P, spp, 3], as SCRATCH_CAP holds, at least one
    and at most ``n_pixels``.  Pixel i takes the slot at place i of a queue
    of P cells, which the (i - P)-th pixel summed freed.  The image does not
    depend on P: each pixel sums its samples in sample order."""
    return min(n_pixels, max(1, SCRATCH_CAP // (12 * spp)))


def _check_atlas(atlas: torch.Tensor) -> None:
    """Refuse an atlas the kernels cannot address: ``bounce()`` reads a
    texel at the int32 index 3 * (row * width + column), which wraps from
    2^31 floats on."""
    if atlas.numel() >= 2**31:
        raise ValueError(f"atlas of {atlas.numel()} floats ({'x'.join(map(str, atlas.shape))}, "
                         f"{4 * atlas.numel()} bytes): the kernels index fewer than 2^31 floats")


def _launch(scene, camera, cfg, spp, sample_offset, seed, pixel_base, n_pixels) -> torch.Tensor:
    """Wrapper of K1: checks its inputs, allocates the output, the ring's
    scratch and its zeroed state, and launches once on the current stream
    (one count of LAUNCHES; K1_RING describes the call).  Raises on any
    failure."""
    global LAUNCHES
    with profiling.span("megakernel.prepare"):
        n_pixels = _check_range(camera, spp, pixel_base, n_pixels)
        _check_atlas(scene.atlas)
        device = scene.device
        sph = _build.require(scene.sph_packed, "sph_packed", device)
        tri = _build.require(scene.tri_packed, "tri_packed", device)
        atlas = _build.require(scene.atlas, "atlas", device)
        if sph.shape[1] != 4 or tri.shape[1] != 12 or atlas.dim() != 3 or atlas.shape[2] != 3:
            raise ValueError("scene tables are not in the kernel layout")
        if sph.shape[0] < scene.num_spheres or tri.shape[0] < scene.num_triangles:
            raise ValueError("scene tables are shorter than the primitive counts")
        # The kernel reads one primitive's 40 parameters as one row.
        table = _build.require(scene.shade_table.t().contiguous(), "shade_table", device)
        if table.shape[0] < scene.num_prims or table.shape[1] != fast_shade.F_ROWS:
            raise ValueError(f"shade_table: need [>= {scene.num_prims}, {fast_shade.F_ROWS}]")
        pf = kernel_params(scene, camera, cfg, spp)
        out = torch.empty((n_pixels, 3), dtype=torch.float32, device=device)
        lib = _build.library()
        flags = _flags(scene, camera, cfg)
        n_slots = ring_slots(n_pixels, spp)
        K1_RING["waits"] = None  # frees the last call's ring state before this call's
        scratch = torch.empty((n_slots, spp, 3), dtype=torch.float32, device=device)
        # The 64-bit claim counter, the waited steps, the pixels summed; per
        # slot its stored samples; per queue cell its turn and slot; per
        # pixel its slot + 1 (csrc/megakernel.cu struct Ring).
        ring = torch.zeros((4 + 3 * n_slots + n_pixels,), dtype=torch.int32, device=device)
    with profiling.span("megakernel.launch"), torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.rt_megakernel_flat(
            pf.ctypes.data, n_pixels, pixel_base, spp, sample_offset, seed & 0xFFFFFFFF,
            camera.image_width, camera.image_width * camera.image_height, cfg.max_depth,
            scene.num_spheres, scene.num_triangles, atlas.shape[0], atlas.shape[1], flags,
            sph.data_ptr(), tri.data_ptr(), table.data_ptr(), atlas.data_ptr(), n_slots,
            scratch.data_ptr(), ring.data_ptr(), out.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"megakernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    K1_RING.update(launches=1, slots=n_slots, generations=-(-n_pixels // n_slots), waits=ring[2])
    return out


def _launch_clustered(scene, camera, cfg, spp, sample_offset, seed, pixel_base,
                      n_pixels) -> torch.Tensor:
    """Wrapper of K5: checks its inputs, allocates the output and the
    pixel-claim counter and launches on the current stream.  Raises on any
    failure."""
    global LAUNCHES_CLUSTERED
    with profiling.span("megakernel.prepare"):
        n_pixels = _check_range(camera, spp, pixel_base, n_pixels)
        _check_atlas(scene.atlas)
        device = scene.device
        cl = scene.clusters
        atlas = _build.require(scene.atlas, "atlas", device)
        tables = cluster_ops.cluster_tables(cl)
        cluster_ops.check_tables("megakernel_clustered", tables)
        if atlas.dim() != 3 or atlas.shape[2] != 3:
            raise ValueError("atlas is not in the kernel layout")
        # The kernel reads one slot's 40 parameters as one row.
        table = _build.require(cl.shade_table.t().contiguous(), "clusters.shade_table", device)
        n_slots = cl.n_sph_slots + cl.tri_slots.shape[1]
        if table.shape[0] < n_slots or table.shape[1] != fast_shade.F_ROWS:
            raise ValueError(f"clusters.shade_table: need [{fast_shade.F_ROWS}, >= {n_slots}]")
        if cl.n_sph_slots != cl.sph_slots.shape[1]:
            raise ValueError("clusters.n_sph_slots differs from the sphere slot count")
        walk_args = cluster_ops.cluster_args(tables, device, "megakernel_clustered")
        pf = kernel_params(scene, camera, cfg, spp)
        out = torch.empty((n_pixels, 3), dtype=torch.float32, device=device)
        next_pixel = torch.zeros((1,), dtype=torch.int32, device=device)
        lib = _build.library()
        flags = _flags(scene, camera, cfg)
    with profiling.span("megakernel.launch"), torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.rt_megakernel_clustered(
            pf.ctypes.data, n_pixels, pixel_base, spp, sample_offset, seed & 0xFFFFFFFF,
            camera.image_width, camera.image_width * camera.image_height, cfg.max_depth,
            atlas.shape[0], atlas.shape[1], flags,
            *walk_args, cl.n_sph_slots, table.data_ptr(), atlas.data_ptr(), out.data_ptr(),
            next_pixel.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"clustered megakernel launch failed with CUDA error {err}")
    LAUNCHES_CLUSTERED += 1
    return out


def _mega_tonemap(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(WHITE_SCALE * color.uncharted2_tonemap(1.1 * v), min=0.0)


def _mega_perez(c, cos_theta, gamma, cos_gamma):
    return (1.0 + c[0] * torch.exp(div(c[1], torch.clamp(cos_theta, min=0.01)))) * (
        1.0 + c[2] * torch.exp(c[3] * gamma) + c[4] * cos_gamma * cos_gamma
    )


def _mega_sky_rows(sky_k: dict, dx, dy, dz):
    """Tonemapped sky radiance rows toward unit direction rows, from the
    per-frame scalars of ``sky.frame_scalars`` (megakernel.py:3094-3153)."""
    sx, sy, sz = sky_k["sun"]
    cos_theta = torch.clamp(dz, 0.01, 1.0)
    cos_gamma = torch.clamp(dx * sx + dy * sy + dz * sz, -1.0, 1.0)
    if sky_k["cos_gamma_as_angle"]:  # hittable.rs:86 quirk
        gamma = cos_gamma
        cos_gamma = torch.cos(gamma)
    else:
        gamma = torch.arccos(torch.clamp(cos_gamma, -1.0 + 1e-6, 1.0 - 1e-6))
    if sky_k["hosek"]:
        sq = torch.sqrt(torch.clamp(cos_theta, min=0.0))
        out = []
        for a, b, c, d, e, f, g, h, i, sc in sky_k["hw"]:
            one_hh = float(np.float32(1.0) + np.float32(h) * np.float32(h))  # f32 rounding
            den = torch.clamp(one_hh - 2.0 * h * cos_gamma, min=1e-6)
            chi = (1.0 + cos_gamma * cos_gamma) / (den * torch.sqrt(den))
            val = (1.0 + a * torch.exp(div(b, torch.clamp(cos_theta, min=0.01)))) * (
                c + d * torch.exp(e * gamma) + f * cos_gamma * cos_gamma + g * chi + i * sq
            )
            out.append(_mega_tonemap(torch.clamp(val * sc, min=0.0)))
        return tuple(out)
    y_lum = torch.clamp(_mega_perez(sky_k["coef_y"], cos_theta, gamma, cos_gamma) * sky_k["zy"], min=0.0)
    x_c = _mega_perez(sky_k["coef_x"], cos_theta, gamma, cos_gamma) * sky_k["zx"]
    y_c = torch.clamp(_mega_perez(sky_k["coef_yc"], cos_theta, gamma, cos_gamma) * sky_k["zyc"], min=1e-6)
    big_x = x_c / y_c * y_lum
    big_z = (1.0 - x_c - y_c) / y_c * y_lum
    m = XYZ_TO_SRGB.tolist()
    return tuple(
        _mega_tonemap(torch.clamp(m[k][0] * big_x + m[k][1] * y_lum + m[k][2] * big_z, min=0.0))
        for k in range(3)
    )


def _mega_bounce(scene, rays, t, prim, seed: int, gid, depth: int, cfg, sky_k: dict,
                 table: torch.Tensor) -> dict:
    """One bounce after intersection, for rays that all sit at ``depth``.

    ``prim`` is the winner's id in ``table`` (-1 on a miss), ``gid`` the
    u32 work id of each path (int64).  Returns new_rays f32[6,B], att
    (RR-scaled attenuation rows), sky rows, emit rows, and bool rows hit,
    emissive, survive.
    """
    compat = cfg.compat
    ox, oy, oz = rays[0], rays[1], rays[2]
    dx, dy, dz = rays[3], rays[4], rays[5]
    hit = t < BIG
    prim = torch.where(hit, prim, 0)
    f = table[:, prim]  # [F, B] direct gather of the winner's column
    ts = torch.where(hit, t, 0.0)
    px = ox + ts * dx
    py = oy + ts * dy
    pz = oz + ts * dz

    # Normal + front face (hittable.rs:340-346, 464).
    is_sphere = f[F_IS_SPHERE] > 0.5
    inv_r = 1.0 / torch.clamp(f[F_RADIUS], min=1e-20)
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

    # Texture: solid / checker (texture.rs:44-74) / image.
    tex_kind = f[F_TEX_KIND]
    inv_scale = f[F_INV_SCALE]
    cells = (
        torch.floor(inv_scale * px).to(torch.int32)
        + torch.floor(inv_scale * py).to(torch.int32)
        + torch.floor(inv_scale * pz).to(torch.int32)
    )
    use_even = (tex_kind < 0.5) | ((cells & 1) == 0)
    tr = torch.where(use_even, f[F_CE + 0], f[F_CO + 0])
    tg = torch.where(use_even, f[F_CE + 1], f[F_CO + 1])
    tb = torch.where(use_even, f[F_CE + 2], f[F_CO + 2])
    if scene.has_image_textures:
        # Sphere UV from the per-primitive facing trig (hittable.rs:367-406).
        qx = f[F_CYW] * snx + f[F_SYW] * sny
        qy = -f[F_SYW] * snx + f[F_CYW] * sny
        rx = f[F_CP] * qx + f[F_SP] * snz
        ry = qy
        rz = -f[F_SP] * qx + f[F_CP] * snz
        rx = torch.where(rx * rx + ry * ry < 1e-12, 1.0, rx)
        theta = torch.arccos(torch.clamp(-rz, -1.0 + 1e-7, 1.0 - 1e-7))
        phi = torch.atan2(ry, rx) + math.pi
        two_pi = 2.0 * math.pi
        phi_m = phi - torch.floor(phi / two_pi) * two_pi
        s_u = phi_m * (0.5 / math.pi)
        s_v = theta * (1.0 / math.pi)
        # Triangle barycentrics recomputed for the winner (hittable.rs:433-452).
        e1x, e1y, e1z = f[F_BX] - f[F_AX], f[F_BY] - f[F_AY], f[F_BZ] - f[F_AZ]
        e2x, e2y, e2z = f[F_CX] - f[F_AX], f[F_CY] - f[F_AY], f[F_CZ] - f[F_AZ]
        uvx = dy * e2z - dz * e2y
        uvy = dz * e2x - dx * e2z
        uvz = dx * e2y - dy * e2x
        det = e1x * uvx + e1y * uvy + e1z * uvz
        inv_det = 1.0 / torch.where(torch.abs(det) > 1e-20, det, 1.0)
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
        w_img = torch.clamp(f[F_RECT + 2], min=1.0)
        h_img = torch.clamp(f[F_RECT + 3], min=1.0)
        ix = (torch.clamp(u, 0.0, 1.0) * (w_img - 1.0)).to(torch.int64)
        iy = (torch.clamp(v, 0.0, 1.0) * (h_img - 1.0)).to(torch.int64)
        atlas = scene.atlas
        ax = torch.clamp(f[F_RECT + 0].to(torch.int64) + ix, 0, atlas.shape[1] - 1)
        ay = torch.clamp(f[F_RECT + 1].to(torch.int64) + iy, 0, atlas.shape[0] - 1)
        texel = atlas[ay, ax]
        is_image = tex_kind > 1.5
        tr = torch.where(is_image, texel[:, 0], tr)
        tg = torch.where(is_image, texel[:, 1], tg)
        tb = torch.where(is_image, texel[:, 2], tb)

    # Scatter draws, purposes 3..9 keyed on (gid, depth) (material.rs).
    ux3 = rng.uniform(seed, gid, depth, 3) * 2.0 - 1.0
    uy3 = rng.uniform(seed, gid, depth, 4) * 2.0 - 1.0
    uz3 = rng.uniform(seed, gid, depth, 5) * 2.0 - 1.0
    inv_n1 = 1.0 / torch.clamp(torch.sqrt(ux3 * ux3 + uy3 * uy3 + uz3 * uz3), min=1e-12)
    r1x, r1y, r1z = ux3 * inv_n1, uy3 * inv_n1, uz3 * inv_n1
    vx3 = rng.uniform(seed, gid, depth, 6) * 2.0 - 1.0
    vy3 = rng.uniform(seed, gid, depth, 7) * 2.0 - 1.0
    vz3 = rng.uniform(seed, gid, depth, 8) * 2.0 - 1.0
    inv_n2 = 1.0 / torch.clamp(torch.sqrt(vx3 * vx3 + vy3 * vy3 + vz3 * vz3), min=1e-12)
    r2x, r2y, r2z = vx3 * inv_n2, vy3 * inv_n2, vz3 * inv_n2
    noise = rng.uniform(seed, gid, depth, 9)

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

    # Dielectric with optional frost (material.rs:150-178).
    a = dx * dx + dy * dy + dz * dz
    inv_dn = 1.0 / torch.clamp(torch.sqrt(a), min=1e-20)
    udx, udy, udz = dx * inv_dn, dy * inv_dn, dz * inv_dn
    ior = f[F_IOR]
    ri = torch.where(front, 1.0 / ior, ior)
    cos_t = torch.clamp(-(udx * nx + udy * ny + udz * nz), max=1.0)
    sin_t = torch.sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
    cannot = ri * sin_t > 1.0
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    omc = 1.0 - cos_t
    omc2 = omc * omc
    reflectance = r0 + (1.0 - r0) * omc2 * omc2 * omc
    choose_reflect = cannot | (reflectance > noise)
    rpx = (udx + nx * cos_t) * ri
    rpy = (udy + ny * cos_t) * ri
    rpz = (udz + nz * cos_t) * ri
    perp_sq = rpx * rpx + rpy * rpy + rpz * rpz
    par = -torch.sqrt(torch.clamp(torch.abs(1.0 - perp_sq), min=1e-12))
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
    inv_dd = 1.0 / torch.clamp(torch.sqrt(ddx * ddx + ddy * ddy + ddz * ddz), min=1e-20)
    ddx, ddy, ddz = ddx * inv_dd, ddy * inv_dd, ddz * inv_dd

    kind = f[F_MAT_KIND]
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

    # Russian roulette, purpose 10 (camera.rs:280-293; clamped).
    p_rr = torch.clamp(torch.maximum(torch.maximum(att_r, att_g), att_b), 0.0, compat.rr_clamp)
    survive = rng.uniform(seed, gid, depth, 10) < p_rr
    inv_p = 1.0 / torch.clamp(p_rr, min=1e-12)

    # New origin offset along the outgoing side, scaled with the hit point.
    scale = torch.clamp(
        torch.maximum(torch.abs(px), torch.maximum(torch.abs(py), torch.abs(pz))), min=1.0
    )
    off = cfg.origin_offset * scale * torch.sign(new_dx * nx + new_dy * ny + new_dz * nz)
    new_rays = torch.stack(
        [px + off * nx, py + off * ny, pz + off * nz, new_dx, new_dy, new_dz], dim=0
    )

    sky_r, sky_g, sky_b = _mega_sky_rows(sky_k, udx, udy, udz)
    return dict(
        new_rays=new_rays,
        att=(att_r, att_g, att_b),
        inv_p=inv_p,
        sky=(sky_r, sky_g, sky_b),
        emit=(tr, tg, tb),
        emissive=is_emissive,
        hit=hit,
        survive=survive,
    )


def flat_search(scene, cfg, rays):
    """K1's search in plain PyTorch: brute force over the packed tables
    (K3b's plain version) -> (t, global primitive id)."""
    hits = [
        prim_ops.prim_nearest_packed_plain(
            rays[:, k : k + _PLAIN_CHUNK], scene.sph_packed[: scene.num_spheres],
            scene.tri_packed[: scene.num_triangles], scene.num_spheres, cfg.t_min, cfg.t_max,
            cfg.compat.triangle_backface_cull,
        )
        for k in range(0, rays.shape[1], _PLAIN_CHUNK)
    ]
    return torch.cat([h[0] for h in hits]), torch.cat([h[1] for h in hits])


def cluster_search(scene, cfg, rays):
    """K5's search in plain PyTorch: the cluster walk (K4's plain version)
    over the whole cluster tables, ties of t to the lowest primitive id ->
    (t, slot id)."""
    cl = scene.clusters
    return cluster_ops.cluster_nearest_plain(
        rays, *cluster_ops.cluster_tables(cl), cl.n_sph_slots, cfg.t_min, cfg.t_max,
        cfg.compat.triangle_backface_cull)


def trace_paths(scene, cfg, seed: int, sky_k: dict, org, dirn, gwork, search=flat_search,
                table: torch.Tensor | None = None) -> torch.Tensor:
    """Radiance f32[N, 3] of N paths from (org, dirn) with work ids gwork:
    the megakernel's bounce loop, with finished paths compacted away.
    ``search(scene, cfg, rays)`` gives the winners' (t, id in ``table``)
    (default: K1's search and ``scene.shade_table``)."""
    table = scene.shade_table if table is None else table
    n = org.shape[0]
    out = torch.zeros((n, 3), dtype=torch.float32, device=org.device)
    live = torch.arange(n, device=org.device)
    rays = torch.cat([org.T, dirn.T], dim=0)  # [6, N] component rows
    tp = torch.ones((3, n), dtype=torch.float32, device=org.device)
    gid = gwork
    depth = 0
    while live.numel():
        t, prim = search(scene, cfg, rays)
        sh = _mega_bounce(scene, rays, t, prim, seed, gid, depth, cfg, sky_k, table)
        miss = ~sh["hit"]
        emis = sh["hit"] & sh["emissive"]
        dep = miss | emis
        deposit = torch.stack(
            [tp[k] * torch.where(miss, sh["sky"][k], sh["emit"][k]) for k in range(3)], dim=1
        )
        out[live[dep]] = deposit[dep]
        cont = sh["hit"] & sh["survive"] & ~sh["emissive"] & (depth < cfg.max_depth)
        tp = torch.stack([tp[k] * sh["att"][k] * sh["inv_p"] for k in range(3)], dim=0)[:, cont]
        rays = sh["new_rays"][:, cont]
        gid = gid[cont]
        live = live[cont]
        depth += 1
    return out


def render_megakernel_plain(
    scene: SceneData,
    camera: Camera,
    cfg: RenderConfig,
    spp: int,
    sample_offset: int,
    seed: int,
    *,
    pixel_base: int = 0,
    n_pixels: int | None = None,
    search=None,
) -> torch.Tensor:
    """The megakernel in plain PyTorch on the scene's device: the same
    arguments and result as ``render_megakernel``.  K1's search and
    per-primitive table, or for a clustered scene K5's: the cluster walk
    and the slot-ordered table.  ``search(scene, cfg, rays)``, when given,
    replaces the search and must give the same winners.  Samples are summed
    per pixel in sample order, as K1's ring and K5's lanes sum them."""
    n_pixels = _check_range(camera, spp, pixel_base, n_pixels)
    device = scene.device
    if eligible_clustered(scene, cfg):
        default, table = cluster_search, scene.clusters.shade_table
    elif eligible(scene, cfg):
        default, table = flat_search, scene.shade_table
    else:
        raise NotImplementedError("no megakernel for this scene (see render_megakernel)")
    search = default if search is None else search
    sky_k = frame_scalars(scene.sky)
    pix = torch.arange(pixel_base, pixel_base + n_pixels, device=device)
    acc = torch.zeros((n_pixels, 3), dtype=torch.float32, device=device)
    for s in range(spp):
        sample = torch.full_like(pix, sample_offset + s)
        org, dirn, gwork = generate_rays(camera, pix, sample, seed, cfg.compat)
        acc = acc + trace_paths(scene, cfg, seed, sky_k, org, dirn, gwork, search, table)
    return acc * float(np.float32(1.0 / spp))
