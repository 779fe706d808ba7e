"""K3 and K3b: the nearest sphere or triangle per ray, a hand-written CUDA
kernel, with K3 also fetching the winner's shade-table column.

Counterpart of rt_tpu/pallas_ops.py, whose kernel body ``_prim_kernel``
(:143) is launched by two wrappers:

- ``prim_nearest_shaded`` (K3, ``pallas_call`` at :936, body
  ``_prim_shade_kernel`` :876): the nearest hit plus the winner's column of
  the shade table, f32[F, N];
- ``prim_nearest_packed`` (K3b, :270): the nearest hit alone.

Both take rays in the kernel layout f32[8, N] (rows: origin xyz, direction
xyz, two pad rows; N a multiple of ``RAY_TILE``), the scene's
``sph_packed`` f32[S_pad, 4] (center xyz, radius; S_pad a multiple of
``SPHERE_CHUNK``, pad radius 0) and ``tri_packed`` f32[T_pad, 12] (a xyz,
e1 xyz, e2 xyz, live flag, two pad columns; T_pad a multiple of
``TRI_CHUNK``).  They return t f32[N] (``BIG`` on a miss) and the global
primitive id int32[N] (spheres first, triangles from ``n_spheres``; -1 on a
miss).  Among equal t the lowest sphere id wins, a triangle wins only when
strictly nearer, and among triangles the lowest id wins.

On a CUDA tensor each wrapper launches the kernel of csrc/prim_nearest.cu,
one kernel for both, or raises.  The kernel gives each ray a group of 8
lanes: each lane scans a stride of the sphere rows and then of the
triangle rows with the late-sqrt pair tests of csrc/brute_force.cuh, the
group takes the least (order(t), id) key of its lanes, and the block writes
its rays' results and shade columns with coalesced stores.  On a CPU
tensor a wrapper runs the plain PyTorch version
(``prim_nearest_packed_plain``, ``prim_nearest_shaded_plain``),
which the tests hold against the Pallas kernels in interpret mode and
against which the kernel is held on the card.  The megakernel's plain
version intersects through ``prim_nearest_packed_plain`` too.
"""

from __future__ import annotations

import torch

from rt_tpu_torch import _build
from rt_tpu_torch.elementwise import div
from rt_tpu_torch.nearest_ops import BIG, RAY_TILE, SPHERE_CHUNK, sphere_nearest_packed_plain

TRI_CHUNK = 64  # tri_packed's rows are a multiple of this (pallas_ops.TRI_CHUNK)
TRI_EPS = 1e-7  # det and t floor of the triangle test (hittable.rs:428, 461)

# Launches of the CUDA kernel per wrapper since the last reset.  Only the
# wrappers change them, once per launch; callers read and reset them to
# show that a run went through the kernel.
LAUNCHES = {"prim_nearest_shaded": 0, "prim_nearest_packed": 0}


def _triangle_nearest_plain(rays: torch.Tensor, tri: torch.Tensor, t_min: float, t_max: float,
                           backface_cull: bool):
    """Nearest triangle per ray over [T, N] broadcasts: Möller–Trumbore on
    the rows of ``tri`` f32[T, 12] with its live column, as ``_prim_kernel``'s
    ``tri_chunk`` computes it (hittable.rs:411-461).  Returns (t f32[N], BIG
    on a miss; local index int64[N], -1 on a miss)."""
    ox, oy, oz = rays[0][None], rays[1][None], rays[2][None]
    dx, dy, dz = rays[3][None], rays[4][None], rays[5][None]
    ax_, ay_, az_ = tri[:, 0:1], tri[:, 1:2], tri[:, 2:3]
    e1x, e1y, e1z = tri[:, 3:4], tri[:, 4:5], tri[:, 5:6]
    e2x, e2y, e2z = tri[:, 6:7], tri[:, 7:8], tri[:, 8:9]
    uvx = dy * e2z - dz * e2y
    uvy = dz * e2x - dx * e2z
    uvz = dx * e2y - dy * e2x
    det = e1x * uvx + e1y * uvy + e1z * uvz
    det_ok = det > TRI_EPS if backface_cull else torch.abs(det) > TRI_EPS
    inv_det = div(1.0, torch.where(det_ok, det, 1.0))
    aox, aoy, aoz = ox - ax_, oy - ay_, oz - az_
    u = (aox * uvx + aoy * uvy + aoz * uvz) * inv_det
    vvx = aoy * e1z - aoz * e1y
    vvy = aoz * e1x - aox * e1z
    vvz = aox * e1y - aoy * e1x
    v = (dx * vvx + dy * vvy + dz * vvz) * inv_det
    t = (e2x * vvx + e2y * vvy + e2z * vvz) * inv_det
    ok = (
        det_ok & (tri[:, 9:10] > 0.5) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
        & (u + v <= 1.0) & (t >= t_min) & (t < t_max) & (t > TRI_EPS)
    )
    t_best, idx = torch.min(torch.where(ok, t, BIG), dim=0)  # first minimum
    return t_best, torch.where(t_best < BIG, idx, -1)


def prim_nearest_packed_plain(rays, sph_packed, tri_packed, n_spheres: int, t_min: float,
                              t_max: float, backface_cull: bool = True):
    """K3b's plain version: ``rays`` f32[>=6, N] (any N), the packed tables
    (any row counts).  Spheres as ``_kernel`` (nearest_ops), then triangles,
    merged with a strictly-nearer test, as ``_prim_kernel`` merges them."""
    t_best, prim = sphere_nearest_packed_plain(rays, sph_packed, t_min, t_max)
    if tri_packed.shape[0]:
        t_t, id_t = _triangle_nearest_plain(rays, tri_packed, t_min, t_max, backface_cull)
        better = t_t < t_best
        t_best = torch.where(better, t_t, t_best)
        prim = torch.where(better, (id_t + n_spheres).to(torch.int32), prim)
    return t_best, prim


def prim_nearest_shaded_plain(rays, sph_packed, tri_packed, shade_table, n_spheres: int,
                              t_min: float, t_max: float, backface_cull: bool = True):
    """K3's plain version: K3b's plus the winners' shade-table columns
    f32[F, N], ``shade_table[:, max(prim, 0)]``, and zeros for an id past
    the table's end, which is what the Pallas kernel's one-hot product
    gives (exact: one nonzero term)."""
    t, prim = prim_nearest_packed_plain(rays, sph_packed, tri_packed, n_spheres, t_min, t_max,
                                        backface_cull)
    col = torch.clamp(prim, min=0).to(torch.int64)
    inside = col < shade_table.shape[1]
    return t, prim, torch.where(inside, shade_table[:, torch.where(inside, col, 0)], 0.0)


def _check_shapes(name: str, rays, sph_packed, tri_packed) -> None:
    if (rays.dim() != 2 or rays.shape[0] != 8 or rays.shape[1] % RAY_TILE
            or sph_packed.dim() != 2 or sph_packed.shape[1] != 4
            or sph_packed.shape[0] % SPHERE_CHUNK
            or tri_packed.dim() != 2 or tri_packed.shape[1] != 12
            or tri_packed.shape[0] % TRI_CHUNK):
        raise ValueError(
            f"{name}: need rays [8, k*{RAY_TILE}], spheres [k*{SPHERE_CHUNK}, 4] and triangles "
            f"[k*{TRI_CHUNK}, 12], got {tuple(rays.shape)}, {tuple(sph_packed.shape)} and "
            f"{tuple(tri_packed.shape)}"
        )


def prim_nearest_packed(rays, sph_packed, tri_packed, n_spheres: int, t_min: float, t_max: float,
                        backface_cull: bool = True):
    """K3b: (t f32[N], prim int32[N]) in the kernel layout."""
    _check_shapes("prim_nearest_packed", rays, sph_packed, tri_packed)
    if rays.device.type == "cpu":
        return prim_nearest_packed_plain(rays, sph_packed, tri_packed, n_spheres, t_min, t_max,
                                         backface_cull)
    t, prim, _ = _launch("prim_nearest_packed", rays, sph_packed, tri_packed, None, n_spheres,
                         t_min, t_max, backface_cull)
    return t, prim


def prim_nearest_shaded(rays, sph_packed, tri_packed, shade_table, n_spheres: int, t_min: float,
                        t_max: float, backface_cull: bool = True):
    """K3: (t f32[N], prim int32[N], params f32[F, N]) in the kernel
    layout; ``shade_table`` is f32[F, P_pad]."""
    _check_shapes("prim_nearest_shaded", rays, sph_packed, tri_packed)
    if shade_table.dim() != 2:
        raise ValueError(f"prim_nearest_shaded: shade_table must be [F, P], got "
                         f"{tuple(shade_table.shape)}")
    if rays.device.type == "cpu":
        return prim_nearest_shaded_plain(rays, sph_packed, tri_packed, shade_table, n_spheres,
                                         t_min, t_max, backface_cull)
    return _launch("prim_nearest_shaded", rays, sph_packed, tri_packed, shade_table, n_spheres,
                   t_min, t_max, backface_cull)


def _launch(name: str, rays, sph, tri, table, n_spheres: int, t_min: float, t_max: float,
            backface_cull: bool):
    """Wrapper of the CUDA kernel: checks its inputs, allocates the outputs
    and launches on the current stream.  Raises on any failure."""
    device = rays.device
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    for t, what in ((rays, "rays"), (sph, "sph_packed"), (tri, "tri_packed")):
        _build.require(t, f"{name}: {what}", device)
    n = rays.shape[1]
    t_out = torch.empty((n,), dtype=torch.float32, device=device)
    idx = torch.empty((n,), dtype=torch.int32, device=device)
    params, f_rows, p_pad = None, 0, 0
    if table is not None:
        _build.require(table, f"{name}: shade_table", device)
        f_rows, p_pad = table.shape
        params = torch.empty((f_rows, n), dtype=torch.float32, device=device)
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.rt_prim_nearest(
            rays.data_ptr(), n, sph.data_ptr(), sph.shape[0], tri.data_ptr(), tri.shape[0],
            int(n_spheres), t_min, t_max, int(bool(backface_cull)),
            None if table is None else table.data_ptr(), f_rows, p_pad,
            t_out.data_ptr(), idx.data_ptr(), None if params is None else params.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return t_out, idx, params
