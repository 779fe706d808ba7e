"""K2 and K2b: the nearest sphere per ray, a hand-written CUDA kernel.

Counterpart of rt_tpu/pallas_ops.py, whose kernel body ``_kernel`` (:38)
is launched by two wrappers:

- ``sphere_nearest`` (K2, ``pallas_call`` at :123): rays as origins and
  directions f32[N,3], spheres as centers f32[S,3] and radii f32[S];
- ``sphere_nearest_packed`` (K2b, :313): rays already in the kernel
  layout f32[8,N] (rows: origin xyz, direction xyz, two pad rows; N a
  multiple of 256) and the scene's ``sph_packed`` f32[S_pad,4] (center
  xyz, radius; S_pad a multiple of 128, pad radius 0).

Both return t f32[N] (``BIG`` on a miss) and idx int32[N] (-1 on a miss),
the lowest index winning among equal t.  On a CUDA tensor each wrapper
launches the CUDA kernel of csrc/nearest.cu, one kernel for both layouts,
or raises: a persistent grid whose blocks stage the sphere table in shared
memory once and give each ray a group of lanes, each lane a stride of the
rows, the group's winner the least (t, id) key.  On a CPU tensor it runs
the plain PyTorch version
(``sphere_nearest_plain``, ``sphere_nearest_packed_plain``), which the
tests hold against the Pallas kernel in interpret mode and against which
the kernel is held on the card.  There is no backward: the callers search
on detached inputs and recompute the winner's t differentiably.
"""

from __future__ import annotations

import torch

from rt_tpu_torch import _build
from rt_tpu_torch.elementwise import div

BIG = 3.0e38
RAY_TILE = 256  # K2b's ray count is a multiple of this (pallas_ops.RAY_TILE)
SPHERE_CHUNK = 128  # and its sphere rows of this (pallas_ops.SPHERE_CHUNK)

# Launches of the CUDA kernel per wrapper since the last reset.  Only the
# wrappers change them, once per launch; callers read and reset them to
# show that a run went through the kernel.
LAUNCHES = {"sphere_nearest": 0, "sphere_nearest_packed": 0}


def sphere_nearest_packed_plain(rays: torch.Tensor, sph: torch.Tensor, t_min: float, t_max: float):
    """The plain version over [S, N] broadcasts: ``rays`` f32[>=6, N]
    (origin xyz, direction xyz rows), ``sph`` f32[S, 4].  The arithmetic is
    `_kernel`'s, operation for operation (hittable.rs:318-338)."""
    n = rays.shape[1]
    if sph.shape[0] == 0:
        return (torch.full((n,), BIG, device=rays.device),
                torch.full((n,), -1, dtype=torch.int32, device=rays.device))
    ox, oy, oz = rays[0][None], rays[1][None], rays[2][None]
    dx, dy, dz = rays[3][None], rays[4][None], rays[5][None]
    cx, cy, cz, rad = sph[:, 0:1], sph[:, 1:2], sph[:, 2:3], sph[:, 3:4]
    a = dx * dx + dy * dy + dz * dz
    inv_a = div(1.0, a)
    ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
    h = dx * ocx + dy * ocy + dz * ocz
    cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    disc = h * h - a * cc
    sd = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (h - sd) * inv_a
    t1 = (h + sd) * inv_a
    t_cand = torch.where(t0 >= t_min, t0, t1)
    ok = (disc >= 0.0) & (rad > 0.0) & (t_cand >= t_min) & (t_cand < t_max)
    t_best, idx = torch.min(torch.where(ok, t_cand, BIG), dim=0)  # first minimum
    hit = t_best < BIG
    return torch.where(hit, t_best, BIG), torch.where(hit, idx, -1).to(torch.int32)


def _pack_spheres(centers: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    return torch.cat([centers, radius[:, None]], dim=1)


def sphere_nearest_plain(org, dirn, centers, radius, t_min: float, t_max: float):
    """K2's plain version: the same arguments and result as
    ``sphere_nearest``."""
    rays = torch.cat([org.T, dirn.T], dim=0)
    return sphere_nearest_packed_plain(rays, _pack_spheres(centers, radius), t_min, t_max)


def sphere_nearest(org, dirn, centers, radius, t_min: float, t_max: float):
    """K2: nearest sphere per ray for origins and directions f32[N,3] (any
    strides), centers f32[S,3] and radii f32[S]."""
    if org.device.type == "cpu":
        return sphere_nearest_plain(org, dirn, centers, radius, t_min, t_max)
    sph = _pack_spheres(centers, radius).contiguous()
    return _launch("sphere_nearest", org, dirn, sph, t_min, t_max)


def sphere_nearest_packed(rays: torch.Tensor, sph_packed: torch.Tensor, t_min: float, t_max: float):
    """K2b: nearest sphere per ray for rays f32[8,N] (N a multiple of
    RAY_TILE) and spheres f32[S_pad,4] (S_pad a multiple of SPHERE_CHUNK)."""
    if (rays.dim() != 2 or rays.shape[0] != 8 or rays.shape[1] % RAY_TILE
            or sph_packed.dim() != 2 or sph_packed.shape[1] != 4
            or sph_packed.shape[0] % SPHERE_CHUNK):
        raise ValueError(
            f"sphere_nearest_packed: need rays [8, k*{RAY_TILE}] and spheres "
            f"[k*{SPHERE_CHUNK}, 4], got {tuple(rays.shape)} and {tuple(sph_packed.shape)}"
        )
    if rays.device.type == "cpu":
        return sphere_nearest_packed_plain(rays, sph_packed, t_min, t_max)
    return _launch("sphere_nearest_packed", rays[0:3].T, rays[3:6].T, sph_packed, t_min, t_max)


def _launch(name: str, org, dirn, sph, t_min: float, t_max: float):
    """Wrapper of the CUDA kernel: checks its inputs, allocates the outputs
    and launches on the current stream.  Raises on any failure."""
    device = org.device
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    for t, what in ((org, "org"), (dirn, "dirn")):
        if t.device != device or t.dtype != torch.float32 or t.dim() != 2 or t.shape[1] != 3:
            raise ValueError(f"{name}: {what} must be float32 [N, 3] on {device}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    n = org.shape[0]
    if dirn.shape[0] != n:
        raise ValueError(f"{name}: {n} origins but {dirn.shape[0]} directions")
    _build.require(sph, "spheres", device)
    if sph.dim() != 2 or sph.shape[1] != 4:
        raise ValueError(f"{name}: spheres must be [S, 4], got {tuple(sph.shape)}")
    t = torch.empty((n,), dtype=torch.float32, device=device)
    idx = torch.empty((n,), dtype=torch.int32, device=device)
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.rt_sphere_nearest(
            org.data_ptr(), org.stride(0), org.stride(1),
            dirn.data_ptr(), dirn.stride(0), dirn.stride(1), n,
            sph.data_ptr(), sph.shape[0], t_min, t_max, t.data_ptr(), idx.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return t, idx
