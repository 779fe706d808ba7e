"""Camera model and batched ray generation.

Matches the reference camera math (camera.rs:167-254): look-at basis
(u, v, w), vertical FoV in degrees, focus distance, thin-lens defocus disk
(defocus angle in degrees), viewport pixel deltas and ``pixel00_loc``.

``generate_rays`` is the camera stage of the megakernel, on tensors: Halton
jitter by sample index (optionally scrambled per pixel), and a defocus disk
drawn from the counter hash keyed on the global work id
``sample * W * H + pixel`` (purposes 21/22), as the JAX megakernel and
wavefront draw it.  ``generate_rays_keyed`` is the JAX ``Camera.generate_rays``
of the chunked and gradient paths: the same jitter, keyed on a
``jax.random``-style key, and the defocus disk drawn from ``jax.random``'s
stream.  Directions are deliberately NOT normalized,
matching the reference (camera.rs:253).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from rt_tpu_torch import rng, sampling
from rt_tpu_torch.config import CompatConfig


@dataclasses.dataclass(frozen=True)
class Camera:
    """Precomputed camera frame (reference analog: Camera struct,
    camera.rs:24-51).  Vectors are f32[3] tensors on the CPU; renderers
    read them as scalars or move them to the rays' device."""

    center: torch.Tensor
    pixel00_loc: torch.Tensor
    pixel_du: torch.Tensor
    pixel_dv: torch.Tensor
    defocus_disk_u: torch.Tensor
    defocus_disk_v: torch.Tensor
    defocus_angle: float  # degrees; <= 0 disables defocus
    image_width: int = 800
    image_height: int = 600

    @property
    def defocus_on(self) -> bool:
        return self.defocus_angle > 0.0

    def debug_ray(self, x: float, y: float) -> tuple[torch.Tensor, torch.Tensor]:
        """Center-of-pixel ray with no jitter or defocus (camera.rs:256-260;
        rt_tpu/camera.py:108-112), for the click-to-inspect probe: (origin
        f32[3], direction f32[3]) on the CPU."""
        pixel_sample = self.pixel00_loc + self.pixel_du * x + self.pixel_dv * y
        return self.center, pixel_sample - self.center


def make_camera(
    center,
    lookat,
    up,
    *,
    focus_distance: float,
    defocus_angle: float,
    image_width: int,
    image_height: int,
    vertical_fov: float,
) -> Camera:
    """Build the camera frame (camera.rs:169-227), in f32 as the JAX
    package does: w = normalize(center - lookat), u = normalize(up x w),
    v = w x u; viewport sized by vfov at the focus plane; pixel00 at the
    top-left pixel *center*."""
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32))
    center, lookat, up = f32(center), f32(lookat), f32(up)

    w = center - lookat
    w = w / torch.linalg.vector_norm(w)
    u = torch.linalg.cross(up, w)
    u = u / torch.linalg.vector_norm(u)
    v = torch.linalg.cross(w, u)

    h = np.tan(np.deg2rad(np.float32(vertical_fov)) / np.float32(2.0))
    viewport_height = np.float32(2.0) * h * np.float32(focus_distance)
    viewport_width = viewport_height * np.float32(image_width / image_height)

    viewport_u = u * float(viewport_width)
    viewport_v = -v * float(viewport_height)
    pixel_du = viewport_u / image_width
    pixel_dv = viewport_v / image_height

    vp_upper_left = center - w * float(focus_distance) - viewport_u / 2.0 - viewport_v / 2.0
    pixel00_loc = vp_upper_left + (pixel_du + pixel_dv) / 2.0

    defocus_radius = np.float32(focus_distance) * np.tan(
        np.deg2rad(np.float32(defocus_angle) / np.float32(2.0))
    )
    return Camera(
        center=center,
        pixel00_loc=pixel00_loc,
        pixel_du=pixel_du,
        pixel_dv=pixel_dv,
        defocus_disk_u=u * float(defocus_radius),
        defocus_disk_v=v * float(defocus_radius),
        defocus_angle=float(defocus_angle),
        image_width=int(image_width),
        image_height=int(image_height),
    )


def generate_rays(
    camera: Camera,
    pix: torch.Tensor,
    sample: torch.Tensor,
    seed: int,
    compat: CompatConfig = CompatConfig(),
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Camera rays for flat pixel ids ``pix`` (y * W + x) and absolute
    sample indices ``sample`` (broadcast against each other).

    Returns (origins f32[N,3], directions f32[N,3], gwork int64[N]), where
    gwork holds the u32 pattern of the int32-wrapped work id
    ``sample * W * H + pix`` that keys every random draw of the path.
    """
    device = pix.device
    pix, sample = torch.broadcast_tensors(pix.to(torch.int64), sample.to(torch.int64))
    n_global = camera.image_width * camera.image_height
    gwork = (sample * n_global + pix) & 0xFFFFFFFF
    pixel_sample = _pixel_sample(camera, pix, sample, seed, compat)
    cam = {k: getattr(camera, k).to(device) for k in ("center", "defocus_disk_u", "defocus_disk_v")}
    if camera.defocus_on:
        r = torch.sqrt(rng.uniform(seed, gwork, 0, 21))
        theta = rng.uniform(seed, gwork, 0, 22) * (2.0 * math.pi)
        dskx = (r * torch.cos(theta))[:, None]
        dsky = (r * torch.sin(theta))[:, None]
        origin = (
            cam["center"][None, :]
            + dskx * cam["defocus_disk_u"][None, :]
            + dsky * cam["defocus_disk_v"][None, :]
        )
    else:
        origin = cam["center"][None, :].expand(pixel_sample.shape)
    return origin, pixel_sample - origin, gwork


def _pixel_sample(camera: Camera, pix, sample, seed: int, compat: CompatConfig) -> torch.Tensor:
    """Jittered points f32[N,3] on the focus plane for flat pixel ids and
    sample indices (int64, same shape): Halton jitter by sample index,
    optionally rotated per pixel."""
    off_u, off_v = sampling.halton_pair(sample)
    if not compat.shared_halton_jitter:
        # Per-pixel Cranley-Patterson rotation kills the reference's moire
        # (scenes.rs:140-145); x - floor(x) is the megakernel's wrap and,
        # for x in [0, 2), exactly jnp.mod(x, 1.0).
        off_u = off_u + rng.uniform(seed, pix, 0, 5)
        off_u = off_u - torch.floor(off_u)
        off_v = off_v + rng.uniform(seed, pix, 0, 6)
        off_v = off_v - torch.floor(off_v)
    fx = (pix % camera.image_width).to(torch.float32) + off_u
    fy = (pix // camera.image_width).to(torch.float32) + off_v
    device = pix.device
    return (
        camera.pixel00_loc.to(device)[None, :]
        + fx[:, None] * camera.pixel_du.to(device)[None, :]
        + fy[:, None] * camera.pixel_dv.to(device)[None, :]
    )


def generate_rays_keyed(
    camera: Camera,
    pixel_x: torch.Tensor,
    pixel_y: torch.Tensor,
    sample_index: torch.Tensor,
    key: np.ndarray,
    compat: CompatConfig = CompatConfig(),
    work: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's ``Camera.generate_rays`` (rt_tpu/camera.py:50-106),
    the camera of ``render.render_chunk``: rays for pixel coordinates and
    sample indices under a key (rng.key).  The per-pixel jitter rotation,
    when on, is keyed on the key's hash seed and the flat pixel id; the
    thin-lens disc, when the camera defocuses, is ``jax.random``'s draw
    under fold_in(key, 0xD15C) (sampling.random_in_unit_disc), as
    rt_tpu/camera.py:97-104 draws it; ``work`` (int64[N]) gives the rays'
    rows in a larger batch, whose disc draws they take (None: rows
    0..N-1).  Returns (origins f32[N,3], directions f32[N,3]).
    """
    pix = pixel_y.to(torch.int64) * camera.image_width + pixel_x.to(torch.int64)
    device = pix.device
    pixel_sample = _pixel_sample(camera, pix, sample_index.to(torch.int64), rng.key_seed(key), compat)
    center = camera.center.to(device)[None, :]
    if camera.defocus_on:
        disk = sampling.random_in_unit_disc(rng.fold_in(key, 0xD15C), pix.shape[0], device, work)
        origin = (center + disk[:, 0:1] * camera.defocus_disk_u.to(device)[None, :]
                  + disk[:, 1:2] * camera.defocus_disk_v.to(device)[None, :])
    else:
        origin = center.expand(pixel_sample.shape)
    return origin, pixel_sample - origin
