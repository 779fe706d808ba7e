"""Tag-dispatched BSDF scattering on the scene's material tables
(rt_tpu/materials.py).

Reference behavior (material.rs), math as the JAX package computes it:
- Lambertian (material.rs:110-120): normal + random unit vector, falling
  back to the normal when the sum is near zero; attenuation = texture.
- Metal (material.rs:94-108): mirror reflection of the unnormalized
  incoming direction plus fuzz * random unit; no below-horizon check.
- Dielectric (material.rs:150-179): Schlick reflectance against a uniform
  draw, total internal reflection, optional frost on the refracted
  direction, attenuation (1, 1, 1), the direction normalized.

All three are evaluated for every lane and a select on the material tag
picks the result.  ``scatter_hashed`` draws from the counter hash keyed on
(seed, work id, depth), the streams ``fast_shade`` draws, so the
wavefront's two paths agree per sample; ``scatter``, the bounce of the
chunked and gradient paths on generic scenes, draws from ``jax.random``'s
stream under a per-bounce key (rng.random_uniform), as the JAX package
does.  The math is differentiable with respect to the scene's parameter
tables, with JAX's derivative rules at ties (``elementwise``) and
deterministic backward gathers (``take_rows``).
"""

from __future__ import annotations

import torch

from rt_tpu_torch import rng, sampling
from rt_tpu_torch.elementwise import div, maximum, minimum, take_rows
from rt_tpu_torch.scene import MAT_LAMBERTIAN, MAT_METAL
from rt_tpu_torch.textures import texture_value

# f32 analog of the reference's near-zero test (vec3.rs:105-111).
NEAR_ZERO_EPS = 3.45e-4


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of 3-vectors, in jnp.sum's order."""
    p = a * b
    return p[..., 0:1] + p[..., 1:2] + p[..., 2:3]


def norm3(v: torch.Tensor) -> torch.Tensor:
    """|v| over the last axis, keepdim, as jnp.linalg.norm computes it."""
    return torch.sqrt(_dot(v, v))


def reflect(d: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection (material.rs:46-51); ``d`` need not be unit."""
    return d - 2.0 * _dot(d, n) * n


def refract(unit_d: torch.Tensor, n: torch.Tensor, ratio: torch.Tensor) -> torch.Tensor:
    """Snell refraction (material.rs:53-60) of unit ``unit_d``; ``ratio``
    f32[..., 1]."""
    cos_theta = minimum(-_dot(unit_d, n), 1.0)
    r_out_perp = (unit_d + n * cos_theta) * ratio
    perp_sq = _dot(r_out_perp, r_out_perp)
    r_out_parallel = n * -torch.sqrt(maximum(torch.abs(1.0 - perp_sq), 1.0e-12))
    return r_out_parallel + r_out_perp


def schlick_reflectance(cosine: torch.Tensor, refractive_index: torch.Tensor) -> torch.Tensor:
    """Schlick's approximation (material.rs:181-186)."""
    r0 = (1.0 - refractive_index) / (1.0 + refractive_index)
    r0 = r0 * r0
    omc = 1.0 - cosine
    omc2 = omc * omc
    return r0 + (1.0 - r0) * (omc * (omc2 * omc2))  # x**5 as JAX's integer_pow


def scatter_hashed(scene, rec, dir_in: torch.Tensor, seed: int, work, depth):
    """Scatter with the counter-hash draws keyed on (seed, work, depth):
    unit vectors of purposes 1 and 2 (draws 3-8) and the Fresnel noise of
    purpose 9, as fast_shade draws them.  Returns (attenuation f32[N, 3],
    scattered direction f32[N, 3])."""
    u_lam = rng.unit_vector(seed, work, depth, 1)
    u_fuzz = rng.unit_vector(seed, work, depth, 2)
    noise = rng.uniform(seed, work, depth, 9)
    return scatter_with_randoms(scene, rec, dir_in, u_lam, u_fuzz, noise)


def scatter(scene, rec, dir_in: torch.Tensor, key, work=None):
    """Scatter with ``jax.random`` draws under the per-bounce key ``key``
    (rng.key data), as rt_tpu/materials.py:65-89 draws them: unit vectors
    under fold_in(key, 1) and fold_in(key, 2), the Fresnel noise under
    fold_in(key, 3).  ``work`` (int64[N], the rows' ids in a larger batch)
    gives each row the draws it gets in that batch; None means rows 0..N-1.
    Returns (attenuation f32[N, 3], scattered direction f32[N, 3])."""
    n, device = dir_in.shape[0], dir_in.device
    u_lam = sampling.random_unit(rng.fold_in(key, 1), n, device, work)
    u_fuzz = sampling.random_unit(rng.fold_in(key, 2), n, device, work)
    noise = rng.random_uniform(rng.fold_in(key, 3), (n,), device=device, counters=work)
    return scatter_with_randoms(scene, rec, dir_in, u_lam, u_fuzz, noise)


def scatter_with_randoms(scene, rec, dir_in, u_lam, u_fuzz, noise):
    """The BSDFs given drawn randoms: unit u_lam, u_fuzz f32[N, 3] and
    uniform noise f32[N].  ``rec`` is a geometry.HitRecord."""
    mat_id = torch.clamp(rec.material.to(torch.int64), 0, scene.mat_kind.shape[0] - 1)
    kind = scene.mat_kind[mat_id]
    fuzz = take_rows(scene.mat_fuzz, mat_id)
    ior = take_rows(scene.mat_ior, mat_id)
    tex_rgb = texture_value(scene, scene.mat_texture[mat_id], rec.uv, rec.point)
    normal = rec.normal

    lam_dir = normal + u_lam
    lam_small = torch.all(torch.abs(lam_dir) < NEAR_ZERO_EPS, dim=-1, keepdim=True)
    lam_dir = torch.where(lam_small, normal, lam_dir)

    metal_dir = reflect(dir_in, normal) + fuzz[:, None] * u_fuzz

    ri = torch.where(rec.front, div(1.0, ior), ior)[:, None]
    unit_d = dir_in / maximum(norm3(dir_in), 1.0e-20)
    cos_theta = minimum(-_dot(unit_d, normal)[:, 0], 1.0)
    sin_theta = torch.sqrt(maximum(1.0 - cos_theta * cos_theta, 0.0))
    cannot_refract = ri[:, 0] * sin_theta > 1.0
    choose_reflect = cannot_refract | (schlick_reflectance(cos_theta, ri[:, 0]) > noise)
    refracted = refract(unit_d, normal, ri) + fuzz[:, None] * u_fuzz
    diel_dir = torch.where(choose_reflect[:, None], reflect(unit_d, normal), refracted)
    diel_dir = diel_dir / maximum(norm3(diel_dir), 1.0e-20)

    is_lam = (kind == MAT_LAMBERTIAN)[:, None]
    is_metal = (kind == MAT_METAL)[:, None]
    out_dir = torch.where(is_lam, lam_dir, torch.where(is_metal, metal_dir, diel_dir))
    attenuation = torch.where(is_lam | is_metal, tex_rgb, 1.0)
    return attenuation, out_dir
