"""Counter-based RNG of the render hot path, bit-exact with ``rt_tpu.rng``.

A stateless murmur3-style hash over a Weyl-sequence combination of
(seed, work_id, depth, purpose):

    bits = mix(seed ^ mix(work ^ mix(depth ^ mix(purpose))))

Paths key on the global (sample, pixel) work id, so an image does not
depend on how the work is scheduled, and the port draws exactly the numbers
the JAX package draws.

torch has little uint32 arithmetic, so values travel as int64 holding the
u32 bit pattern (0 <= x < 2**32).  Products are split into 16-bit halves so
no intermediate leaves int64's range.

The host-side keys of the JAX package's public API (``jax.random.key``,
``fold_in``) are here too, as ``key``, ``fold_in`` and ``key_seed``: a key
is the numpy ``uint32[2]`` that ``jax.random.key_data`` returns, and
``fold_in`` is threefry-2x32, so the hash seeds derived from a key are the
JAX package's bit for bit.

So is ``jax.random``'s own stream, which the chunked and gradient paths
draw on generic scenes (materials.scatter, the Russian roulette of
integrator._bounce_step, the defocus disc of camera.generate_rays_keyed):
``random_bits``, ``random_uniform`` and ``split`` give ``jax.random.bits``,
``jax.random.uniform`` and ``jax.random.split`` bit for bit, with JAX's
default partitionable threefry: draw ``i`` of a shape is threefry-2x32 of
the counter pair (0, i) under the key, vectorized over a tensor of
counters on the caller's device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_WEYL = 0x9E3779B9
_INV_24 = 5.9604645e-8  # 2^-24 as the f32 the JAX package multiplies by


_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0: int, k1: int, x0, x1):
    """Threefry-2x32 with 20 rounds (Salmon et al. 2011), as
    ``jax.random``'s default implementation computes it, on one counter
    pair of python ints or elementwise on int64 tensors of u32 patterns."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & _MASK, (x1 + ks[1]) & _MASK
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.key_data(jax.random.key(seed))`` with 64-bit values off
    (JAX's default): the seed wraps to int32, giving (0, seed mod 2**32)."""
    return np.array([0, int(seed) & _MASK], np.uint32)


def fold_in(k: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: threefry of the counter (0, data) under the
    key."""
    return np.array(_threefry2x32(int(k[0]), int(k[1]), 0, int(data) & _MASK), np.uint32)


def key_seed(k: np.ndarray) -> int:
    """The 32-bit hash seed the JAX package derives from a key: the last
    word of its data (wavefront._seed_from_key)."""
    return int(k[-1])


def split(k: np.ndarray, n: int = 2) -> list[np.ndarray]:
    """``jax.random.split(k, n)``: key j is threefry of the counter (0, j)."""
    return [np.array(_threefry2x32(int(k[0]), int(k[1]), 0, j), np.uint32) for j in range(n)]


def random_bits(k: np.ndarray, n: int, device=None, counters=None) -> torch.Tensor:
    """``jax.random.bits(k, (n,), uint32)`` as int64 u32 patterns: x0 ^ x1
    of threefry of the counters (0, i), i < n.  ``counters`` (int64[n],
    on ``device``) replaces ``arange(n)``: the draws a batch's rows get as
    rows ``counters`` of a larger batch (the high word of a counter goes to
    x0, as JAX splits its 64-bit iota)."""
    if counters is None:
        x1 = torch.arange(n, dtype=torch.int64, device=device)
        x0 = torch.zeros_like(x1)
    else:
        x0, x1 = (counters >> 32) & _MASK, counters & _MASK
    x0, x1 = _threefry2x32(int(k[0]), int(k[1]), x0, x1)
    return x0 ^ x1


def random_uniform(k: np.ndarray, shape, lo: float = 0.0, hi: float = 1.0,
                   device=None, counters=None) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, lo, hi)``: the top 23 bits as
    a mantissa in [1, 2), minus 1, scaled by f32(hi) - f32(lo), shifted by
    lo, and floored at lo (row-major draws; ``counters`` as in
    ``random_bits``, one a value, row-major)."""
    shape = tuple(shape)
    bits = random_bits(k, math.prod(shape), device, counters)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo32, span = np.float32(lo), np.float32(hi) - np.float32(lo)
    out = torch.clamp(f * float(span) + float(lo32), min=float(lo32))
    return out.reshape(shape)


def as_u32(x, device=None) -> torch.Tensor:
    """int64 tensor of the u32 bit pattern of ``x`` (python ints, int32 or
    int64 tensors; negative values wrap like an int32 -> uint32 cast)."""
    t = torch.as_tensor(x, device=device)
    return t.to(torch.int64) & _MASK


def _mul_u32(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2**32 for u32 patterns x and a u32 constant m."""
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (hi + x * (m & 0xFFFF)) & _MASK


def mix(x: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 finalizer on u32 patterns."""
    x = x ^ (x >> 16)
    x = _mul_u32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul_u32(x, _M2)
    return x ^ (x >> 16)


def hash_u32(seed, a, b, c) -> torch.Tensor:
    """Combine four 32-bit streams into uniform bits (broadcasting; python
    ints accepted).  Returns int64 holding u32 patterns."""
    device = next(
        (v.device for v in (seed, a, b, c) if isinstance(v, torch.Tensor)), None
    )
    h = mix((as_u32(seed, device) + _WEYL * 1) & _MASK)
    h = mix(h ^ ((as_u32(a, device) + _WEYL * 2) & _MASK))
    h = mix(h ^ ((as_u32(b, device) + _WEYL * 3) & _MASK))
    return mix(h ^ ((as_u32(c, device) + _WEYL * 4) & _MASK))


def uniform(seed, a, b, c) -> torch.Tensor:
    """Uniform f32 in [0, 1) with a full 24-bit mantissa."""
    return (hash_u32(seed, a, b, c) >> 8).to(torch.float32) * _INV_24


def uniform3(seed, a, b, purpose: int) -> torch.Tensor:
    """Three independent uniforms stacked on the last axis: f32[..., 3]."""
    return torch.stack(
        [uniform(seed, a, b, purpose * 3 + k) for k in range(3)], dim=-1
    )


def unit_vector(seed, a, b, purpose: int) -> torch.Tensor:
    """normalize(uniform cube sample) — the reference's random_unit
    distribution (vec3.rs:118-120)."""
    v = uniform3(seed, a, b, purpose) * 2.0 - 1.0
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)


def in_unit_disc(seed, a, b, purpose: int) -> torch.Tensor:
    """Uniform point in the unit x-y disc (polar transform), f32[..., 3]."""
    r = torch.sqrt(uniform(seed, a, b, purpose * 3))
    theta = uniform(seed, a, b, purpose * 3 + 1) * (2.0 * math.pi)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta), torch.zeros_like(r)], dim=-1)
