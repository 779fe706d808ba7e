"""Halton low-discrepancy sequences, bit-exact with ``rt_tpu.sampling``.

The reference precomputes a Halton(2,3) table of 2^20 pairs indexed by
*sample index only* (camera.rs:140-165, 208-210, 239); ``halton_pair(i)``
equals its ``rng_map[i]`` and is computed in closed form instead.
Integers travel as int64 holding u32 patterns (see rng.py).

``random_unit`` and ``random_in_unit_disc`` are the geometric draws of the
chunked and gradient paths (rt_tpu/sampling.py:101-119), on
``jax.random``'s stream (rng.random_uniform) under a host key.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from rt_tpu_torch import rng

_MASK = 0xFFFFFFFF


def radical_inverse_base2(index: torch.Tensor) -> torch.Tensor:
    """Van der Corput sequence in base 2 via 32-bit reversal.

    ``index`` is the 1-based sequence position (index=1 -> 0.5).
    """
    i = index.to(torch.int64) & _MASK
    i = ((i >> 16) | (i << 16)) & _MASK
    i = ((i & 0x00FF00FF) << 8) | ((i & 0xFF00FF00) >> 8)
    i = ((i & 0x0F0F0F0F) << 4) | ((i & 0xF0F0F0F0) >> 4)
    i = ((i & 0x33333333) << 2) | ((i & 0xCCCCCCCC) >> 2)
    i = ((i & 0x55555555) << 1) | ((i & 0xAAAAAAAA) >> 1)
    return i.to(torch.float32) * 2.3283064365386963e-10  # 2^-32


def radical_inverse(base: int, index: torch.Tensor) -> torch.Tensor:
    """Radical inverse of 1-based ``index`` in integer ``base``.

    Fixed trip count: 21 digits cover base >= 3 for all uint32 indices
    (3^21 > 2^32), accumulated in the JAX package's f32 order.
    """
    if base == 2:
        return radical_inverse_base2(index)
    idx = index.to(torch.int64) & _MASK
    inv_base = torch.tensor(1.0 / base, dtype=torch.float32)
    result = torch.zeros(idx.shape, dtype=torch.float32, device=idx.device)
    scale = inv_base.to(idx.device).expand(idx.shape)
    for _ in range(21):
        result = result + (idx % base).to(torch.float32) * scale
        scale = scale * inv_base
        idx = idx // base
    return result


def halton_pair(sample_index: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(base-2, base-3) Halton pair matching the reference's ``rng_map[i]``
    (camera.rs:208-210): 0-based ``sample_index`` maps to the 1-based
    radical-inverse position."""
    pos = (sample_index.to(torch.int64) + 1) & _MASK
    return radical_inverse_base2(pos), radical_inverse(3, pos)


def random_unit(key: np.ndarray, n: int, device=None, work=None) -> torch.Tensor:
    """normalize(uniform([-1, 1]^3)) f32[n, 3]: the reference's slightly
    non-uniform sphere distribution (vec3.rs:118-120), the norm floored at
    1e-12.  ``work`` (int64[n]) gives the rows' ids in a larger batch:
    draw (i, j) takes the counter ``work[i] * 3 + j``."""
    counters = None
    if work is not None:
        counters = (work[:, None] * 3 + torch.arange(3, device=work.device)).reshape(-1)
    v = rng.random_uniform(key, (n, 3), -1.0, 1.0, device, counters)
    p = v * v
    norm = torch.sqrt(p[:, 0:1] + p[:, 1:2] + p[:, 2:3])
    return v / torch.clamp(norm, min=1.0e-12)


def random_in_unit_disc(key: np.ndarray, n: int, device=None, work=None) -> torch.Tensor:
    """Uniform points f32[n, 3] in the unit x-y disc, z = 0, by the polar
    transform r = sqrt(u) (vec3.rs:124-135's distribution), with r and the
    angle drawn under the two halves of ``rng.split(key)``; ``work``
    (int64[n]) as in ``random_unit``."""
    ku, kt = rng.split(key)
    r = torch.sqrt(rng.random_uniform(ku, (n,), device=device, counters=work))
    theta = rng.random_uniform(kt, (n,), 0.0, 2.0 * math.pi, device, work)
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta), torch.zeros_like(r)], dim=-1)
