"""The renderer's random streams, written out plainly for the reference.

- The counter hash of the render paths: murmur3's fmix32 over a Weyl
  combination of (seed, work id, depth, purpose); ``uniform`` takes its top
  24 bits.  Values travel as int64 holding u32 patterns.
- The Halton (2, 3) jitter of the camera, indexed by sample only.
- Threefry-2x32 (20 rounds, Salmon et al. 2011) for the host keys:
  ``key(seed)`` is (0, seed mod 2**32), ``fold_in`` is threefry of the
  counter (0, data), and a key's hash seed is its last word.

Nothing here imports the program: these are the published algorithms,
frozen with the benchmark.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_WEYL = 0x9E3779B9
_INV_24 = 5.9604645e-8  # 2^-24 as an f32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _mul(x: torch.Tensor, m: int) -> torch.Tensor:
    """(x * m) mod 2**32 on u32 patterns, in 16-bit halves."""
    hi = ((x * (m >> 16)) & 0xFFFF) << 16
    return (hi + x * (m & 0xFFFF)) & MASK


def _mix(x: torch.Tensor) -> torch.Tensor:
    x = x ^ (x >> 16)
    x = _mul(x, _M1)
    x = x ^ (x >> 13)
    x = _mul(x, _M2)
    return x ^ (x >> 16)


def _u32(v, device) -> torch.Tensor:
    return torch.as_tensor(v, device=device).to(torch.int64) & MASK


def uniform(seed: int, a, b, c) -> torch.Tensor:
    """f32 in [0, 1) from the hash of (seed, a, b, c); a, b, c broadcast."""
    device = next((v.device for v in (a, b, c) if isinstance(v, torch.Tensor)), None)
    h = _mix((_u32(seed, device) + _WEYL) & MASK)
    h = _mix(h ^ ((_u32(a, device) + 2 * _WEYL) & MASK))
    h = _mix(h ^ ((_u32(b, device) + 3 * _WEYL) & MASK))
    h = _mix(h ^ ((_u32(c, device) + 4 * _WEYL) & MASK))
    return (h >> 8).to(torch.float32) * _INV_24


def _bit_reverse(i: torch.Tensor) -> torch.Tensor:
    i = ((i >> 16) | (i << 16)) & MASK
    i = ((i & 0x00FF00FF) << 8) | ((i & 0xFF00FF00) >> 8)
    i = ((i & 0x0F0F0F0F) << 4) | ((i & 0xF0F0F0F0) >> 4)
    i = ((i & 0x33333333) << 2) | ((i & 0xCCCCCCCC) >> 2)
    return ((i & 0x55555555) << 1) | ((i & 0xAAAAAAAA) >> 1)


def halton_pair(sample: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(base 2, base 3) radical inverses of the 1-based position
    ``sample + 1``, in f32 (21 base-3 digits cover any u32)."""
    pos = (sample.to(torch.int64) + 1) & MASK
    u = _bit_reverse(pos).to(torch.float32) * 2.3283064365386963e-10
    inv3 = torch.tensor(1.0 / 3, dtype=torch.float32, device=pos.device)
    v = torch.zeros(pos.shape, dtype=torch.float32, device=pos.device)
    scale = inv3.expand(pos.shape)
    idx = pos
    for _ in range(21):
        v = v + (idx % 3).to(torch.float32) * scale
        scale = scale * inv3
        idx = idx // 3
    return u, v


def _threefry(k0: int, k1: int, x0: int, x1: int) -> tuple[int, int]:
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = (x0 + ks[0]) & MASK, (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = (((x1 << r) | (x1 >> (32 - r))) & MASK) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & MASK
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    return (0, int(seed) & MASK)


def fold_in(k: tuple[int, int], data: int) -> tuple[int, int]:
    return _threefry(k[0], k[1], 0, int(data) & MASK)


def key_seed(k: tuple[int, int]) -> int:
    return int(k[1])
