"""Operations and bytes of a kernel's work, counted by the benchmark's own
reference, so that the count does not depend on what implements the
kernel.

K1 (the flat megakernel) brute-forces every ray segment of a path against
every primitive: 18 FLOP a (ray, sphere) pair test and 6 more for each pair
the discriminant admits (the square root and the roots), 46 a (ray,
triangle) pair test.  The reference traces 1,024 fixed pixels (drawn from
seed 0) at 10 spp under render seed 0 and counts its segments and admitted
pairs; the frame's count is that, scaled by the frame's samples.  Bytes:
the primitive tables read once (centres and radii, triangle vertices and
edges, the 40 shading parameters a primitive, the texels) and the image
written once.
"""

from __future__ import annotations

import functools
import json

import torch

from rtbench.check import Reference, sample_pixels
from rtbench.reference import tracer

FLOP_SPHERE_PAIR = 18
FLOP_ADMITTED = 6
FLOP_TRIANGLE_PAIR = 46
SHADE_PARAMS = 40
COUNT_PIXELS = 1024
COUNT_SPP = 10


@functools.lru_cache(maxsize=4)
def _counts(config_json: str, device: str) -> tuple[int, int, int, int, int]:
    config = json.loads(config_json)
    ref = Reference(config, device)
    pix = torch.as_tensor(sample_pixels(0, ref.n_pixels, COUNT_PIXELS, 0), device=device)
    pp = pix.repeat_interleave(COUNT_SPP)
    sample = torch.arange(COUNT_SPP, device=device).repeat(pix.shape[0])
    count = {"segments": 0, "admitted": 0}
    tracer.radiance(ref.prims, ref.frame, ref.p, ref.desc["sky"], pp, sample,
                    torch.zeros_like(pp), count)
    texels = int(ref.prims.leaves["images"].numel() // 3)
    return count["segments"], count["admitted"], ref.prims.ns, ref.prims.nt, texels


def k1_frame_work(config: dict, spp: int, device) -> tuple[float, float]:
    """(FLOP, bytes) of one K1 frame of ``config`` at ``spp``."""
    segments, admitted, ns, nt, texels = _counts(json.dumps(config, sort_keys=True), str(device))
    scale = config["width"] * config["height"] * spp / float(pixels_counted(config) * COUNT_SPP)
    flops = scale * (segments * (FLOP_SPHERE_PAIR * ns + FLOP_TRIANGLE_PAIR * nt)
                     + FLOP_ADMITTED * admitted)
    nbytes = (ns * 16 + nt * 36 + (ns + nt) * SHADE_PARAMS * 4 + texels * 12
              + config["width"] * config["height"] * 12)
    return float(flops), float(nbytes)


def pixels_counted(config: dict) -> int:
    return min(COUNT_PIXELS, config["width"] * config["height"])
