"""How ``correct`` is decided: what the timed path produced, held against the
plain reference (``rtbench.reference``) on answers and pixels drawn from the
run's seed.  Imports nothing of the program: the answers are plain arrays,
and the reference works its scene out again from the generated inputs.

Numbers compared on image answers (frames, progressive states), each
against its cell's limit in ``rtbench/checks/<cell>.json``: ``px_err_max``,
the largest absolute gap of a sampled pixel's channel from the reference's,
and ``px_err_mean``, the mean absolute gap over the sampled pixels'
channels.
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench.inputs import car as car_inputs, cover as cover_inputs
from rtbench.reference import rng, tracer
from rtbench.reference.scene import Prims


def describe(config: dict) -> dict:
    """The configuration's scene as a raw description."""
    sc = config["scene"]
    if sc["generator"] == "cover":
        return cover_inputs.describe(sc["grid_i"], sc["grid_j"], sc["z"], sc["seed"],
                                     viewer=np.float32(config["camera"]["center"]))
    if sc["generator"] == "car":
        return car_inputs.describe(sc["res"], sc["n_parts"], sc["seed"], sc["ground"], sc["sky"])
    raise ValueError(f"unknown scene generator {sc['generator']!r}")


def sample_pixels(seed: int, n_pixels: int, k: int, stream: int) -> np.ndarray:
    """``k`` distinct flat pixel ids drawn from the run's seed, sorted."""
    g = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, stream])
    return np.sort(g.choice(n_pixels, size=min(k, n_pixels), replace=False))


class Reference:
    """The reference's scene, camera and settings for one configuration."""

    def __init__(self, config: dict, device, dtype=torch.float32):
        self.config, self.device, self.dtype = config, torch.device(device), dtype
        self.desc = describe(config)
        self.prims = Prims(self.desc, device, dtype)
        self.frame = tracer.camera_frame(config["camera"], config["width"], config["height"])
        self.p = tracer.render_params(config["render"])
        self.n_pixels = config["width"] * config["height"]

    def frame_pixels(self, pix: np.ndarray, spp: int, seed: int) -> np.ndarray:
        """Mean radiance f32[P, 3] of a frame's pixels (render seed ``seed``)."""
        p = torch.as_tensor(pix, device=self.device)
        out = tracer.render_pixels(self.prims, self.frame, self.p, self.desc["sky"], p, spp, 0, seed)
        return out.float().cpu().numpy()

    def progressive_pixels(self, pix: np.ndarray, image_seed: int, sweeps: int, ns: int,
                           divide: bool) -> np.ndarray:
        """The progressive image f32[P, 3] of pixels after ``sweeps`` sweeps
        of ``ns`` samples (sample indices 0..ns-1 every sweep, sweep ``i``
        under the seed of ``fold_in(key(image_seed), i)``): each sweep's
        per-pixel mean times ``ns`` added in sweep order, over the total."""
        p = torch.as_tensor(pix, dtype=torch.int64, device=self.device)
        n = p.shape[0]
        seeds = [rng.key_seed(rng.fold_in(rng.key(image_seed), i)) for i in range(sweeps)]
        # Every path of every sweep in one batch: sweep-major, then pixel, then sample.
        pp = p.repeat_interleave(ns).repeat(sweeps)
        sample = torch.arange(ns, device=self.device).repeat(n * sweeps)
        seed = torch.tensor(seeds, dtype=torch.int64, device=self.device).repeat_interleave(n * ns)
        p = dict(self.p, fast_shade=divide)
        rad = tracer.radiance(self.prims, self.frame, p, self.desc["sky"], pp, sample, seed)
        rad = rad.float().reshape(sweeps, n * ns, 3)
        accum = torch.zeros((n, 3), device=self.device)
        for i in range(sweeps):
            accum = accum + tracer.pixel_means(rad[i], ns, divide) * float(ns)
        return (accum / float(sweeps * ns)).cpu().numpy()


def image_numbers(prog: np.ndarray, ref: np.ndarray) -> dict:
    d = np.abs(np.asarray(prog, np.float64) - np.asarray(ref, np.float64))
    if not np.isfinite(d).all():
        return {"px_err_max": float("inf"), "px_err_mean": float("inf")}
    return {"px_err_max": float(d.max()), "px_err_mean": float(d.mean())}


def worst(numbers: list[dict]) -> dict:
    """The largest reading of each number over several answers."""
    out: dict[str, float] = {}
    for nums in numbers:
        for k, v in nums.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def compare(kind: str, answers: list, config: dict, traffic: dict, spec: dict, seed: int,
            device, dtype=torch.float32, log=None) -> dict:
    """The numbers compared for a run's answers (``drivers``' answer
    tuples), the pixels drawn from ``seed`` and ``spec["pixels"]``."""
    ref = Reference(config, device, dtype)
    results = []
    for j, ans in enumerate(answers):
        if kind == "frames":
            s, img = ans
            pix = sample_pixels(seed, ref.n_pixels, spec["pixels"], j)
            prog = np.asarray(img, np.float32).reshape(-1, 3)[pix]
            results.append(image_numbers(prog, ref.frame_pixels(pix, int(traffic["spp"]), s)))
        elif kind == "sweeps":
            s, sweeps, ns, image = ans
            pix = sample_pixels(seed, ref.n_pixels, spec["pixels"], j)
            prog = np.asarray(image, np.float32).reshape(-1, 3)[pix]
            want = ref.progressive_pixels(pix, s, sweeps, ns, traffic["engine"] == "wavefront")
            results.append(image_numbers(prog, want))
        else:
            raise ValueError(f"unknown entry {kind!r}")
    return worst(results)
