"""Frame rendering: the user-facing entry points.

Reference analog: ``Camera::render_image`` (camera.rs:315-341).  The routes
of the JAX package (rt_tpu/render.py):

- ``wavefront=True`` (the default), by ``cfg.renderer``: "megakernel" is
  one call of a megakernel over all pixels and samples, the flat one (K1)
  or, on a scene with cluster tables, the clustered one (K5): the
  hand-written CUDA kernel on a CUDA device and its plain PyTorch version
  on the CPU; "wavefront" is the persistent wavefront
  (``wavefront.render_wavefront``, with K3, or K4 on a clustered scene),
  in calls of at most ``(16 << 20) // pixels`` samples per pixel; "auto"
  takes the megakernel where ``megakernel.eligible`` or
  ``megakernel.eligible_clustered`` holds and the wavefront otherwise;
- ``wavefront=False``: the chunked megabatch, ``render_chunk`` over chunks
  of pixels, each traced by ``integrator.trace_radiance``: with K2 as its
  sphere search on a scene with a shade table and no BVH, and with the
  generic bounce (the BVH walk of csrc/bvh_walk.cu on a mesh) otherwise.
  ``render_chunk(differentiable=True)`` is the gradient path's renderer
  (grad.py).

Both entry points run on the card unless the caller passes
``device="cpu"``.  A scene a route cannot take raises, as does a CUDA
device on a machine without one.  Nothing falls back.

The Mray/s metric follows the reference definition (window.rs:315-324):
rays = spp * W * H camera samples (bounces NOT counted), divided by wall
seconds.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from rt_tpu_torch import megakernel, nearest_ops, profiling, rng
from rt_tpu_torch import wavefront as wavefront_mod
from rt_tpu_torch.bvh import traverse
from rt_tpu_torch.camera import Camera, generate_rays_keyed
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.integrator import trace_radiance, trace_radiance_diff
from rt_tpu_torch.scene import SceneData


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device} requested but CUDA is not available")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}: use 'cuda' or 'cpu'")
    return device


def render_chunk(
    scene: SceneData,
    camera: Camera,
    pixel_idx: torch.Tensor,
    cfg: RenderConfig,
    spp: int,
    sample_offset: int,
    key: np.ndarray,
    differentiable: bool = False,
    *,
    sphere_nearest=nearest_ops.sphere_nearest,
    bvh_walk=traverse.bvh_walk,
    work: torch.Tensor | None = None,
) -> torch.Tensor:
    """Mean radiance f32[P,3] of ``spp`` samples for flat pixel ids
    ``pixel_idx`` int[P] (y * W + x) on the scene's device, samples
    [sample_offset, sample_offset + spp) (rt_tpu/render.py:29-63).  ``key``
    is an rng.key: the camera folds in 0xCA0 and the paths 0x7ACE, as in
    JAX.  ``sphere_nearest`` is K2 and ``bvh_walk`` the BVH walk (see
    geometry).  ``work`` (int64[P * spp], pixel-major) gives the rays'
    rows in a larger batch, whose draws they take (integrator); None means
    rows 0..P*spp-1."""
    p = pixel_idx.shape[0]
    device = pixel_idx.device
    pix = pixel_idx.to(torch.int64).repeat_interleave(spp)
    sample = torch.arange(spp, device=device).repeat(p) + sample_offset
    width = camera.image_width
    org, dirn = generate_rays_keyed(camera, pix % width, pix // width, sample,
                                    rng.fold_in(key, 0xCA0), cfg.compat, work)
    trace = trace_radiance_diff if differentiable else trace_radiance
    radiance = trace(scene, org, dirn, rng.fold_in(key, 0x7ACE), cfg, sphere_nearest,
                     bvh_walk=bvh_walk, work=work)
    return radiance.reshape(p, spp, 3).mean(dim=1)


def render_pixel_colors(
    scene: SceneData,
    camera: Camera,
    cfg: RenderConfig,
    *,
    device="cuda",
    spp: int | None = None,
    sample_offset: int = 0,
    key: np.ndarray | None = None,
    wavefront: bool = True,
) -> torch.Tensor:
    """Render the full frame to linear color f32[H, W, 3] on ``device``
    (the scene's tables are moved there).  ``key`` (rng.key) defaults to
    ``rng.key(cfg.seed)``; the megakernel and the wavefront draw from the
    key's hash seed.  ``wavefront=True`` routes by ``cfg.renderer`` (see
    the module docstring).  ``wavefront=False`` takes the chunked route,
    ``cfg.max_rays_per_batch // spp`` pixels per ``render_chunk`` call, the
    ragged tail padded and each chunk's key folded with its first pixel, as
    rt_tpu/render.py:151-168 does."""
    device = _device(device)
    spp = spp if spp is not None else cfg.samples_per_pixel
    if key is None:
        key = rng.key(cfg.seed)
    scene.to(device)
    w, h = camera.image_width, camera.image_height
    n_pixels = w * h
    if wavefront:
        if cfg.renderer not in ("auto", "megakernel", "wavefront"):
            raise ValueError(f"unknown renderer {cfg.renderer!r}")
        if cfg.renderer == "megakernel" or (cfg.renderer == "auto" and (
                megakernel.eligible(scene, cfg) or megakernel.eligible_clustered(scene, cfg))):
            flat = megakernel.render_megakernel(scene, camera, cfg, spp, sample_offset,
                                                rng.key_seed(key))
            return flat.reshape(h, w, 3)
        # The per-work deposit buffer grows with pixels x spp: chunk the
        # samples (rt_tpu/render.py:129-149); draws key on the global work
        # id, so chunking changes no draw.
        pixel_idx = torch.arange(n_pixels, dtype=torch.int32, device=device)
        spp_chunk = max(1, min(spp, (16 << 20) // n_pixels))
        if spp_chunk >= spp:
            flat = wavefront_mod.render_wavefront(scene, camera, pixel_idx, cfg, spp,
                                                  sample_offset, key)
            return flat.reshape(h, w, 3)
        accum = torch.zeros((n_pixels, 3), device=device)
        done = 0
        while done < spp:
            ns = min(spp_chunk, spp - done)
            part = wavefront_mod.render_wavefront(scene, camera, pixel_idx, cfg, ns,
                                                  sample_offset + done, key)
            accum = accum + part * ns
            done += ns
        return (accum / spp).reshape(h, w, 3)

    pixels_per_chunk = max(cfg.max_rays_per_batch // max(spp, 1), 1)
    all_idx = torch.arange(n_pixels, device=device)
    padded = n_pixels > pixels_per_chunk
    chunks = []
    for start in range(0, n_pixels, pixels_per_chunk):
        idx = all_idx[start : start + pixels_per_chunk]
        # Pad the ragged tail to the chunk size (the JAX package reuses one
        # compiled program that way; the real lanes' draws do not change).
        pad = pixels_per_chunk - idx.shape[0]
        if pad and padded:
            idx = F.pad(idx, (0, pad))
        colors = render_chunk(scene, camera, idx, cfg, spp, sample_offset, rng.fold_in(key, start))
        if pad and padded:
            colors = colors[: pixels_per_chunk - pad]
        chunks.append(colors)
    return torch.cat(chunks).reshape(h, w, 3)


def render_image(
    scene: SceneData, camera: Camera, cfg: RenderConfig, *, device="cuda", **kw
) -> tuple[np.ndarray, dict]:
    """Render and fetch to the host; returns (f32[H,W,3] linear image,
    metrics).  Metrics hold the wall seconds, the camera samples, Mray/s
    (window.rs:315-324) and the device that ran the frame."""
    device = _device(device)
    spp = kw.get("spp") or cfg.samples_per_pixel
    with profiling.span("render.frame", cfg.seed):
        if device.type == "cuda":
            with profiling.span("render.sync"):
                torch.cuda.synchronize(device)
        start = time.perf_counter()
        with profiling.span("render.dispatch"):
            img = render_pixel_colors(scene, camera, cfg, device=device, **kw)
        with profiling.span("render.fetch"):
            img = img.cpu().numpy()  # waits for the device
        elapsed = time.perf_counter() - start
        rays = spp * camera.image_width * camera.image_height
        name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        metrics = {
            "wall_s": elapsed,
            "rays": rays,
            "mray_per_s": rays / 1.0e6 / elapsed,
            "device": name,
        }
    return img, metrics
