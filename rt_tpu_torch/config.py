"""Configuration layer (``rt_tpu.config`` without its TPU-only fields).

The reference has no config system at all — resolution, spp, depth, scene
choice and asset paths are hardcoded constants and commented-out lines
(reference: window.rs:29-30, scenes.rs:15, main.rs:50-55).  Frozen
dataclasses are shared by the library, CLI and tests.

``RenderConfig`` is the JAX package's minus its four fields that only
steer TPU mechanisms: the sort of the wavefront's ray pool and its
cadence, and the lane binning and expansion sweep of the clustered TPU
megakernel.  The CUDA kernels have no ray pool to sort, no lane rows to
bin and no sweep to expand, and the JAX package's image does not depend
on them either.  Every other field has the JAX package's name and default.
``max_rays_per_batch`` sizes the chunked route's calls, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

# f32 policy: the reference uses f64 everywhere (camera.rs:18) because f32
# produced shadow-acne artifacts (TODO.md:38-40).  The renderer works in f32
# and fixes robustness structurally: ray origins are offset along the
# geometric normal after every bounce, and epsilons are scene-scale aware.
DEFAULT_T_MIN = 1.0e-3  # shadow-acne epsilon (reference: camera.rs:297, `0.001..`)
DEFAULT_T_MAX = 3.0e38  # stand-in for Float::MAX (reference: camera.rs:22)


@dataclasses.dataclass(frozen=True)
class CompatConfig:
    """Flags reproducing (or fixing) reference quirks.

    Each flag defaults to the *reference-faithful* behavior so golden images
    track the reference; flip them for the "corrected" renderer.
    """

    # Triangle hit UVs: the reference remaps barycentric (u, v) into the
    # bounding box of the three vertex UVs instead of interpolating
    # (hittable.rs:466-481). True = replicate that quirk.
    triangle_uv_bbox_remap: bool = True

    # The reference's Halton jitter is indexed by sample index only, so every
    # pixel in a pass shares the same sub-pixel offset (camera.rs:239,
    # acknowledged moiré bug at scenes.rs:140-145).  True = replicate;
    # False = per-pixel scrambled offsets (fixes the moiré).
    shared_halton_jitter: bool = True

    # The reference applies Russian roulette with p = max(attenuation) and
    # panics if p > 1 (camera.rs:288).  p is clamped into (0, rr_clamp] so
    # no input can crash the renderer.
    rr_clamp: float = 1.0

    # Backface culling for triangles (det < EPSILON reject, hittable.rs:428).
    triangle_backface_cull: bool = True

    # glTF materials: the reference maps *every* PBR material to Metal with
    # fuzz = roughness_factor (material.rs:20-33).  True = replicate;
    # False = a metallic-factor-aware mapping (dielectric-free PBR approx).
    gltf_all_metal: bool = True


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Top-level render settings (reference analog: Camera fields +
    window.rs consts; here decoupled from the camera model)."""

    width: int = 800
    height: int = 600
    samples_per_pixel: int = 32
    # Reference MAX_DEPTH = 100 (scenes.rs:15).  A path is intersected at
    # most max_depth + 1 times; Russian roulette retires nearly all paths
    # long before that.
    max_depth: int = 100
    # Bounce count of the differentiable path (integrator.trace_radiance_diff
    # runs exactly diff_max_depth + 1 bounces).
    diff_max_depth: int = 8
    t_min: float = DEFAULT_T_MIN
    t_max: float = DEFAULT_T_MAX
    # Scale-aware ray-origin offset applied along the outward geometric
    # normal after each bounce (f32 robustness; see module docstring).
    origin_offset: float = 1.0e-4
    # Base RNG seed: the 32-bit seed of the counter hash (rng.py).
    seed: int = 0
    # Rays per render_chunk call of the chunked route
    # (render_pixel_colors(wavefront=False)); the wavefront ignores it.
    max_rays_per_batch: int = 1 << 20
    # Detach the Russian roulette's survival probability in the backward
    # pass of the generic bounce (integrator._bounce_step); False lets
    # gradients flow through its 1/p, as the fast-shade bounce always does.
    detach_sampling: bool = True
    # Renderer of render_pixel_colors(wavefront=True): "megakernel" (K1),
    # "wavefront" (the persistent wavefront, K3), or "auto" (K1 where it
    # is eligible, else the wavefront).
    renderer: str = "auto"
    compat: CompatConfig = dataclasses.field(default_factory=CompatConfig)

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ProgressiveSchedule:
    """Progressive refinement pass schedule.

    The reference hardcodes a 237-pass schedule totaling 40,055 spp
    (window.rs:233-247).  Same geometric ramp shape, as a config object.
    """

    ramp: Tuple[int, ...] = (1, 2, 4, 8, 8, 16, 16, 32, 32)
    sustain_64: int = 84
    sustain_128: int = 18
    sustain_256: int = 126

    def passes(self) -> Tuple[int, ...]:
        return (
            self.ramp
            + (64,) * self.sustain_64
            + (128,) * self.sustain_128
            + (256,) * self.sustain_256
        )

    @staticmethod
    def reference() -> "ProgressiveSchedule":
        """The exact reference schedule: 237 passes, 40,055 spp total."""
        return ProgressiveSchedule()
