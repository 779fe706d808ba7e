"""Analytic daylight sky: Perez/Preetham and Hosek-Wilkie forms.

Reference behavior: on ray miss the integrator queries an analytic sky —
``World::sky_color_toward`` evaluates the Hosek-Wilkie model at
(theta = acos(dir.z), gamma vs the sun direction) per RGB channel, then
applies the Uncharted2 filmic tonemap (hittable.rs:84-93; sun_direction
defaults to +z, hittable.rs:38).

The default model is Perez/Preetham with the published coefficient tables
(Preetham, Shirley & Smits 1999).  ``SkyParams.hosek_reference()`` is the
Hosek-Wilkie configuration fitted against the reference's golden render;
``SkyParams.hosek()`` interpolates a live (turbidity, albedo, elevation)
configuration from the dataset in data/hw_dataset.npz (``hosek_config``),
differentiably in all three.

``frame_scalars`` reduces a sky to the per-frame scalars the megakernel and
its plain version evaluate per ray.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os

import numpy as np
import torch

from rt_tpu_torch import color as color_mod


@dataclasses.dataclass(frozen=True)
class SkyParams:
    """Sky parameters (reference analog: SkyState + sun_direction,
    hittable.rs:27-28).  Tensors are f32 on the CPU."""

    sun_direction: torch.Tensor  # (3,) reference default +z
    turbidity: torch.Tensor  # () in [2, 10]
    exposure: torch.Tensor  # () scales luminance into tonemap range
    # Hosek-Wilkie mode: f32[3, 10] per-RGB-channel (A..I, radiance_scale).
    # None -> the Perez model.
    hw_params: torch.Tensor | None = None
    # Reference quirk (hittable.rs:86): the dot product cos(gamma), clamped
    # to [-1, 1], is passed where the sky model expects the angle gamma.
    cos_gamma_as_angle: bool = False

    def replace(self, **kw) -> "SkyParams":
        return dataclasses.replace(self, **kw)

    @staticmethod
    def default() -> "SkyParams":
        return SkyParams(
            sun_direction=torch.tensor([0.0, 0.0, 1.0]),
            turbidity=torch.tensor(2.0),
            exposure=torch.tensor(0.25),
        )

    @staticmethod
    def hosek(turbidity=3.0, albedo=0.2, elevation=None, sun_direction=None,
              exposure=1.0) -> "SkyParams":
        """Hosek-Wilkie sky at a live (turbidity, albedo, elevation)
        configuration through the dataset interpolation (``hosek_config``).
        The sun defaults to +z (hittable.rs:38) and is normalised; when
        ``elevation`` is None it is asin of the sun's z.  A given
        ``elevation`` moves only the H-W rows, not the sun.  Gamma is the
        true angle (no cos-as-angle quirk); ``hosek_reference()`` is the
        reference's exact configuration.  Tensors that require grad keep
        their graph through ``hw_params``."""
        sun = torch.as_tensor([0.0, 0.0, 1.0] if sun_direction is None else sun_direction,
                              dtype=torch.float32)
        sun = sun / torch.linalg.vector_norm(sun)
        if elevation is None:
            elevation = torch.arcsin(torch.clamp(sun[2], -1.0, 1.0))
        turbidity = torch.as_tensor(turbidity, dtype=torch.float32)
        return SkyParams(
            sun_direction=sun,
            turbidity=turbidity,
            exposure=torch.as_tensor(exposure, dtype=torch.float32),
            hw_params=hosek_config(turbidity, albedo, elevation),
        )

    @staticmethod
    def hosek_reference() -> "SkyParams":
        """Hosek-Wilkie sky in the reference's exact configuration: sun at
        +z, the cos-as-angle quirk active (hittable.rs:84-93), and the H-W
        configuration fitted against the reference's own golden render."""
        return SkyParams(
            sun_direction=torch.tensor([0.0, 0.0, 1.0]),
            turbidity=torch.tensor(2.0),
            exposure=torch.tensor(1.0),
            hw_params=torch.from_numpy(HW_REFERENCE_FIT.copy()),
            cos_gamma_as_angle=True,
        )


# Perez coefficient rows (A..E) as linear functions of turbidity T:
# coeff = c1 * T + c0.  Published tables from Preetham et al. 1999, A.2.
_PEREZ_Y = np.array(
    [[0.1787, -1.4630], [-0.3554, 0.4275], [-0.0227, 5.3251],
     [0.1206, -2.5771], [-0.0670, 0.3703]], np.float32)
_PEREZ_X = np.array(
    [[-0.0193, -0.2592], [-0.0665, 0.0008], [-0.0004, 0.2125],
     [-0.0641, -0.8989], [-0.0033, 0.0452]], np.float32)
_PEREZ_YC = np.array(
    [[-0.0167, -0.2608], [-0.0950, 0.0092], [-0.0079, 0.2102],
     [-0.0441, -1.6537], [-0.0109, 0.0529]], np.float32)

# Zenith chromaticity matrices (Preetham et al. 1999, A.2): row vector
# [T^2, T, 1] @ M @ [ts^3, ts^2, ts, 1]^T with ts = sun zenith angle.
_ZENITH_X = np.array(
    [[0.00166, -0.00375, 0.00209, 0.0],
     [-0.02903, 0.06377, -0.03202, 0.00394],
     [0.11693, -0.21196, 0.06052, 0.25886]], np.float32)
_ZENITH_Y = np.array(
    [[0.00275, -0.00610, 0.00317, 0.0],
     [-0.04214, 0.08970, -0.04153, 0.00516],
     [0.15346, -0.26756, 0.06670, 0.26688]], np.float32)

# Linear-sRGB conversion from CIE XYZ (D65).
XYZ_TO_SRGB = np.array(
    [[3.2404542, -1.5371385, -0.4985314],
     [-0.9692660, 1.8760108, 0.0415560],
     [0.0556434, -0.2040259, 1.0572252]], np.float32)

# Per-channel (A..I, radiance_scale) fitted against the sky band of the
# reference's golden render (the JAX package's tools/fit_hw_sky.py).
HW_REFERENCE_FIT = np.array([
    [-0.5729265, -0.6005954, 1.263495, 0.3531559, 0.05393208, 0.3093236, 0.3058655, 0.6177279, 0.8103479, 0.3000396],
    [-0.5307202, -0.627763, 1.301451, 0.3937595, 0.215148, 0.3467761, 0.344817, 0.6351792, 0.8778835, 0.3376637],
    [-0.4482514, -0.6766365, 1.381625, 0.4830969, 0.5850139, 0.4258644, 0.4260356, 0.6652659, 1.022361, 0.4170587],
], np.float32)


_HW_DATASET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "hw_dataset.npz")


@functools.cache
def _hw_params() -> torch.Tensor:
    """The dataset's H-W configurations f32[turbidity 10, elevation 9,
    albedo 2, channel 3, 10] (a byte-for-byte copy of the JAX package's
    rt_tpu/data/hw_dataset.npz, generated by its tools/gen_hw_dataset.py:
    the H-W form fitted per grid point to the Perez model plus a
    ground-albedo lift, on the published model's grid axes)."""
    with np.load(_HW_DATASET) as z:
        return torch.from_numpy(np.array(z["params"], np.float32))


def hosek_config(turbidity, albedo, elevation) -> torch.Tensor:
    """(turbidity, albedo, solar elevation) -> f32[3, 10] H-W
    configuration for ``SkyParams.hw_params`` (the hw-skymodel crate's
    ``SkyState::new``, hittable.rs:84-93; rt_tpu/sky.py:251-301).

    Piecewise-linear over the dataset grid: turbidity knots 1..10, albedo
    {0, 1}, elevation knots uniform in (2 eta / pi)^(1/3).  Inputs are
    clipped to the grid's domain.  Differentiable in all three arguments;
    the result is on the arguments' device (the CPU for numbers)."""
    t_in = torch.as_tensor(turbidity, dtype=torch.float32)
    e_in = torch.as_tensor(elevation, dtype=torch.float32)
    a_in = torch.as_tensor(albedo, dtype=torch.float32)
    params = _hw_params().to(t_in.device)
    n_t, n_e = params.shape[0], params.shape[1]

    t = torch.clamp(t_in, 1.0, float(n_t)) - 1.0
    t0 = torch.clamp(torch.floor(t).to(torch.int64), 0, n_t - 2)
    tw = t - t0.to(torch.float32)

    eta = torch.clamp(e_in, 0.0, math.pi / 2)
    x = torch.pow(eta * float(np.float32(2.0 / np.pi)), float(np.float32(1.0 / 3.0)))
    e = x * (n_e - 1)
    e0 = torch.clamp(torch.floor(e).to(torch.int64), 0, n_e - 2)
    ew = e - e0.to(torch.float32)

    aw = torch.clamp(a_in, 0.0, 1.0)

    def at(ti, ei):
        p = params[ti, ei]  # [2, 3, 10]
        return p[0] * (1.0 - aw) + p[1] * aw

    p0 = at(t0, e0) * (1.0 - ew) + at(t0, e0 + 1) * ew
    p1 = at(t0 + 1, e0) * (1.0 - ew) + at(t0 + 1, e0 + 1) * ew
    return p0 * (1.0 - tw) + p1 * tw


def _safe_arccos(x: torch.Tensor) -> torch.Tensor:
    """arccos with inputs pulled off the +-1 poles."""
    return torch.arccos(torch.clamp(x, -1.0 + 1.0e-6, 1.0 - 1.0e-6))


def perez_coefficients(turbidity: torch.Tensor):
    """(A..E) Perez coefficients for (Y, x, y) at the given turbidity."""
    t = torch.as_tensor(turbidity, dtype=torch.float32)
    table = lambda col: torch.from_numpy(col).to(t.device)
    coef = lambda tab: table(tab[:, 0]) * t + table(tab[:, 1])
    return coef(_PEREZ_Y), coef(_PEREZ_X), coef(_PEREZ_YC)


def _perez(coef, cos_theta, gamma, cos_gamma):
    """Perez luminance distribution F(theta, gamma)."""
    a, b, c, d, e = (coef[k] for k in range(5))
    return (1.0 + a * torch.exp(b / torch.clamp(cos_theta, min=0.01))) * (
        1.0 + c * torch.exp(d * gamma) + e * cos_gamma * cos_gamma
    )


def zenith_values(turbidity: torch.Tensor, theta_s: torch.Tensor):
    """Zenith luminance Y_z (kcd/m^2) and chromaticity (x_z, y_z)."""
    t = torch.as_tensor(turbidity, dtype=torch.float32)
    chi = (4.0 / 9.0 - t / 120.0) * (math.pi - 2.0 * theta_s)
    y_lum = (4.0453 * t - 4.9710) * torch.tan(chi) - 0.2155 * t + 2.4192
    tv = torch.stack([t * t, t, torch.ones_like(t)])
    sv = torch.stack([theta_s**3, theta_s**2, theta_s, torch.ones_like(theta_s)])
    x_z = tv @ torch.from_numpy(_ZENITH_X).to(t.device) @ sv
    y_z = tv @ torch.from_numpy(_ZENITH_Y).to(t.device) @ sv
    return y_lum, x_z, y_z


def hosek_radiance_rgb(hw: torch.Tensor, cos_theta, gamma, cos_gamma):
    """H-W 2012 radiance per channel at (theta, gamma):

        F = (1 + A e^{B/cos_theta}) *
            (C + D e^{E gamma} + F cos^2(gamma) + G chi(H, gamma)
               + I sqrt(max(cos_theta, 0)))
        chi(g, a) = (1 + cos^2 a) / (1 + g^2 - 2 g cos a)^{3/2}

    ``hw`` is f32[3, 10] rows (A..I, scale).
    """
    outs = []
    sq = torch.sqrt(torch.clamp(cos_theta, min=0.0))
    for ch in range(3):
        a, b, c, d, e, f, g, h, i_ = (hw[ch, k] for k in range(9))
        h = torch.clamp(h, -0.999, 0.999)  # chi pole guard
        chi = (1.0 + cos_gamma * cos_gamma) / torch.pow(
            torch.clamp(1.0 + h * h - 2.0 * h * cos_gamma, min=1e-6), 1.5
        )
        val = (1.0 + a * torch.exp(b / torch.clamp(cos_theta, min=0.01))) * (
            c + d * torch.exp(e * gamma) + f * cos_gamma * cos_gamma + g * chi + i_ * sq
        )
        outs.append(torch.clamp(val * hw[ch, 9], min=0.0))
    return outs[0], outs[1], outs[2]


def _angles(params: SkyParams, direction: torch.Tensor):
    """(cos_theta, gamma, cos_gamma) with the reference's cos-as-angle
    quirk applied when requested (hittable.rs:86)."""
    sun = params.sun_direction.to(direction.device)
    sun = sun / torch.linalg.vector_norm(sun)
    cos_theta = torch.clamp(direction[..., 2], 0.01, 1.0)
    cos_gamma = torch.clamp(torch.sum(direction * sun, dim=-1), -1.0, 1.0)
    if params.cos_gamma_as_angle:
        gamma = cos_gamma
        cos_gamma = torch.cos(gamma)
    else:
        gamma = _safe_arccos(cos_gamma)
    return sun, cos_theta, gamma, cos_gamma


def sky_radiance_rgb(params: SkyParams, direction: torch.Tensor) -> torch.Tensor:
    """Linear-sRGB HDR sky radiance (pre-tonemap), exposure-scaled, for
    unit ``direction`` f32[..., 3].

    The sky's differentiable tensors are moved to the direction's device and
    every step runs there.  Autograd runs a graph's CPU nodes and its CUDA
    nodes on two threads, and adds the contributions to a shared input in
    the order they arrive; a sky graph with nodes on both devices therefore
    gave two backward passes gradients that differed in the last bits."""
    dev = direction.device
    sun, cos_theta, gamma, cos_gamma = _angles(params, direction)
    exposure = params.exposure.to(dev)
    if params.hw_params is not None:
        r, g, b = hosek_radiance_rgb(params.hw_params.to(dev), cos_theta, gamma, cos_gamma)
        rgb = torch.stack([r, g, b], dim=-1) * exposure
        return torch.clamp(rgb, min=0.0)
    turbidity = params.turbidity.to(dev)
    theta_s = _safe_arccos(torch.clamp(sun[2], 0.0, 1.0))
    cos_theta_s = torch.cos(theta_s)
    coef_y, coef_x, coef_yc = perez_coefficients(turbidity)
    yz, xz, yz_c = zenith_values(turbidity, theta_s)
    one = torch.tensor(1.0, device=dev)

    def channel(coef, zenith):
        num = _perez(coef, cos_theta, gamma, cos_gamma)
        den = _perez(coef, one, theta_s, cos_theta_s)
        return zenith * num / den

    y_lum = torch.clamp(channel(coef_y, yz), min=0.0) * exposure
    x_c = channel(coef_x, xz)
    y_c = torch.clamp(channel(coef_yc, yz_c), min=1.0e-6)
    big_x = x_c / y_c * y_lum
    big_z = (1.0 - x_c - y_c) / y_c * y_lum
    xyz = torch.stack([big_x, y_lum, big_z], dim=-1)
    rgb = torch.einsum("ij,...j->...i", torch.from_numpy(XYZ_TO_SRGB).to(xyz.device), xyz)
    return torch.clamp(rgb, min=0.0)


def sky_color_toward(params: SkyParams, direction: torch.Tensor) -> torch.Tensor:
    """HDR sky radiance through the Uncharted2 tonemap — the analog of
    ``World::sky_color_toward`` (hittable.rs:84-93).  ``direction`` must be
    unit length."""
    return torch.clamp(color_mod.uncharted2(sky_radiance_rgb(params, direction)), min=0.0)


def frame_scalars(params: SkyParams) -> dict:
    """Per-frame scalars of the megakernel's sky, as python floats holding
    f32 values: unit sun, Perez (A..E) rows with the zenith value divided by
    the Perez value at the zenith folded into one factor per channel
    (exposure included in Y), and the Hosek rows with exposure folded into
    the scale column."""
    sun = params.sun_direction.to(torch.float32)
    sun = sun / torch.linalg.vector_norm(sun)
    theta_s = _safe_arccos(torch.clamp(sun[2], 0.0, 1.0))
    cos_theta_s = torch.cos(theta_s)
    coef_y, coef_x, coef_yc = perez_coefficients(params.turbidity)
    yz, xz, yzc = zenith_values(params.turbidity, theta_s)
    one = torch.tensor(1.0)
    den = lambda coef: _perez(coef, one, theta_s, cos_theta_s)
    out = dict(
        sun=sun.tolist(),
        coef_y=coef_y.tolist(),
        coef_x=coef_x.tolist(),
        coef_yc=coef_yc.tolist(),
        zy=float(yz / den(coef_y) * params.exposure),
        zx=float(xz / den(coef_x)),
        zyc=float(yzc / den(coef_yc)),
        hosek=params.hw_params is not None,
        cos_gamma_as_angle=bool(params.cos_gamma_as_angle),
        hw=None,
    )
    if params.hw_params is not None:
        hw = params.hw_params.detach().to(torch.float32).clone()
        hw[:, 9] = hw[:, 9] * params.exposure.detach()
        out["hw"] = hw.tolist()
    return out
