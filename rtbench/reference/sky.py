"""The analytic daylight sky of the reference: Perez/Preetham (Preetham,
Shirley and Smits 1999, the published coefficient tables) and the
Hosek-Wilkie form, whose (turbidity, albedo, elevation) configurations are
interpolated from ``hw_dataset.npy`` (the dataset the renderer's sky ships,
as raw data), then the Uncharted2 filmic tonemap (exposure bias 1.1, white
point 11.2) on the radiance.

Two evaluations of one sky:

- ``frame_scalars`` + ``rows``: the per-frame scalars folded on the host
  (the zenith value over the Perez value at the zenith, the exposure in the
  luminance or in the Hosek scale column), then one evaluation per ray;
- ``live_rows``: every step on tensors from the sun direction, the
  turbidity and the exposure (the renderer's scalarized bounce).

A sky is described by a plain dict: ``{"model": "perez", "sun": [x, y, z],
"turbidity": t, "exposure": e}`` or ``{"model": "hosek", "sun": ...,
"turbidity": t, "albedo": a, "elevation": eta, "exposure": e}``.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

_PEREZ_Y = np.array(
    [[0.1787, -1.4630], [-0.3554, 0.4275], [-0.0227, 5.3251],
     [0.1206, -2.5771], [-0.0670, 0.3703]], np.float32)
_PEREZ_X = np.array(
    [[-0.0193, -0.2592], [-0.0665, 0.0008], [-0.0004, 0.2125],
     [-0.0641, -0.8989], [-0.0033, 0.0452]], np.float32)
_PEREZ_YC = np.array(
    [[-0.0167, -0.2608], [-0.0950, 0.0092], [-0.0079, 0.2102],
     [-0.0441, -1.6537], [-0.0109, 0.0529]], np.float32)
_ZENITH_X = np.array(
    [[0.00166, -0.00375, 0.00209, 0.0],
     [-0.02903, 0.06377, -0.03202, 0.00394],
     [0.11693, -0.21196, 0.06052, 0.25886]], np.float32)
_ZENITH_Y = np.array(
    [[0.00275, -0.00610, 0.00317, 0.0],
     [-0.04214, 0.08970, -0.04153, 0.00516],
     [0.15346, -0.26756, 0.06670, 0.26688]], np.float32)
XYZ_TO_SRGB = np.array(
    [[3.2404542, -1.5371385, -0.4985314],
     [-0.9692660, 1.8760108, 0.0415560],
     [0.0556434, -0.2040259, 1.0572252]], np.float32)

_DATASET = os.path.join(os.path.dirname(os.path.abspath(__file__)), "hw_dataset.npy")


def tonemap_curve(x):
    """The Uncharted2 curve (A=.15 B=.50 C=.10 D=.20 E=.02 F=.30)."""
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    return (x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f) - e / f


WHITE_SCALE = 1.0 / tonemap_curve(11.2)


def tonemap(v: torch.Tensor) -> torch.Tensor:
    return torch.clamp(WHITE_SCALE * tonemap_curve(1.1 * v), min=0.0)


def _arccos_safe(x: torch.Tensor) -> torch.Tensor:
    return torch.arccos(torch.clamp(x, -1.0 + 1.0e-6, 1.0 - 1.0e-6))


def _perez_coefficients(turbidity: torch.Tensor):
    t = turbidity
    coef = lambda tab: torch.from_numpy(tab[:, 0]).to(t.device) * t + torch.from_numpy(
        tab[:, 1]).to(t.device)
    return coef(_PEREZ_Y), coef(_PEREZ_X), coef(_PEREZ_YC)


def _perez(c, cos_theta, gamma, cos_gamma):
    return (1.0 + c[0] * torch.exp(c[1] / torch.clamp(cos_theta, min=0.01))) * (
        1.0 + c[2] * torch.exp(c[3] * gamma) + c[4] * cos_gamma * cos_gamma)


def _zenith(turbidity: torch.Tensor, theta_s: torch.Tensor):
    t = turbidity
    chi = (4.0 / 9.0 - t / 120.0) * (math.pi - 2.0 * theta_s)
    y_lum = (4.0453 * t - 4.9710) * torch.tan(chi) - 0.2155 * t + 2.4192
    tv = torch.stack([t * t, t, torch.ones_like(t)])
    sv = torch.stack([theta_s ** 3, theta_s ** 2, theta_s, torch.ones_like(theta_s)])
    x_z = tv @ torch.from_numpy(_ZENITH_X).to(t.device) @ sv
    y_z = tv @ torch.from_numpy(_ZENITH_Y).to(t.device) @ sv
    return y_lum, x_z, y_z


def hosek_rows(turbidity: float, albedo: float, elevation: float) -> torch.Tensor:
    """f32[3, 10] Hosek-Wilkie rows (A..I, scale), piecewise-linear over the
    dataset's grid: turbidity knots 1..10, albedo {0, 1}, elevation knots
    uniform in (2 eta / pi)^(1/3)."""
    params = torch.from_numpy(np.load(_DATASET))
    n_t, n_e = params.shape[0], params.shape[1]
    t = torch.clamp(torch.tensor(turbidity, dtype=torch.float32), 1.0, float(n_t)) - 1.0
    t0 = torch.clamp(torch.floor(t).to(torch.int64), 0, n_t - 2)
    tw = t - t0.to(torch.float32)
    eta = torch.clamp(torch.tensor(elevation, dtype=torch.float32), 0.0, math.pi / 2)
    x = torch.pow(eta * float(np.float32(2.0 / np.pi)), float(np.float32(1.0 / 3.0)))
    e = x * (n_e - 1)
    e0 = torch.clamp(torch.floor(e).to(torch.int64), 0, n_e - 2)
    ew = e - e0.to(torch.float32)
    aw = torch.clamp(torch.tensor(albedo, dtype=torch.float32), 0.0, 1.0)

    def at(ti, ei):
        p = params[ti, ei]
        return p[0] * (1.0 - aw) + p[1] * aw

    p0 = at(t0, e0) * (1.0 - ew) + at(t0, e0 + 1) * ew
    p1 = at(t0 + 1, e0) * (1.0 - ew) + at(t0 + 1, e0 + 1) * ew
    return p0 * (1.0 - tw) + p1 * tw


def unit_sun(sky: dict) -> torch.Tensor:
    sun = torch.tensor(sky.get("sun", [0.0, 0.0, 1.0]), dtype=torch.float32)
    return sun / torch.linalg.vector_norm(sun)


def frame_scalars(sky: dict) -> dict:
    """Per-frame scalars (python floats holding f32 values)."""
    sun = unit_sun(sky)
    turbidity = torch.tensor(sky["turbidity"], dtype=torch.float32)
    exposure = torch.tensor(sky["exposure"], dtype=torch.float32)
    out = dict(sun=sun.tolist(), hosek=sky["model"] == "hosek")
    if out["hosek"]:
        hw = hosek_rows(sky["turbidity"], sky["albedo"], sky["elevation"])
        hw[:, 9] = hw[:, 9] * exposure
        out["hw"] = hw.tolist()
        return out
    theta_s = _arccos_safe(torch.clamp(sun[2], 0.0, 1.0))
    cos_theta_s = torch.cos(theta_s)
    coef_y, coef_x, coef_yc = _perez_coefficients(turbidity)
    yz, xz, yzc = _zenith(turbidity, theta_s)
    one = torch.tensor(1.0)
    den = lambda coef: _perez(coef, one, theta_s, cos_theta_s)
    out.update(coef_y=coef_y.tolist(), coef_x=coef_x.tolist(), coef_yc=coef_yc.tolist(),
               zy=float(yz / den(coef_y) * exposure), zx=float(xz / den(coef_x)),
               zyc=float(yzc / den(coef_yc)))
    return out


def rows(sk: dict, dx, dy, dz):
    """Tonemapped sky radiance (r, g, b) toward unit direction rows, from
    ``frame_scalars``."""
    sx, sy, sz = sk["sun"]
    cos_theta = torch.clamp(dz, 0.01, 1.0)
    cos_gamma = torch.clamp(dx * sx + dy * sy + dz * sz, -1.0, 1.0)
    gamma = torch.arccos(torch.clamp(cos_gamma, -1.0 + 1e-6, 1.0 - 1e-6))
    if sk["hosek"]:
        sq = torch.sqrt(torch.clamp(cos_theta, min=0.0))
        out = []
        for a, b, c, d, e, f, g, h, i, sc in sk["hw"]:
            one_hh = float(np.float32(1.0) + np.float32(h) * np.float32(h))
            den = torch.clamp(one_hh - 2.0 * h * cos_gamma, min=1e-6)
            chi = (1.0 + cos_gamma * cos_gamma) / (den * torch.sqrt(den))
            val = (1.0 + a * torch.exp(b / torch.clamp(cos_theta, min=0.01))) * (
                c + d * torch.exp(e * gamma) + f * cos_gamma * cos_gamma + g * chi + i * sq)
            out.append(tonemap(torch.clamp(val * sc, min=0.0)))
        return tuple(out)
    y_lum = torch.clamp(_perez(sk["coef_y"], cos_theta, gamma, cos_gamma) * sk["zy"], min=0.0)
    x_c = _perez(sk["coef_x"], cos_theta, gamma, cos_gamma) * sk["zx"]
    y_c = torch.clamp(_perez(sk["coef_yc"], cos_theta, gamma, cos_gamma) * sk["zyc"], min=1e-6)
    big_x = x_c / y_c * y_lum
    big_z = (1.0 - x_c - y_c) / y_c * y_lum
    m = XYZ_TO_SRGB.tolist()
    return tuple(tonemap(torch.clamp(m[k][0] * big_x + m[k][1] * y_lum + m[k][2] * big_z,
                                     min=0.0)) for k in range(3))


def _max(x, c):
    return torch.maximum(x, torch.tensor(c, dtype=x.dtype))


def _min(x, c):
    return torch.minimum(x, torch.tensor(c, dtype=x.dtype))


def _clip(x, lo, hi):
    """Clip whose derivative splits at a tie with a bound, as a max/min
    pair does (the renderer's convention)."""
    return _min(_max(x, lo), hi)


def live_rows(sky: dict, sun_dir, turbidity, exposure, dx, dy, dz):
    """``rows`` with the sun direction, turbidity and exposure as tensors
    (for the Perez model; the Hosek rows are fixed), differentiable in all
    three."""
    dev = dx.device
    sun_dir = sun_dir.to(dev)
    sun = sun_dir / torch.sqrt(sun_dir[0] * sun_dir[0] + sun_dir[1] * sun_dir[1]
                               + sun_dir[2] * sun_dir[2])
    cos_theta = _clip(dz, 0.01, 1.0)
    cos_gamma = _clip(dx * sun[0] + dy * sun[1] + dz * sun[2], -1.0, 1.0)
    gamma = torch.arccos(_clip(cos_gamma, -1.0 + 1e-6, 1.0 - 1e-6))
    white = torch.full_like(dx[:1], 1.0) / tonemap_curve(torch.tensor(11.2, device=dev))
    tm = lambda x: _max(white * tonemap_curve(1.1 * x), 0.0)
    exposure = exposure.to(dev)
    if sky["model"] == "hosek":
        hw = hosek_rows(sky["turbidity"], sky["albedo"], sky["elevation"]).to(dev)
        sq = torch.sqrt(torch.clamp(cos_theta, min=0.0))
        out = []
        for ch in range(3):
            a, b, c, d, e, f, g, h, i_ = (hw[ch, k] for k in range(9))
            h = torch.clamp(h, -0.999, 0.999)
            chi = (1.0 + cos_gamma * cos_gamma) / torch.pow(
                torch.clamp(1.0 + h * h - 2.0 * h * cos_gamma, min=1e-6), 1.5)
            val = (1.0 + a * torch.exp(b / torch.clamp(cos_theta, min=0.01))) * (
                c + d * torch.exp(e * gamma) + f * cos_gamma * cos_gamma + g * chi + i_ * sq)
            out.append(tm(torch.clamp(val * hw[ch, 9], min=0.0) * exposure))
        return tuple(out)
    turbidity = turbidity.to(dev)
    theta_s = torch.arccos(_clip(sun[2], 0.0, 1.0 - 1e-6))
    cos_theta_s = torch.cos(theta_s)
    coef_y, coef_x, coef_yc = _perez_coefficients(turbidity)
    yz, xz, yz_c = _zenith(turbidity, theta_s)
    one = torch.tensor(1.0, device=dev)

    def channel(coef, zenith):
        return zenith * _perez(coef, cos_theta, gamma, cos_gamma) / _perez(
            coef, one, theta_s, cos_theta_s)

    y_lum = _max(channel(coef_y, yz), 0.0) * exposure
    x_c = channel(coef_x, xz)
    y_c = _max(channel(coef_yc, yz_c), 1e-6)
    big_x = x_c / y_c * y_lum
    big_z = (1.0 - x_c - y_c) / y_c * y_lum
    m = XYZ_TO_SRGB.tolist()
    return tuple(tm(_max(m[k][0] * big_x + m[k][1] * y_lum + m[k][2] * big_z, 0.0))
                 for k in range(3))
