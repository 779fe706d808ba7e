"""The upstream's Sponza scene (``sponza()``, scenes.rs:443-458): a procedural
stand-in for the Crytek Sponza atrium (Frank Meinl, Crytek; Khronos
glTF-Sample-Models ``2.0/Sponza``), which the upstream loads from a user path
that does not ship.

The stand-in follows the public scene's layout, in metres, z up, the long
axis along x:

- a courtyard of 30 x 13 m between two arcades, open to the sky, on a
  stone floor of 30 x 20 m that runs under the arcades' aisles;
- on each long side two storeys of arcades: ten fluted columns a storey
  (a plinth, a base moulding, a shaft with entasis and flutes, a capital
  and an abacus), nine round arches between them in a wall 0.6 m thick,
  the gallery's floor slab over the ground aisle and the roof slab over the
  upper one;
- outer walls and end walls 0.7 m thick, 12.6 m high;
- eight drapes hanging in the upper arches from iron rods, thin closed
  slabs displaced by waves that deepen toward their hems;
- eight vases of plants along the arcades: turned shells with displaced
  bellies, each under a displaced sphere of leaves.

Every solid's faces face out of it (the triangles' winding), so that back-face
culling meets them from the courtyard; a face that lies against another
solid (a wall's end against the end wall, a slab on the arches) is left out,
and no two faces are coplanar and overlapping.  Every UV lies in [0, 1]:
each surface maps its extent onto its texture once, the tiling baked into
the texture (the upstream clamps UVs, texture.rs:107-118).

Materials: 25, one glTF primitive each, each with its own procedural
base-colour PNG (``texture`` x ``texture`` texels, 8-bit RGB, filter 0):
tiles, brick, ashlar, stone, marble, fabric, terracotta, foliage, bronze and
iron.  Two are metal by ``metallicFactor`` (the bronze vases and the iron
rods); the mapping is the renderer's corrected one (metallic >= 0.5 is metal
with fuzz = roughness, else lambertian).

Everything is drawn from the configuration's seed: each texture from
``default_rng([seed, 1, k])`` for material k, the drapes', vases' and
plants' shapes from ``default_rng([seed, 2])`` in scene order.
``write_inputs`` writes the glb (one buffer; a mesh of one non-indexed
primitive a material, its PNG in a buffer view) that the program loads
through its glTF loader (``rtbench/scenes/sponza.py``); ``describe`` gives
the reference the same scene from the raw arrays and texels, never from the
file or the loader.  Scene order: each primitive's texture, material and
triangles, in the glb's order.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct

import numpy as np

from rtbench.inputs import car

# The layout (m).
HALF_X = 15.0        # the end walls' inner faces at x = +-HALF_X
HALF_Y = 10.0        # the outer walls' inner faces at y = +-HALF_Y
WALL_T = 0.7         # outer and end walls' thickness
WALL_H = 12.6        # their height
ARC_Y = 6.5          # the column axes' |y|
ARC_FRONT, ARC_BACK = 6.2, 6.8  # the arch wall's faces' |y|
STOREY = 6.0         # the gallery floor's top above the ground floor
SPRING = 4.0         # the arches' springing line above a storey's floor
ARCH_TOP = 5.6       # the arch wall's top (the slab's underside) above it
SLAB = 0.4           # the gallery and roof slabs' thickness
COLUMNS = 10         # columns a storey and side, 3 m apart
PITCH = 3.0
ARCH_R = 1.3         # arch radius: 0.2 m of impost on each side of a column
FLOOR_T = 0.3

# A column's turned profile above its storey's floor: (height, radius), the
# shaft between the sixth and seventh points (more rings go there, fluted).
COLUMN_PROFILE = ((0.00, 0.46), (0.20, 0.46), (0.24, 0.42), (0.30, 0.40), (0.36, 0.35),
                  (0.42, 0.33), (3.40, 0.29), (3.48, 0.31), (3.56, 0.31), (3.76, 0.40),
                  (3.80, 0.50), (SPRING - 0.02, 0.50))
SHAFT = (5, 6)
UPPER_SCALE = 0.85   # the upper storey's columns are slimmer
# A vase's profile above the floor, and its mouth, closed by the soil's disc.
VASE_PROFILE = ((0.00, 0.22), (0.08, 0.25), (0.12, 0.18), (0.35, 0.30), (0.60, 0.42),
                (0.85, 0.34), (0.95, 0.30), (1.00, 0.36))
BAYS_HUNG = (1, 3, 5, 7)   # the bays that hold a drape (upper storey) and a vase

# The materials in primitive order: (name, texture kind, base colour,
# metallic, roughness).
MATERIALS = (
    ("floor", "tiles", (0.62, 0.58, 0.52), 0.0, 0.9),
    ("wall_north", "brick", (0.56, 0.33, 0.24), 0.0, 0.9),
    ("wall_south", "brick", (0.52, 0.36, 0.27), 0.0, 0.9),
    ("wall_east", "ashlar", (0.66, 0.61, 0.52), 0.0, 0.9),
    ("wall_west", "ashlar", (0.63, 0.60, 0.55), 0.0, 0.9),
    ("gallery_north", "stone", (0.60, 0.57, 0.50), 0.0, 0.9),
    ("gallery_south", "stone", (0.58, 0.56, 0.51), 0.0, 0.9),
    ("roof_north", "stone", (0.42, 0.40, 0.37), 0.0, 0.9),
    ("roof_south", "stone", (0.44, 0.41, 0.36), 0.0, 0.9),
    ("arches_ground", "ashlar", (0.70, 0.64, 0.54), 0.0, 0.9),
    ("arches_upper", "ashlar", (0.68, 0.63, 0.56), 0.0, 0.9),
    ("columns_ground", "marble", (0.78, 0.75, 0.68), 0.0, 0.6),
    ("columns_upper", "marble", (0.74, 0.72, 0.67), 0.0, 0.6),
    ("drape_north_1", "fabric", (0.62, 0.08, 0.07), 0.0, 1.0),
    ("drape_north_3", "fabric", (0.08, 0.36, 0.12), 0.0, 1.0),
    ("drape_north_5", "fabric", (0.08, 0.12, 0.52), 0.0, 1.0),
    ("drape_north_7", "fabric", (0.66, 0.48, 0.10), 0.0, 1.0),
    ("drape_south_1", "fabric", (0.08, 0.36, 0.12), 0.0, 1.0),
    ("drape_south_3", "fabric", (0.62, 0.08, 0.07), 0.0, 1.0),
    ("drape_south_5", "fabric", (0.66, 0.48, 0.10), 0.0, 1.0),
    ("drape_south_7", "fabric", (0.08, 0.12, 0.52), 0.0, 1.0),
    ("vases_north", "terracotta", (0.64, 0.34, 0.20), 0.0, 0.8),
    ("vases_south", "bronze", (0.60, 0.42, 0.22), 1.0, 0.35),
    ("plants", "foliage", (0.18, 0.38, 0.10), 0.0, 1.0),
    ("rods", "iron", (0.30, 0.30, 0.32), 1.0, 0.5),
)


# -- textures ---------------------------------------------------------------


def _value_noise(g, n: int, cells: int) -> np.ndarray:
    """f32[n, n] in [0, 1]: a (cells + 1)^2 grid of uniform draws,
    smoothstep-interpolated."""
    grid = g.random((cells + 1, cells + 1), dtype=np.float32)
    t = np.arange(n, dtype=np.float32) * np.float32(cells / n)
    i = t.astype(np.int64)
    f = t - i
    f = f * f * (3.0 - 2.0 * f)
    rows = grid[i] * (1.0 - f)[:, None] + grid[i + 1] * f[:, None]
    return rows[:, i] * (1.0 - f)[None, :] + rows[:, i + 1] * f[None, :]


def _fbm(g, n: int, base: int = 4, octaves: int = 5) -> np.ndarray:
    """f32[n, n] in [0, 1]: octaves of value noise, each twice as fine and
    half as strong."""
    out, total = np.zeros((n, n), np.float32), 0.0
    for k in range(octaves):
        w = 0.5 ** k
        out += np.float32(w) * _value_noise(g, n, min(base << k, n))
        total += w
    return out / np.float32(total)


def _bond(n: int, rows: int, per_row: int, mortar: float, stagger: bool):
    """(brick id int64[n, n], joint mask bool[n, n]) of ``rows`` courses of
    ``per_row`` bricks, every other course shifted by half a brick when
    ``stagger``; joints ``mortar`` of a course high."""
    v = (np.arange(n) + 0.5) / n * rows
    row = v.astype(np.int64)
    odd = (row % 2 == 1) & stagger
    uu = (np.arange(n) + 0.5) / n * per_row + np.array([0.0, 0.5])[:, None]  # [parity, n]
    col = np.floor(uu).astype(np.int64) % per_row
    fu, fv = uu - np.floor(uu), v - row
    joint_u = np.minimum(fu, 1.0 - fu) < mortar * per_row / rows
    joint_v = np.minimum(fv, 1.0 - fv) < mortar
    return row[:, None] * per_row + col[odd.astype(np.int64)], joint_u[odd.astype(
        np.int64)] | joint_v[:, None]


# Running bonds: (courses, bricks a course, joint share of a course, staggered).
BONDS = {"tiles": (10, 15, 0.025, False), "brick": (96, 120, 0.1, True),
         "ashlar": (16, 10, 0.03, True)}


def texture(kind: str, color, n: int, g) -> np.ndarray:
    """u8[n, n, 3]: a procedural base colour of ``kind`` around ``color``,
    its tiling baked in, drawn from ``g``: a mottling at a quarter of the
    resolution, the kind's pattern at full resolution, and a grain of up to
    6% a texel."""
    c = np.asarray(color, np.float32)
    m = max(n // 4, 1)
    up = np.arange(n) * m // n
    noise = _fbm(g, m)
    if kind == "marble":  # veins across the column
        x = np.arange(m, dtype=np.float32)[None, :] / m
        vein = np.abs(np.sin(np.float32(2.0 * np.pi) * (3.0 * x + 4.0 * noise)))
        shade = (0.85 + 0.2 * noise) * (0.8 + 0.2 * np.sqrt(vein))
    elif kind == "foliage":  # leaves over the mottling
        shade = (0.5 + 0.9 * noise) * (0.6 + 0.6 * _value_noise(g, m, min(64, m)))
    else:
        shade = 0.75 + 0.4 * noise
    grain = g.random((n, n), dtype=np.float32)
    field = shade[up][:, up] * (0.94 + 0.06 * grain)
    if kind in BONDS:
        rows, per_row, mortar, stagger = BONDS[kind]
        ids, joint = _bond(n, rows, per_row, mortar, stagger)
        tint = c * (g.uniform(0.8, 1.15, (rows * per_row, 1)) * g.uniform(
            0.95, 1.05, (rows * per_row, 3))).astype(np.float32)
        tint = np.concatenate([tint, np.full((1, 3), 0.55 * c.mean() + 0.1, np.float32)])
        rgb = field[..., None] * tint[np.where(joint, rows * per_row, ids)]
    elif kind == "fabric":  # a weave of 4 texels, gold bands near the hems and down the middle
        f = np.arange(n, dtype=np.float32) / n
        wave = np.sin(np.float32(2.0 * np.pi * n / 4) * f)
        field *= 0.8 + 0.15 * (0.5 + 0.5 * wave[:, None] * wave[None, :])
        bands = ((np.abs(f - 0.08) < 0.03) | (np.abs(f - 0.92) < 0.03))[:, None] | (
            np.abs(f - 0.5) < 0.02)[None, :]
        rgb = field[..., None] * np.stack([c, np.array([0.72, 0.58, 0.22], np.float32)])[
            bands.astype(np.int64)]
    else:
        rgb = field[..., None] * c
    rgb *= 255.0
    np.rint(rgb, out=rgb)
    return np.clip(rgb, 0, 255, out=rgb).astype(np.uint8)


# -- geometry ---------------------------------------------------------------
# A piece is (triangles f32[T, 3, 3], UVs f32[T, 3, 2]); a triangle faces
# the side its (b - a) x (c - a) points to.


def _quads(grid: np.ndarray, uv: np.ndarray):
    """The triangles of a [I + 1, J + 1] vertex grid, two a cell (a, b, c)
    and (a, c, d) with a = [i, j], b = [i, j + 1], c = [i + 1, j + 1],
    d = [i + 1, j]: they face (b - a) x (d - a)."""
    a, b = grid[:-1, :-1], grid[:-1, 1:]
    c, d = grid[1:, 1:], grid[1:, :-1]
    ua, ub, uc, ud = uv[:-1, :-1], uv[:-1, 1:], uv[1:, 1:], uv[1:, :-1]
    tri = np.stack([np.stack([a, b, c], -2), np.stack([a, c, d], -2)], 2).reshape(-1, 3, 3)
    tuv = np.stack([np.stack([ua, ub, uc], -2), np.stack([ua, uc, ud], -2)], 2).reshape(-1, 3, 2)
    return tri, tuv


def _rect(axis: int, sign: int, at: float, lo, hi, cell: float):
    """A rectangle in the plane x[axis] = ``at`` over ``lo``..``hi`` of the
    other two axes (in x, y, z order), facing ``sign`` along ``axis``, cut
    into cells of at most ``cell``.  UVs: u along the first horizontal axis
    of the plane, v down from its top (or along y on a horizontal face)."""
    p, q = [k for k in range(3) if k != axis]
    n_p = max(1, int(np.ceil((hi[0] - lo[0]) / cell - 1e-9)))
    n_q = max(1, int(np.ceil((hi[1] - lo[1]) / cell - 1e-9)))
    fp, fq = np.linspace(0.0, 1.0, n_p + 1), np.linspace(0.0, 1.0, n_q + 1)
    grid = np.zeros((n_q + 1, n_p + 1, 3))
    grid[..., axis] = at
    grid[..., p] = lo[0] + (hi[0] - lo[0]) * fp[None, :]
    grid[..., q] = lo[1] + (hi[1] - lo[1]) * fq[:, None]
    uv = np.stack([np.broadcast_to(fp[None, :], (n_q + 1, n_p + 1)),
                   np.broadcast_to(1.0 - fq[:, None], (n_q + 1, n_p + 1))], -1)
    if (sign > 0) != ((axis + 1) % 3 == p):  # the cells face p x q: turn them over
        grid, uv = grid.transpose(1, 0, 2), uv.transpose(1, 0, 2)
    return _quads(grid, uv)


def _box(lo, hi, faces: str, cell: float, fine: str = ""):
    """The listed faces ("+x", "-x", "+y", "-y", "+z", "-z") of a box, each
    facing out of it: those in ``fine`` cut into cells of at most ``cell``,
    the others (which face away from the courtyard) one cell each."""
    out = []
    for f in faces.split():
        axis, sign = "xyz".index(f[1]), 1 if f[0] == "+" else -1
        rest = [k for k in range(3) if k != axis]
        out.append(_rect(axis, sign, (hi if sign > 0 else lo)[axis], [lo[k] for k in rest],
                         [hi[k] for k in rest], cell if f in fine.split() else np.inf))
    return out


def _lathe(profile, sides: int, center, flute_rings=(), flutes: int = 0, depth: float = 0.0,
           disp=None):
    """A turned surface about the vertical through ``center`` (x, y, z of the
    profile's foot): rings at the profile's (height, radius) points, its
    sides facing out, fluted on ``flute_rings`` (``flutes`` grooves of
    relative ``depth``), radii times 1 + ``disp(t, theta)`` where given (t
    the ring's height over the profile's), and a flat top cap facing up.
    No bottom: a turned solid stands on another."""
    z = np.array([p[0] for p in profile])
    r = np.array([p[1] for p in profile])
    theta = 2.0 * np.pi * np.arange(sides + 1) / sides
    rad = np.repeat(r[:, None], sides + 1, 1)
    if flutes:
        groove = 1.0 - depth * 0.5 * (1.0 - np.cos(flutes * theta))
        rad[list(flute_rings)] *= groove[None, :]
    if disp is not None:
        rad *= 1.0 + disp((z / z[-1])[:, None], theta[None, :])
    cx, cy, cz = center
    grid = np.stack([cx + rad * np.cos(theta), cy + rad * np.sin(theta),
                     np.repeat(cz + z[:, None], sides + 1, 1)], -1)
    uv = np.stack(np.broadcast_arrays(theta[None, :] / (2.0 * np.pi),
                                      1.0 - (z / z[-1])[:, None]), -1)
    tri, tuv = _quads(grid, uv)  # (b - a) x (d - a): around, then up: outward
    top = grid[-1]
    mid = np.array([cx, cy, cz + z[-1]])
    reach = np.abs(top[:, :2] - mid[:2]).max()
    cuv = 0.5 + 0.5 * (top[:, :2] - mid[:2]) / reach
    ctri = np.stack([np.broadcast_to(mid, (sides, 3)), top[:-1], top[1:]], 1)
    cuvs = np.stack([np.full((sides, 2), 0.5), cuv[:-1], cuv[1:]], 1)
    return np.concatenate([tri, ctri]), np.concatenate([tuv, cuvs])


def _column_profile(rings: int, scale: float):
    """COLUMN_PROFILE with ``rings`` points in all (more in the shaft),
    radii times ``scale``; and the shaft's ring indices."""
    extra = max(rings - len(COLUMN_PROFILE), 0)
    (z0, r0), (z1, r1) = COLUMN_PROFILE[SHAFT[0]], COLUMN_PROFILE[SHAFT[1]]
    f = np.arange(1, extra + 1) / (extra + 1)
    shaft = [(z0 + (z1 - z0) * t, r0 + (r1 - r0) * t) for t in f]
    prof = list(COLUMN_PROFILE[:SHAFT[1]]) + shaft + list(COLUMN_PROFILE[SHAFT[1]:])
    return [(zz, rr * scale) for zz, rr in prof], range(SHAFT[0], SHAFT[1] + extra + 1)


def _arch_wall(z0: float, segs: int, cell: float):
    """The +y side's arch wall of the storey at ``z0``: its courtyard face
    (y = ARC_FRONT, facing -y) and aisle face (ARC_BACK, +y) with nine round
    arches between the columns, the arches' soffits facing their axes, and
    the imposts' undersides; its top and ends lie against the slab and the
    end walls."""
    zs, zt = z0 + SPRING, z0 + ARCH_TOP
    xs = -HALF_X + PITCH / 2 + PITCH * np.arange(COLUMNS)
    gap = PITCH / 2 - ARCH_R
    # The arch's angles, with the rectangle's corners as seen from its centre.
    corner = np.arctan2(zt - zs, PITCH / 2)
    ang = np.unique(np.concatenate([np.linspace(np.pi, 0.0, segs + 1), [corner,
                                                                        np.pi - corner]]))[::-1]
    c, s = np.cos(ang), np.sin(ang)
    # Where the ray from an arch's centre at each angle leaves its bay's
    # rectangle, PITCH wide and zt - zs high.
    with np.errstate(divide="ignore"):
        reach = np.minimum(PITCH / 2 / np.abs(c), (zt - zs) / np.abs(s))
    out = []
    for face_y, sign in ((ARC_FRONT, -1), (ARC_BACK, 1)):
        for k in range(COLUMNS - 1):
            cx = xs[k] + PITCH / 2
            st = np.stack([np.stack([cx + ARCH_R * c, zs + ARCH_R * s], -1),
                           np.stack([cx + reach * c, zs + reach * s], -1)])  # [2, A, (x, z)]
            grid = np.zeros(st.shape[:2] + (3,))
            grid[..., 0], grid[..., 1], grid[..., 2] = st[..., 0], face_y, st[..., 1]
            uv = np.stack([(st[..., 0] + HALF_X) / (2 * HALF_X), (zt - st[..., 1]) / (zt - zs)],
                          -1)
            # grid[0] is the arc, grid[1] the rectangle, the angle from pi
            # down to 0: the cells face -y; turned over for the aisle face.
            if sign > 0:
                grid, uv = grid[:, ::-1], uv[:, ::-1]
            out.append(_quads(grid, np.clip(uv, 0.0, 1.0)))
        for lo, hi in (((-HALF_X, zs), (xs[0], zt)), ((xs[-1], zs), (HALF_X, zt))):
            out.append(_rect(1, sign, face_y, lo, hi, cell))
    for k in range(COLUMNS - 1):  # the soffits, facing the arches' axes
        cx = xs[k] + PITCH / 2
        grid = np.stack([np.stack([cx + ARCH_R * c, np.full(len(ang), y), zs + ARCH_R * s], -1)
                         for y in (ARC_FRONT, ARC_BACK)], 0)
        uv = np.stack(np.broadcast_arrays(np.linspace(0.0, 1.0, len(ang))[None, :],
                                          np.array([0.0, 1.0])[:, None]), -1)
        out.append(_quads(grid[:, ::-1], uv[:, ::-1]))
    imposts = [(-HALF_X, xs[0] + gap)] + [(x - gap, x + gap) for x in xs[1:-1]] + [
        (xs[-1] - gap, HALF_X)]
    for x0, x1 in imposts:
        out.append(_rect(2, -1, zs, (x0, ARC_FRONT), (x1, ARC_BACK), cell))
    return out


def _slab(z0: float, cell: float):
    """The +y side's slab whose underside lies at ``z0`` (the gallery's
    floor, or the roof): its top, its front edge toward the courtyard and
    its underside over the aisle."""
    z1 = z0 + SLAB
    return [_rect(2, 1, z1, (-HALF_X, ARC_FRONT), (HALF_X, HALF_Y), cell),
            _rect(1, -1, ARC_FRONT, (-HALF_X, z0), (HALF_X, z1), cell),
            _rect(2, -1, z0, (-HALF_X, ARC_BACK), (HALF_X, HALF_Y), cell)]


def _drape(g, cx: float, across: int, down: int):
    """A drape in the upper arch centred at ``cx`` on the +y side: a closed
    slab 3 cm thick, 1.8 m wide, from 6.4 m to 10.78 m, its mid-surface
    displaced along y by a sum of three waves across it that deepen toward
    the hem; both faces, the two sides, the top and the hem."""
    x0, x1, zb, zt, thick = cx - 0.9, cx + 0.9, STOREY + 0.4, STOREY + SPRING + 0.78, 0.03
    freq, phase, amp = g.uniform(1.0, 4.0, 3), g.uniform(0.0, 2.0 * np.pi, 3), g.uniform(
        0.02, 0.05, 3)
    u = np.linspace(0.0, 1.0, across + 1)
    v = np.linspace(0.0, 1.0, down + 1)  # 0 at the top
    wave = sum(a * np.sin(2.0 * np.pi * f * u + p) for f, p, a in zip(freq, phase, amp))
    mid = ARC_Y + wave[None, :] * (0.4 + 0.6 * v[:, None])
    xx = np.broadcast_to(x0 + (x1 - x0) * u[None, :], mid.shape)
    zz = np.broadcast_to(zt - (zt - zb) * v[:, None], mid.shape)
    uv = np.stack(np.broadcast_arrays(u[None, :], v[:, None]), -1)

    def surface(dy):
        return np.stack([xx, mid + dy, zz], -1)

    front, back = surface(-thick / 2), surface(thick / 2)
    out = [_quads(front[:, ::-1], uv[:, ::-1]),  # (-x) x (-z): -y
           _quads(back, uv)]  # (+x) x (-z): +y
    rims = [(back[:, 0], front[:, 0]), (front[:, -1], back[:, -1]),  # -x and +x, down the edge
            (front[0], back[0]), (back[-1], front[-1])]  # top and hem, along x
    for p, q in rims:
        grid = np.stack([p, q], 0)
        ruv = np.stack(np.broadcast_arrays(np.linspace(0.0, 1.0, len(p))[None, :],
                                           np.array([0.0, 1.0])[:, None]), -1)
        out.append(_quads(grid, ruv))
    return out


def _vase(g, center, sides: int, rings: int):
    """A turned vase on the floor at ``center`` (VASE_PROFILE resampled to
    ``rings`` heights), its belly displaced by four sines, closed at the
    mouth by the soil's disc."""
    zs = np.linspace(0.0, VASE_PROFILE[-1][0], rings)
    rs = np.interp(zs, [p[0] for p in VASE_PROFILE], [p[1] for p in VASE_PROFILE])
    freq, phase, amp = g.uniform(1.0, 6.0, (4, 2)), g.uniform(0.0, 2.0 * np.pi, 4), g.uniform(
        0.01, 0.04, 4)
    freq[:, 1] = np.round(freq[:, 1])  # whole waves around, so the seam closes

    def disp(t, th):
        belly = np.sin(np.pi * t)
        return belly * sum(a * np.sin(f1 * np.pi * t + f2 * th + p)
                           for (f1, f2), p, a in zip(freq, phase, amp))

    return [_lathe(list(zip(zs, rs)), sides, center, disp=disp)]


def _plant(g, center, res: int):
    """A sphere of leaves over a vase: radius 0.5 about ``center``, displaced
    by six sines (up to +-40%), on a ``res`` x ``res`` latitude-longitude
    grid whose poles are closed by fans; facing out."""
    freq, phase, amp = g.uniform(2.0, 9.0, (6, 2)), g.uniform(0.0, 2.0 * np.pi, 6), g.uniform(
        0.02, 0.07, 6)
    freq[:, 1] = np.round(freq[:, 1])  # whole waves around, so the seam closes
    lat = np.linspace(0.0, np.pi, res + 2)[1:-1]  # rings between the poles
    lon = 2.0 * np.pi * np.arange(res + 1) / res
    tt, pp = np.meshgrid(lat, lon, indexing="ij")
    r = 0.5 * (1.0 + sum(a * np.sin(f1 * tt + f2 * pp + p)
                         for (f1, f2), p, a in zip(freq, phase, amp)))
    cx, cy, cz = center
    grid = np.stack([cx + r * np.sin(tt) * np.cos(pp), cy + r * np.sin(tt) * np.sin(pp),
                     cz + r * np.cos(tt)], -1)
    uv = np.stack([pp / (2.0 * np.pi), tt / np.pi], -1)
    tri, tuv = _quads(grid[::-1], uv[::-1])  # bottom ring first: around, then up: outward
    north, south = np.array([cx, cy, cz + 0.5]), np.array([cx, cy, cz - 0.5])
    n = res
    caps = [np.stack([np.broadcast_to(north, (n, 3)), grid[0, :-1], grid[0, 1:]], 1),
            np.stack([np.broadcast_to(south, (n, 3)), grid[-1, 1:], grid[-1, :-1]], 1)]
    cuv = [np.stack([np.broadcast_to([0.5, 0.0], (n, 2)), uv[0, :-1], uv[0, 1:]], 1),
           np.stack([np.broadcast_to([0.5, 1.0], (n, 2)), uv[-1, 1:], uv[-1, :-1]], 1)]
    return [(np.concatenate([tri] + caps), np.concatenate([tuv] + cuv))]


def _mirror(pieces, axis: int = 1):
    """The pieces mirrored across the plane x[axis] = 0 (to the -y side, or
    the -x end), still facing out."""
    out = []
    for tri, uv in pieces:
        tri = tri.copy()
        tri[..., axis] = -tri[..., axis]
        out.append((tri[:, ::-1], uv[:, ::-1]))
    return out


def _geometry(sc: dict) -> list[list]:
    """Each material's pieces, in MATERIALS' order."""
    cell = float(sc["cell"])
    col, arch, drape = sc["column"], int(sc["arch_segments"]), sc["drape"]
    vase, plant = sc["vase"], int(sc["plant_res"])
    g = np.random.default_rng([int(sc["seed"]), 2])
    hx, hy, wt = HALF_X, HALF_Y, WALL_T
    xs = -HALF_X + PITCH / 2 + PITCH * np.arange(COLUMNS)
    bay_x = [xs[k] + PITCH / 2 for k in BAYS_HUNG]

    floor = _box((-hx, -hy, -FLOOR_T), (hx, hy, 0.0), "+z -z +x -x +y -y", cell, "+z")
    # The end walls lie between the outer walls: their sides are left out.
    wall_n = _box((-hx - wt, hy, 0.0), (hx + wt, hy + wt, WALL_H), "-y +y +z -z +x -x", cell,
                  "-y")
    wall_e = _box((hx, -hy, 0.0), (hx + wt, hy, WALL_H), "-x +x +z -z", cell, "-x")
    gallery_n = _slab(ARCH_TOP, cell)
    roof_n = _slab(STOREY + ARCH_TOP, cell)
    arches = [_arch_wall(0.0, arch, cell), _arch_wall(STOREY, arch, cell)]
    columns = []
    for z0, scale in ((0.0, 1.0), (STOREY, UPPER_SCALE)):
        prof, shaft = _column_profile(int(col["rings"]), scale)
        sides = int(col["sides"])
        one = [_lathe(prof, sides, (x, ARC_Y, z0), shaft, sides // 4, 0.06) for x in xs]
        columns.append(one + _mirror(one))
    drapes = {}
    for side in (1, -1):
        for k, cx in zip(BAYS_HUNG, bay_x):
            d = _drape(g, cx, int(drape["across"]), int(drape["down"]))
            drapes[(side, k)] = d if side > 0 else _mirror(d)
    vases, plants = {1: [], -1: []}, []
    for side in (1, -1):
        for cx in bay_x:
            center = (cx, side * (ARC_FRONT - 1.2), 0.0)
            vases[side] += _vase(g, center, int(vase["sides"]), int(vase["rings"]))
            plants += _plant(g, (center[0], center[1], 1.42), plant)
    rods = []
    for side in (1, -1):
        for cx in bay_x:
            box = _box((cx - 0.92, ARC_Y - 0.03, STOREY + SPRING + 0.80),
                       (cx + 0.92, ARC_Y + 0.03, STOREY + SPRING + 0.86), "+x -x +y -y +z -z",
                       cell, "+x -x +y -y +z -z")
            rods += box if side > 0 else _mirror(box)
    both = lambda p: p + _mirror(p)
    return [floor, wall_n, _mirror(wall_n), wall_e, _mirror(wall_e, 0), gallery_n,
            _mirror(gallery_n), roof_n, _mirror(roof_n), both(arches[0]), both(arches[1]),
            columns[0], columns[1]] + [drapes[(s, k)] for s in (1, -1) for k in BAYS_HUNG] + [
        vases[1], vases[-1], plants, rods]


def primitives(sc: dict) -> list[dict]:
    """Each material's primitive, in MATERIALS' order: its name, triangles
    f32[T, 3, 3], UVs f32[T, 3, 2], texels u8[n, n, 3], metallic and
    roughness factors."""
    n, seed = int(sc["texture"]), int(sc["seed"])
    out = []
    for k, (pieces, (name, kind, color, metallic, roughness)) in enumerate(
            zip(_geometry(sc), MATERIALS)):
        tri = np.concatenate([t for t, _ in pieces]).astype(np.float32)
        uv = np.clip(np.concatenate([u for _, u in pieces]), 0.0, 1.0).astype(np.float32)
        texels = texture(kind, color, n, np.random.default_rng([seed, 1, k]))
        out.append(dict(name=name, tri=tri, uv=uv, texels=texels, metallic=metallic,
                        roughness=roughness))
    return out


def write_glb(path: str, prims: list[dict]) -> None:
    """Write the primitives as a glb (one buffer; per primitive a mesh of one
    non-indexed primitive with POSITION and TEXCOORD_0 accessors, and a
    material whose base colour is a PNG in a buffer view), under a temporary
    name renamed when complete."""
    blob = bytearray()
    views, accessors, meshes, materials, images, textures = [], [], [], [], [], []

    def view(data: bytes) -> int:
        blob.extend(b"\x00" * (-len(blob) % 4))
        views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": len(data)})
        blob.extend(data)
        return len(views) - 1

    for k, p in enumerate(prims):
        pos, uv = p["tri"].reshape(-1, 3), p["uv"].reshape(-1, 2)
        accessors.append({"bufferView": view(pos.tobytes()), "componentType": 5126,
                          "count": len(pos), "type": "VEC3",
                          "min": pos.min(0).tolist(), "max": pos.max(0).tolist()})
        accessors.append({"bufferView": view(uv.tobytes()), "componentType": 5126,
                          "count": len(uv), "type": "VEC2"})
        images.append({"bufferView": view(car._png(p["texels"])), "mimeType": "image/png"})
        textures.append({"source": k})
        materials.append({"name": p["name"],
                          "pbrMetallicRoughness": {"baseColorTexture": {"index": k},
                                                   "metallicFactor": p["metallic"],
                                                   "roughnessFactor": p["roughness"]}})
        meshes.append({"name": p["name"], "primitives": [
            {"attributes": {"POSITION": 2 * k, "TEXCOORD_0": 2 * k + 1}, "material": k}]})
    blob.extend(b"\x00" * (-len(blob) % 4))
    doc = {"asset": {"version": "2.0"}, "buffers": [{"byteLength": len(blob)}],
           "bufferViews": views, "accessors": accessors, "meshes": meshes,
           "materials": materials, "images": images, "textures": textures,
           "nodes": [{"mesh": k} for k in range(len(prims))],
           "scenes": [{"nodes": list(range(len(prims)))}], "scene": 0}
    jb = json.dumps(doc).encode()
    jb += b" " * (-len(jb) % 4)
    head = b"glTF" + struct.pack("<II", 2, 12 + 8 + len(jb) + 8 + len(blob))
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(head + struct.pack("<II", len(jb), 0x4E4F534A) + jb)
        f.write(struct.pack("<II", len(blob), 0x004E4942))
        f.write(blob)
    os.replace(tmp, path)


def glb_path(scene: dict, build_dir: str) -> str:
    """The atrium's glb in ``build_dir``, named by a digest of the
    generator's parameters."""
    params = {k: v for k, v in scene.items() if k not in ("generator", "sky")}
    tag = hashlib.sha256(json.dumps(params, sort_keys=True).encode()).hexdigest()[:16]
    return os.path.join(build_dir, f"sponza_{tag}.glb")


def write_inputs(config: dict, build_dir: str) -> None:
    """Write the atrium's glb once."""
    path = glb_path(config["scene"], build_dir)
    if not os.path.exists(path):
        write_glb(path, primitives(config["scene"]))


def tiny(scene: dict) -> dict:
    """The scene cut to a CPU test's size: the same primitives and
    materials, coarse (~5,500 triangles), with 32x32 textures."""
    return dict(scene, texture=32, cell=8.0, column={"sides": 4, "rings": len(COLUMN_PROFILE)},
                arch_segments=4, drape={"across": 2, "down": 3}, vase={"sides": 6, "rings": 4},
                plant_res=4)


def describe(config: dict) -> dict:
    """The scene's description: each primitive's texture (its texels / 255),
    material and triangles, in the glb's order."""
    sc = config["scene"]
    textures, materials, tri, uvs, mats = [], [], [], [], []
    for p in primitives(sc):
        textures.append({"kind": "image", "image": p["texels"].astype(np.float32) / 255.0})
        kind = "metal" if p["metallic"] >= 0.5 else "lambertian"
        materials.append({"kind": kind, "texture": len(textures) - 1,
                          "fuzz": p["roughness"] if kind == "metal" else 0.0})
        tri.append(p["tri"])
        uvs.append(p["uv"])
        mats.append(np.full(len(p["tri"]), len(materials) - 1, np.int64))
    verts = np.concatenate(tri)
    return {
        "textures": textures, "materials": materials,
        "spheres": {"center": np.zeros((0, 3)), "radius": np.zeros(0), "front": np.zeros((0, 3)),
                    "material": np.zeros(0, np.int64)},
        "triangles": {"a": verts[:, 0], "b": verts[:, 1], "c": verts[:, 2],
                      "uv": np.concatenate(uvs), "material": np.concatenate(mats)},
        "sky": sc["sky"],
    }
