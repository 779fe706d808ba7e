"""Shared by the port's tests of the brute-force kernels K1 and K3/K3b
and by chip_smoke.py: the tie scene of tests/test_torch_brute_order.py,
its rays, and the first pass of the late-sqrt sphere test (which pairs
the discriminant admits)."""

import numpy as np
import torch

from rt_tpu_torch.nearest_ops import RAY_TILE
from rt_tpu_torch.scene import SceneBuilder

SPOTS = [(x, y) for x in (-6.0, -3.0, 0.0, 3.0, 6.0) for y in (-6.0, 0.0, 6.0)]


def admitted(rays, sph):
    """The first pass of csrc/brute_force.cuh ``sphere_batch``: bool [S, N]
    for rays f32[>=6, N] and sphere rows f32[S, 4], disc >= 0 and a
    positive radius, in the plain version's arithmetic."""
    ox, oy, oz, dx, dy, dz = (rays[k][None] for k in range(6))
    cx, cy, cz, rad = sph[:, 0:1], sph[:, 1:2], sph[:, 2:3], sph[:, 3:4]
    a = dx * dx + dy * dy + dz * dz
    ocx, ocy, ocz = cx - ox, cy - oy, cz - oz
    h = dx * ocx + dy * ocy + dz * ocz
    disc = h * h - a * (ocx * ocx + ocy * ocy + ocz * ocz - rad * rad)
    return (disc >= 0.0) & (rad > 0.0)


def tie_scene():
    """A flat scene of exact ties for K3 (port only): at each of 15 spots
    (x, y), a sphere at (x, y, 2) of radius 1 and a triangle in z = 1
    around (x, y), wound to face a ray going up; 40 random spheres above
    them (z 5 to 9); then
    every spot's sphere again (15 ids later: another lane), the first
    random sphere again 8 ids after its first copy (the same lane) and
    the first five spots' triangles again."""
    rs = np.random.default_rng(3)
    b = SceneBuilder()
    mats = [b.lambertian(b.solid_color((0.7, 0.3, 0.2))), b.metal(b.solid_color((0.8, 0.7, 0.6)), 0.1),
            b.dielectric(1.5)]

    def tri(x, y):
        return (x - 1.0, y - 1.0, 1.0), (x - 1.0, y + 3.0, 1.0), (x + 3.0, y - 1.0, 1.0)

    for k, (x, y) in enumerate(SPOTS):
        b.add_sphere((x, y, 2.0), 1.0, mats[k % 3])
    first_random = len(SPOTS)
    centers = np.c_[rs.uniform(-8, 8, (40, 2)), rs.uniform(5, 9, 40)]  # above every spot
    radii = rs.uniform(0.3, 1.2, 40)
    centers[8], radii[8] = centers[0], radii[0]  # the same lane as its first copy
    for k in range(40):
        b.add_sphere(centers[k], radii[k], mats[k % 3])
    for k, (x, y) in enumerate(SPOTS):
        b.add_sphere((x, y, 2.0), 1.0, mats[k % 3])
    for k, (x, y) in enumerate(SPOTS + SPOTS[:5]):
        b.add_triangle(*tri(x, y), mats[k % 3])
    scene = b.build()
    assert scene.clusters is None and first_random + 8 == 23
    return scene


def tie_rays() -> torch.Tensor:
    """Rays f32[8, k * RAY_TILE] at the tie scene: up the z axis from each
    spot at two speeds (t = 1 and 0.5 on the sphere and its triangle);
    up from the bottom of each spot's sphere (near root 0 < t_min: the far
    root wins) and out from its center in random directions (near root
    negative); upward from above the scene, which miss; at the repeated
    random sphere's center from afar; random rays; and the wavefront's
    idle lanes (origin 0, direction (1, 1, 1)) as padding."""
    rs = np.random.default_rng(9)
    spots = np.asarray(SPOTS, np.float32)
    k = len(spots)
    parts = []

    def add(org, dirn):
        r = np.zeros((8, org.shape[0]), np.float32)
        r[0:3], r[3:6] = org.T, np.broadcast_to(dirn, org.shape).T
        parts.append(r)

    up = np.asarray((0.0, 0.0, 1.0), np.float32)
    add(np.c_[spots, np.zeros(k, np.float32)], up)
    add(np.c_[spots, np.zeros(k, np.float32)], 2.0 * up)
    add(np.c_[spots, np.ones(k, np.float32)], up)
    add(np.repeat(np.c_[spots, np.full(k, 2.0, np.float32)], 8, axis=0),
        rs.normal(size=(8 * k, 3)).astype(np.float32))
    add(np.c_[rs.uniform(-8, 8, (64, 2)), np.full(64, 12.0)].astype(np.float32), up)
    target = np.asarray(tie_scene().sph_packed[len(SPOTS), :3], np.float32)
    org = rs.uniform(-12, 12, (64, 3)).astype(np.float32)
    add(org, (target - org).astype(np.float32))
    out = np.concatenate(parts, axis=1)
    n_rand = 1024 - out.shape[1] - 64
    rnd = np.zeros((8, n_rand), np.float32)
    rnd[0:3] = rs.uniform(-9, 9, (3, n_rand))
    rnd[3:6] = rs.normal(size=(3, n_rand))
    pad = np.zeros((8, 64), np.float32)
    pad[3:8] = 1.0
    rays = np.concatenate([out, rnd, pad], axis=1)
    assert rays.shape[1] % RAY_TILE == 0
    return torch.from_numpy(rays)
