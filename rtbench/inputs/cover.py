"""The RTIOW cover scene of the upstream ``thabnir/rt`` (scenes.rs:146-238) as
a raw description (``rtbench.reference.scene``), drawn the way the
renderer's own scene library draws it, so that one seed gives one scene.

Three big spheres (glass, metal, and a lambertian sphere under an image
texture that faces the camera), a ``grid_i x grid_j`` lattice of small
spheres with random offsets and a 5% / 15% / 80% glass / metal /
lambertian mix that keeps clear of the big spheres' sites, and a 3-D
checkered ground quad of two triangles (main.rs:31-34).  numpy's
``default_rng(seed)`` gives every draw in the lattice's loop order.  The
upstream embeds a photograph as the texture; this scene uses the procedural
stand-in the renderer uses (a warm 64x64 gradient).  The sky is the default
Perez sky: sun at +z, turbidity 2, exposure 0.25.

Textures and materials are listed in the order a scene builder creates
them, so a builder that replays the list gives every one the same id.  The
program's side has no file of its own: the harness replays the description.
"""

from __future__ import annotations

import numpy as np


def saul_texture(size: int = 64) -> np.ndarray:
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    r = 0.8 - 0.3 * y
    g = 0.6 - 0.2 * y + 0.1 * np.sin(6.28 * x)
    b = 0.4 + 0.2 * x * y
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0).astype(np.float32)


def describe(config: dict) -> dict:
    """The scene's description: the lattice of ``scene`` (``grid_i``,
    ``grid_j``, ``z``, ``seed``), the textured sphere facing the camera's
    centre."""
    sc = config["scene"]
    grid_i, grid_j, z, seed = sc["grid_i"], sc["grid_j"], sc["z"], sc["seed"]
    viewer = np.float32(config["camera"]["center"])
    if grid_i * grid_j > 2500:
        raise ValueError("the lattice is drawn in loop order up to 2500 cells")
    rng = np.random.default_rng(seed)
    textures, materials = [], []
    spheres = {"center": [], "radius": [], "front": [], "material": []}

    def texture(t: dict) -> int:
        textures.append(t)
        return len(textures) - 1

    def material(m: dict) -> int:
        materials.append(m)
        return len(materials) - 1

    def sphere(center, radius, mat, front=(1.0, 0.0, 0.0)):
        spheres["center"].append([float(c) for c in center])
        spheres["radius"].append(float(radius))
        spheres["front"].append([float(c) for c in front])
        spheres["material"].append(mat)

    big_r = 0.7
    saul_loc = np.array([-1.0, 1.732, big_r + z])
    p1 = np.array([-1.0, -1.732, big_r + z])
    p2 = np.array([2.0, 0.0, big_r + z])
    p3 = np.array([-2.0, 0.0, big_r + z])
    p4 = np.array([1.0, 1.732, big_r + z])
    p5 = np.array([1.0, -1.732, big_r + z])

    glass = material({"kind": "dielectric", "ior": 1.5})
    metal = material({"kind": "metal", "texture": texture({"kind": "solid",
                                                            "color": (0.7, 0.6, 0.5)}),
                      "fuzz": 0.0})
    saul = material({"kind": "lambertian",
                     "texture": texture({"kind": "image", "image": saul_texture()})})
    even = texture({"kind": "solid", "color": (0.1, 0.1, 0.1)})
    odd = texture({"kind": "solid", "color": (0.95, 0.95, 0.95)})
    ground = material({"kind": "lambertian",
                       "texture": texture({"kind": "checker", "scale": 3.0, "even": even,
                                           "odd": odd})})
    h = 10000.0 / 2.0
    qa, qb, qc, qd = (-h, -h, z), (h, -h, z), (h, h, z), (-h, h, z)
    uv = [[0.0, 0.0], [1.0, 0.0], [0.5, 1.0]]
    triangles = {"a": [qa, qa], "b": [qb, qc], "c": [qc, qd], "uv": [uv, uv],
                 "material": [ground, ground]}

    sphere(p1, big_r, glass)
    sphere(p3, big_r, metal)
    sphere(saul_loc, big_r, saul, front=np.asarray(viewer, np.float32))
    sites = [p1, p2, p3, p4, saul_loc, p5]
    for i in range(-grid_i, grid_i):
        for j in range(-grid_j, grid_j):
            radius = 0.2
            albedo = rng.uniform(0.0, 1.0, 3)
            offset = np.array([rng.uniform(0.0, 0.9), rng.uniform(0.0, 0.9), z])
            center = np.array([float(i), float(j), radius]) + offset
            if any(np.linalg.norm(center - s) < radius + big_r + 1.0 for s in sites):
                continue
            choose = rng.uniform(0.0, 1.0)
            if choose > 0.95:
                mat = material({"kind": "dielectric", "ior": 1.5})
            elif choose > 0.8:
                tex = texture({"kind": "solid", "color": tuple(float(c) for c in albedo)})
                mat = material({"kind": "metal", "texture": tex,
                                "fuzz": float(rng.uniform(0.0, 0.5))})
            else:
                tex = texture({"kind": "solid", "color": tuple(float(c) for c in albedo)})
                mat = material({"kind": "lambertian", "texture": tex})
            sphere(center, radius, mat)
    return {
        "textures": textures, "materials": materials,
        "spheres": {k: np.asarray(v) for k, v in spheres.items()},
        "triangles": {k: np.asarray(v) for k, v in triangles.items()},
        "sky": {"model": "perez", "sun": [0.0, 0.0, 1.0], "turbidity": 2.0, "exposure": 0.25},
    }
