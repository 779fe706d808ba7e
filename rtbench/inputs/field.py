"""The upstream's default scene, what ``cargo run`` renders (main.rs:23-62):
a checkered ground, the RTIOW cover's big spheres and a ``grid x grid``
lattice of small spheres (scenes.rs:146-238), and a glTF model under the
upstream's own material mapping, below a Hosek-Wilkie sky.

The lattice is drawn in bulk from numpy's ``default_rng(seed)``, as the
renderer draws its large covers: albedos [n, 3], then the x and the y
offsets [n] each, then every cell's material choice and fuzz [n] each, over
the cells in (i, j) order; a cell within ``0.2 + 0.7 + 1.0`` of one of the
six big-sphere sites keeps no sphere.  The choice gives glass above 0.95,
metal with the drawn fuzz above 0.8, else lambertian, each sphere with a
solid texture of its albedo.

The model is the renderer's armor-class stand-in (the upstream loads its
``gltf_test`` asset from a user path that does not ship): the parts of
``rtbench.inputs.car.parts``, written as a glb by ``car.write_glb``
(``write_inputs``), which the program loads through its glTF loader.
``describe`` gives the reference the same parts from the raw arrays, each
metal with fuzz = roughness over its base-colour texture
(``Material::from_gltf``, material.rs:20-33), placed by the upstream's
``scale_rotate_mat`` (scenes.rs:460-475): the matrix's linear part, in
float32, applied to every triangle's vertices.

Scene order, as the program's scene function builds it: the ground's two
solid textures, its checker, material and two triangles; the big spheres'
glass, metal (its texture, then its material) and textured material and
the three big spheres; the lattice's materials and spheres; each part's
texture, material and triangles.
"""

from __future__ import annotations

import os

import numpy as np

from rtbench.inputs import car
from rtbench.inputs.cover import saul_texture


def placement(t: dict) -> np.ndarray:
    """f32[4, 4]: the upstream's ``scale_rotate_mat(roll, pitch, yaw,
    scale)``, the homogeneous matrix of Ry(pitch) Rz(yaw) Rz(roll) times the
    scale (its "roll" also turns about z); only its linear part moves a
    vertex."""
    def rz(deg):
        c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
        return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    def ry(deg):
        c, s = np.cos(np.deg2rad(deg)), np.sin(np.deg2rad(deg))
        return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])

    m = np.eye(4)
    m[:3, :3] = ry(t["pitch"]) @ rz(t["yaw"]) @ rz(t["roll"])
    return (m * t["scale"]).astype(np.float32)


def lattice(grid: int, z: float, seed: int, big_sites: np.ndarray):
    """The kept lattice spheres: (centers f64[S, 3], choices f64[S],
    albedos f64[S, 3], fuzz f64[S])."""
    n = (2 * grid) ** 2
    g = np.random.default_rng(seed)
    albedo = g.uniform(0.0, 1.0, (n, 3))
    off_x, off_y = g.uniform(0.0, 0.9, n), g.uniform(0.0, 0.9, n)
    choose, fuzz = g.uniform(0.0, 1.0, n), g.uniform(0.0, 0.5, n)
    cells = np.arange(-grid, grid)
    ii, jj = np.repeat(cells, 2 * grid), np.tile(cells, 2 * grid)
    centers = np.stack([ii + off_x, jj + off_y, np.full(n, 0.2) + np.full(n, z)], -1)
    dist = np.stack([np.linalg.norm(centers - s, axis=-1) for s in big_sites])
    keep = (dist >= 0.2 + 0.7 + 1.0).all(axis=0)
    return centers[keep], choose[keep], albedo[keep], fuzz[keep]


def glb_path(scene: dict, build_dir: str) -> str:
    """The model's glb in ``build_dir`` (the car generator's name for its
    parameters: the same file)."""
    return car.glb_path(scene["mesh"], build_dir)


def write_inputs(config: dict, build_dir: str) -> None:
    """Write the model's glb once."""
    mesh = config["scene"]["mesh"]
    path = glb_path(config["scene"], build_dir)
    if not os.path.exists(path):
        car.write_glb(path, mesh["res"], mesh["n_parts"], mesh["seed"])


def tiny(scene: dict) -> dict:
    """The scene cut to a CPU test's size: a 51 x 51 lattice (10,404 cells,
    past the 2,500 up to which the renderer draws in loop order) and the
    model at res 12 (792 triangles)."""
    return dict(scene, grid=51, mesh=dict(scene["mesh"], res=12))


def describe(config: dict) -> dict:
    """The scene's description, in the order the program's scene function
    creates textures, materials, spheres and triangles."""
    sc = config["scene"]
    ground, mesh, z = sc["ground"], sc["mesh"], float(sc["z"])
    textures = [{"kind": "solid", "color": tuple(ground["even"])},
                {"kind": "solid", "color": tuple(ground["odd"])},
                {"kind": "checker", "scale": float(ground["scale"]), "even": 0, "odd": 1},
                {"kind": "solid", "color": (0.7, 0.6, 0.5)},
                {"kind": "image", "image": saul_texture()}]
    materials = [{"kind": "lambertian", "texture": 2}, {"kind": "dielectric", "ior": 1.5},
                 {"kind": "metal", "texture": 3, "fuzz": 0.0}, {"kind": "lambertian", "texture": 4}]

    big_r = 0.7
    p1, p2, p3 = [-1.0, -1.732, big_r + z], [2.0, 0.0, big_r + z], [-2.0, 0.0, big_r + z]
    p4, p5, saul = [1.0, 1.732, big_r + z], [1.0, -1.732, big_r + z], [-1.0, 1.732, big_r + z]
    centers, choose, albedo, fuzz = lattice(int(sc["grid"]), z, int(sc["seed"]),
                                            np.array([p1, p2, p3, p4, saul, p5]))
    sph_mat = np.zeros(len(centers), np.int64)
    for k in range(len(centers)):
        if choose[k] > 0.95:
            materials.append({"kind": "dielectric", "ior": 1.5})
        else:
            textures.append({"kind": "solid", "color": tuple(float(c) for c in albedo[k])})
            materials.append({"kind": "metal", "texture": len(textures) - 1,
                              "fuzz": float(fuzz[k])} if choose[k] > 0.8 else
                             {"kind": "lambertian", "texture": len(textures) - 1})
        sph_mat[k] = len(materials) - 1
    viewer = np.float32(config["camera"]["center"]).astype(np.float64)
    front = np.zeros((3 + len(centers), 3))
    front[:, 0] = 1.0
    front[2] = viewer

    s = float(ground["size"]) / 2.0
    gz = float(ground["z"])
    qa, qb, qc, qd = (-s, -s, gz), (s, -s, gz), (s, s, gz), (-s, s, gz)
    uv0 = np.array([[0.0, 0.0], [1.0, 0.0], [0.5, 1.0]], np.float32)
    tri_v = [np.array([[qa, qb, qc], [qa, qc, qd]], np.float32)]
    tri_uv, tri_mat = [np.stack([uv0, uv0])], [np.zeros(2, np.int64)]
    m = placement(mesh["transform"])
    for p in car.parts(mesh["res"], mesh["n_parts"], mesh["seed"]):
        textures.append({"kind": "image", "image": p["texels"].astype(np.float32) / 255.0})
        materials.append({"kind": "metal", "texture": len(textures) - 1,
                          "fuzz": p["roughness"]})
        tri = p["idx"].reshape(-1, 3).astype(np.int64)
        tri_v.append((p["pos"][tri].reshape(-1, 3) @ m[:3, :3].T).reshape(-1, 3, 3))
        tri_uv.append(p["uv"][tri])
        tri_mat.append(np.full(len(tri), len(materials) - 1, np.int64))
    verts = np.concatenate(tri_v)
    cat = np.concatenate
    return {
        "textures": textures, "materials": materials,
        "spheres": {"center": cat([np.array([p1, p3, saul]), centers]),
                    "radius": cat([np.full(3, big_r), np.full(len(centers), 0.2)]),
                    "front": front, "material": cat([np.array([1, 2, 3]), sph_mat])},
        "triangles": {"a": verts[:, 0], "b": verts[:, 1], "c": verts[:, 2], "uv": cat(tri_uv),
                      "material": cat(tri_mat)},
        "sky": sc["sky"],
    }
