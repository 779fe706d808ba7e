"""A procedural stand-in for BASELINE config 3 ("OBJ skull mesh via BVH
traversal with emissive area light"): a closed mesh under an emissive panel.

No skull OBJ ships, and the upstream's ``mesh_scene`` (scenes.rs:344-393)
renders other meshes: five OBJ classics, loaded by ``load_obj``
(hittable.rs:497-554) from user paths, with no emitter.  The stand-in is the
renderer's procedural skull-class mesh, smooth and low-frequency, not a
scan: a displaced sphere on a ``res x res`` lat-long grid, two triangles a
cell (``res = 224``: 99,904 triangles), its displacement drawn from
``default_rng(seed)``.
``write_inputs`` writes it as the OBJ text the program loads through its
own OBJ loader (``rtbench/scenes/blob.py``); ``make_obj_mesh`` below
copies the renderer's fixture writer, so the file is byte for byte the
renderer's.  ``describe`` gives the reference the same scene: each vertex
and UV as the file states it (``%.5f``, read back as a float, then
float32), never read through the loader.

Scene order, as the program's scene function builds it: the ground's two
solid textures, its checker and material and two triangles; the plaster's
texture and material and the mesh's triangles; the light's texture and
emissive material and its two triangles (one panel, once in each winding).
"""

from __future__ import annotations

import os

import numpy as np


def _mesh(res: int, seed: int):
    """(vertices f64[V, 3], UVs f64[V, 2], faces int64[T, 3]) of the
    renderer's fixture: a displaced sphere on a lat-long grid (a
    low-frequency field of 6 sines), sitting above the ground plane; the
    faces (a, b, c), (b, d, c) of every grid cell, row by row."""
    rng = np.random.default_rng(seed)
    lat = np.linspace(0.05, np.pi - 0.05, res)
    lon = np.linspace(0.0, 2.0 * np.pi, res, endpoint=False)
    tt, pp = np.meshgrid(lat, lon, indexing="ij")
    freqs = rng.uniform(1.0, 4.0, (6, 2))
    phases = rng.uniform(0.0, 2.0 * np.pi, 6)
    amps = rng.uniform(0.03, 0.12, 6)
    disp = sum(a * np.sin(f1 * tt + f2 * pp + ph) for (f1, f2), ph, a in zip(freqs, phases, amps))
    r = 1.0 + disp
    verts = np.stack([r * np.sin(tt) * np.cos(pp), r * np.sin(tt) * np.sin(pp),
                      r * np.cos(tt) + 1.1], -1).reshape(-1, 3)
    uv = np.stack([pp / (2 * np.pi), tt / np.pi], -1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(res - 1), np.arange(res), indexing="ij")
    a, b = i * res + j, i * res + (j + 1) % res
    c, d = (i + 1) * res + j, (i + 1) * res + (j + 1) % res
    faces = np.stack([a, b, c, b, d, c], -1).reshape(-1, 3).astype(np.int64)
    return verts, uv, faces


def make_obj_mesh(path: str, res: int = 224, seed: int = 0) -> int:
    """Write the mesh as the renderer's fixture writes it: one object of
    v/vt/f records, coordinates with 5 decimals, each vertex its own UV.
    Returns the triangle count."""
    verts, uv, faces = _mesh(res, seed)
    with open(path, "w") as f:
        f.write("# procedural skull-class fixture (tools/gen_fixtures.py)\n")
        for v in verts:
            f.write(f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f}\n")
        for t in uv:
            f.write(f"vt {t[0]:.5f} {t[1]:.5f}\n")
        for a, b, c in (faces + 1).tolist():
            f.write(f"f {a}/{a} {b}/{b} {c}/{c}\n")
    return len(faces)


def mesh_arrays(res: int, seed: int):
    """(vertices f32[V, 3], UVs f32[V, 2], faces int64[T, 3]) as the OBJ
    text states them: each coordinate rounded to 5 decimals, read back as a
    float, then float32."""
    verts, uv, faces = _mesh(res, seed)
    as_text = np.vectorize(lambda x: float(f"{x:.5f}"), otypes=[np.float64])
    return as_text(verts).astype(np.float32), as_text(uv).astype(np.float32), faces


def obj_path(scene: dict, build_dir: str) -> str:
    """The mesh's OBJ in ``build_dir``, named by the generator's parameters."""
    return os.path.join(build_dir, f"blob_r{scene['res']}_s{scene['seed']}.obj")


def write_inputs(config: dict, build_dir: str) -> None:
    """Write the mesh's OBJ once, under a temporary name renamed when
    complete."""
    sc = config["scene"]
    path = obj_path(sc, build_dir)
    if not os.path.exists(path):
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        make_obj_mesh(tmp, sc["res"], sc["seed"])
        os.replace(tmp, path)


def tiny(scene: dict) -> dict:
    """The scene cut to a CPU test's size: the mesh at res 12 (264
    triangles: cluster tables and a BVH, as at full size)."""
    return dict(scene, res=12)


def describe(config: dict) -> dict:
    """The scene's description, in the order the program's scene function
    creates textures, materials and triangles, so that every id matches."""
    sc = config["scene"]
    ground, light, sky = sc["ground"], sc["light"], sc["sky"]
    s, z = float(ground["size"]) / 2.0, float(ground["z"])
    textures = [{"kind": "solid", "color": tuple(ground["even"])},
                {"kind": "solid", "color": tuple(ground["odd"])},
                {"kind": "checker", "scale": float(ground["scale"]), "even": 0, "odd": 1},
                {"kind": "solid", "color": tuple(sc["plaster"])},
                {"kind": "solid", "color": tuple(light["radiance"])}]
    materials = [{"kind": "lambertian", "texture": 2}, {"kind": "lambertian", "texture": 3},
                 {"kind": "emissive", "texture": 4}]
    verts, uvs, faces = mesh_arrays(sc["res"], sc["seed"])
    uv0 = np.array([[0.0, 0.0], [1.0, 0.0], [0.5, 1.0]], np.float32)
    qa, qb, qc, qd = (-s, -s, z), (s, -s, z), (s, s, z), (-s, s, z)
    panel = np.asarray(light["triangles"], np.float32).reshape(-1, 3, 3)
    n_light = len(panel)
    cat = np.concatenate
    return {
        "textures": textures, "materials": materials,
        "spheres": {"center": np.zeros((0, 3)), "radius": np.zeros(0), "front": np.zeros((0, 3)),
                    "material": np.zeros(0, np.int64)},
        "triangles": {
            "a": cat([np.array([qa, qa], np.float32), verts[faces[:, 0]], panel[:, 0]]),
            "b": cat([np.array([qb, qc], np.float32), verts[faces[:, 1]], panel[:, 1]]),
            "c": cat([np.array([qc, qd], np.float32), verts[faces[:, 2]], panel[:, 2]]),
            "uv": cat([np.stack([uv0, uv0]), uvs[faces], np.broadcast_to(uv0, (n_light, 3, 2))]),
            "material": cat([np.zeros(2, np.int64), np.ones(len(faces), np.int64),
                             np.full(n_light, 2, np.int64)]),
        },
        "sky": sky,
    }
