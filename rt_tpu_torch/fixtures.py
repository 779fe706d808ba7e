#!/usr/bin/env python
"""Deterministic procedural asset fixtures for BASELINE configs 3-5.

The port's copy of the JAX package's tools/gen_fixtures.py, so that the
port needs neither that package nor PIL.  The reference's mesh scenes load
third-party classics (skull OBJ, armor and car glTFs) from hardcoded user
paths (scenes.rs:344-458) that do not ship with the repo; these generators
write stand-ins with the same structural load: a dense OBJ mesh for the
BVH/area-light config, a height field, and a multi-primitive textured glb
for the armor/car configs.

The OBJ files are byte-equal to tools/gen_fixtures.py's.  The glb
textures are encoded by ``png_io.encode_png`` instead of PIL, so their PNG
bytes differ, but PNG is lossless: every decoded texel, and every other
byte of the glb's buffer, is the same.

    python -m rt_tpu_torch.fixtures [DIRECTORY]   # default build/fixtures
"""

from __future__ import annotations

import base64
import json
import os
import struct

import numpy as np

from rt_tpu_torch.io.png_io import encode_png


def make_obj_mesh(path: str, res: int = 224, seed: int = 0) -> int:
    """Displaced-sphere OBJ (skull-class stand-in): ~2*res^2 triangles,
    single object, v/vt/f records through the real tobj-equivalent parse
    path (hittable.rs:497-554 analog).  Returns the triangle count."""
    rng = np.random.default_rng(seed)
    # Low-frequency displacement field on a lat-long sphere grid.
    n_lat, n_lon = res, res
    lat = np.linspace(0.05, np.pi - 0.05, n_lat)
    lon = np.linspace(0.0, 2.0 * np.pi, n_lon, endpoint=False)
    tt, pp = np.meshgrid(lat, lon, indexing="ij")
    freqs = rng.uniform(1.0, 4.0, (6, 2))
    phases = rng.uniform(0.0, 2.0 * np.pi, 6)
    amps = rng.uniform(0.03, 0.12, 6)
    disp = sum(
        a * np.sin(f1 * tt + f2 * pp + ph)
        for (f1, f2), ph, a in zip(freqs, phases, amps)
    )
    r = 1.0 + disp
    x = r * np.sin(tt) * np.cos(pp)
    y = r * np.sin(tt) * np.sin(pp)
    z = r * np.cos(tt) + 1.1  # sit above the ground plane
    verts = np.stack([x, y, z], -1).reshape(-1, 3)
    uv = np.stack([pp / (2 * np.pi), tt / np.pi], -1).reshape(-1, 2)

    def vid(i, j):
        return i * n_lon + (j % n_lon)

    faces = []
    for i in range(n_lat - 1):
        for j in range(n_lon):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j), vid(i + 1, j + 1)
            faces.append((a, b, c))
            faces.append((b, d, c))
    with open(path, "w") as f:
        f.write("# procedural skull-class fixture (tools/gen_fixtures.py)\n")
        for v in verts:
            f.write(f"v {v[0]:.5f} {v[1]:.5f} {v[2]:.5f}\n")
        for t in uv:
            f.write(f"vt {t[0]:.5f} {t[1]:.5f}\n")
        for a, b, c in faces:
            f.write(f"f {a+1}/{a+1} {b+1}/{b+1} {c+1}/{c+1}\n")
    return len(faces)


def make_obj_heightfield(path: str, nx: int = 224, ny: int = 224) -> int:
    """~100k-triangle height-field OBJ (the round-2 perf-table fixture's
    shape: open 2.5-D terrain, bounces escape to the sky quickly — an
    easier locality profile than the closed skull-class blob)."""
    xs = np.linspace(-5, 5, nx + 1)
    ys = np.linspace(-5, 5, ny + 1)
    with open(path, "w") as f:
        for y in ys:
            for x in xs:
                z = 0.2 * np.sin(x) * np.cos(y)
                f.write(f"v {x:.4f} {y:.4f} {z:.4f}\n")
        w = nx + 1
        for j in range(ny):
            for i in range(nx):
                a = j * w + i + 1
                b = a + 1
                c = a + w + 1
                d = a + w
                f.write(f"f {a} {b} {c}\n")
                f.write(f"f {a} {c} {d}\n")
    return 2 * nx * ny


def _checker_png_b64(size: int, c0, c1, seed: int = 0) -> str:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    mask = ((xx // (size // 8) + yy // (size // 8)) % 2).astype(np.float32)
    noise = rng.uniform(0.85, 1.0, (size, size, 1)).astype(np.float32)
    img = (np.where(mask[..., None] > 0, c1, c0) * noise * 255).astype(np.uint8)
    return base64.b64encode(encode_png(img)).decode()


def make_glb_armor(path: str, res: int = 96, n_parts: int = 3, seed: int = 1) -> int:
    """Multi-primitive textured glTF (armor/car-class stand-in): n_parts
    displaced-sphere shells, each its own primitive with a
    metallic-roughness material and a baseColorTexture — exercising the
    full import path (hittable.rs:556-633, material.rs:20-33).  Returns
    total triangle count."""
    rng = np.random.default_rng(seed)
    blob = b""
    views, accessors, meshes, materials, images, textures, nodes = (
        [], [], [], [], [], [], []
    )
    total_tris = 0
    for part in range(n_parts):
        n_lat = n_lon = res
        lat = np.linspace(0.05, np.pi - 0.05, n_lat)
        lon = np.linspace(0.0, 2.0 * np.pi, n_lon, endpoint=False)
        tt, pp = np.meshgrid(lat, lon, indexing="ij")
        disp = sum(
            a * np.sin(f1 * tt + f2 * pp + ph)
            for (f1, f2), ph, a in zip(
                rng.uniform(1.0, 5.0, (4, 2)),
                rng.uniform(0, 2 * np.pi, 4),
                rng.uniform(0.02, 0.10, 4),
            )
        )
        r = (0.6 + 0.2 * part) * (1.0 + disp)
        x = r * np.sin(tt) * np.cos(pp) + 1.6 * (part - (n_parts - 1) / 2)
        y = r * np.sin(tt) * np.sin(pp)
        z = r * np.cos(tt) + 1.0
        pos = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
        uv = (
            np.stack([pp / (2 * np.pi), tt / np.pi], -1)
            .reshape(-1, 2)
            .astype(np.float32)
        )
        idx = []
        for i in range(n_lat - 1):
            for j in range(n_lon):
                a, b = i * n_lon + j, i * n_lon + (j + 1) % n_lon
                c, d = (i + 1) * n_lon + j, (i + 1) * n_lon + (j + 1) % n_lon
                idx += [a, b, c, b, d, c]
        idx = np.asarray(idx, np.uint32)
        total_tris += len(idx) // 3

        def add_view(data, target=None):
            nonlocal blob
            off = len(blob)
            blob += data.tobytes()
            views.append({"buffer": 0, "byteOffset": off, "byteLength": data.nbytes})
            return len(views) - 1

        pv, uvv, iv = add_view(pos), add_view(uv), add_view(idx)
        accessors.append(
            {"bufferView": pv, "componentType": 5126, "count": len(pos), "type": "VEC3"}
        )
        accessors.append(
            {"bufferView": uvv, "componentType": 5126, "count": len(uv), "type": "VEC2"}
        )
        accessors.append(
            {"bufferView": iv, "componentType": 5125, "count": len(idx), "type": "SCALAR"}
        )
        base = 3 * part
        images.append(
            {
                "uri": "data:image/png;base64,"
                + _checker_png_b64(
                    64,
                    rng.uniform(0.2, 0.9, 3),
                    rng.uniform(0.2, 0.9, 3),
                    seed=seed * 10 + part,
                )
            }
        )
        textures.append({"source": part})
        materials.append(
            {
                "pbrMetallicRoughness": {
                    "baseColorTexture": {"index": part},
                    "metallicFactor": float(rng.uniform(0.3, 1.0)),
                    "roughnessFactor": float(rng.uniform(0.05, 0.5)),
                }
            }
        )
        meshes.append(
            {
                "primitives": [
                    {
                        "attributes": {"POSITION": base, "TEXCOORD_0": base + 1},
                        "indices": base + 2,
                        "material": part,
                    }
                ]
            }
        )
        nodes.append({"mesh": part})

    doc = {
        "asset": {"version": "2.0"},
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": views,
        "accessors": accessors,
        "meshes": meshes,
        "materials": materials,
        "images": images,
        "textures": textures,
        "nodes": nodes,
        "scenes": [{"nodes": list(range(n_parts))}],
        "scene": 0,
    }
    jb = json.dumps(doc).encode()
    jb += b" " * (-len(jb) % 4)
    blob += b"\x00" * (-len(blob) % 4)
    glb = b"glTF" + struct.pack("<II", 2, 12 + 8 + len(jb) + 8 + len(blob))
    glb += struct.pack("<II", len(jb), 0x4E4F534A) + jb
    glb += struct.pack("<II", len(blob), 0x004E4942) + blob
    with open(path, "wb") as f:
        f.write(glb)
    return total_tris


def ensure_fixtures(directory: str) -> dict:
    """Generate (once) and return paths for the config 3-5 fixtures: the
    skull-class OBJ, the armor-class glb (res 96, 3 parts), the car-class
    glb (res 128, 5 parts, seed 7) and the height field.  Each file is
    written under a temporary name and renamed when complete."""
    os.makedirs(directory, exist_ok=True)
    paths = {name: os.path.join(directory, file) for name, file in (
        ("obj", "skull_class.obj"), ("glb", "armor_class.glb"), ("car", "car_class.glb"),
        ("heightfield", "heightfield.obj"))}
    writers = {
        "obj": make_obj_mesh,
        "glb": make_glb_armor,
        "car": lambda path: make_glb_armor(path, res=128, n_parts=5, seed=7),
        "heightfield": make_obj_heightfield,
    }
    for name, path in paths.items():
        if not os.path.exists(path):
            tmp = path + ".tmp"
            writers[name](tmp)
            os.replace(tmp, path)
    return paths


if __name__ == "__main__":
    import sys

    out = sys.argv[1] if len(sys.argv) > 1 else os.path.join("build", "fixtures")
    print(ensure_fixtures(out))
