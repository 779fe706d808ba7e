"""The night-car scene: a multi-part textured glTF car stand-in over a
checkered ground, under a low Hosek-Wilkie sun (BASELINE config 5).

The upstream loads its car from a user path (scenes.rs:344-458) that does
not ship.  The stand-in is the renderer's procedural car class: ``n_parts``
displaced-sphere shells (``res x res`` lat-long grids, two triangles a
cell), each its own glTF primitive with a metallic-roughness material and a
64x64 checker PNG as its base colour, drawn from ``default_rng(seed)`` in
the generator's order.  ``write_glb`` writes the file the renderer loads
through its glTF loader; ``describe`` gives the reference the same scene
from the raw arrays (positions, UVs, indices, texels), never from the file
or the loader.  Material mapping: metallic >= 0.5 is metal with fuzz =
roughness, else lambertian, each over its base-colour texture.
"""

from __future__ import annotations

import json
import os
import struct
import zlib

import numpy as np


def _png(rgb: np.ndarray) -> bytes:
    """PNG bytes of a u8[H, W, 3] image (8-bit RGB, filter 0, no interlace)."""
    h, w, _ = rgb.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def _checker(size: int, c0, c1, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size]
    mask = ((xx // (size // 8) + yy // (size // 8)) % 2).astype(np.float32)
    noise = rng.uniform(0.85, 1.0, (size, size, 1)).astype(np.float32)
    return (np.where(mask[..., None] > 0, c1, c0) * noise * 255).astype(np.uint8)


def parts(res: int, n_parts: int, seed: int) -> list[dict]:
    """Each part's positions f32[V, 3], UVs f32[V, 2], indices u32[3T],
    texels u8[64, 64, 3], metallic and roughness factors."""
    rng = np.random.default_rng(seed)
    out = []
    for part in range(n_parts):
        lat = np.linspace(0.05, np.pi - 0.05, res)
        lon = np.linspace(0.0, 2.0 * np.pi, res, endpoint=False)
        tt, pp = np.meshgrid(lat, lon, indexing="ij")
        freq, phase, amp = (rng.uniform(1.0, 5.0, (4, 2)), rng.uniform(0, 2 * np.pi, 4),
                            rng.uniform(0.02, 0.10, 4))
        disp = sum(a * np.sin(f1 * tt + f2 * pp + ph) for (f1, f2), ph, a in zip(freq, phase, amp))
        r = (0.6 + 0.2 * part) * (1.0 + disp)
        x = r * np.sin(tt) * np.cos(pp) + 1.6 * (part - (n_parts - 1) / 2)
        y = r * np.sin(tt) * np.sin(pp)
        z = r * np.cos(tt) + 1.0
        pos = np.stack([x, y, z], -1).reshape(-1, 3).astype(np.float32)
        uv = np.stack([pp / (2 * np.pi), tt / np.pi], -1).reshape(-1, 2).astype(np.float32)
        i, j = np.meshgrid(np.arange(res - 1), np.arange(res), indexing="ij")
        a, b = i * res + j, i * res + (j + 1) % res
        c, d = (i + 1) * res + j, (i + 1) * res + (j + 1) % res
        idx = np.stack([a, b, c, b, d, c], -1).reshape(-1).astype(np.uint32)
        c0, c1 = rng.uniform(0.2, 0.9, 3), rng.uniform(0.2, 0.9, 3)
        texels = _checker(64, c0, c1, seed * 10 + part)
        metallic, roughness = float(rng.uniform(0.3, 1.0)), float(rng.uniform(0.05, 0.5))
        out.append(dict(pos=pos, uv=uv, idx=idx, texels=texels, metallic=metallic,
                        roughness=roughness))
    return out


def write_glb(path: str, res: int, n_parts: int, seed: int) -> None:
    """Write the car as a glb (one buffer; per part a POSITION, TEXCOORD_0
    and index accessor, a material and an embedded PNG), under a temporary
    name renamed when complete."""
    import base64

    blob = b""
    views, accessors, meshes, materials, images, textures, nodes = [], [], [], [], [], [], []
    for k, p in enumerate(parts(res, n_parts, seed)):
        base = len(accessors)
        for data, ctype, count, kind in ((p["pos"], 5126, len(p["pos"]), "VEC3"),
                                         (p["uv"], 5126, len(p["uv"]), "VEC2"),
                                         (p["idx"], 5125, len(p["idx"]), "SCALAR")):
            views.append({"buffer": 0, "byteOffset": len(blob), "byteLength": data.nbytes})
            blob += data.tobytes()
            accessors.append({"bufferView": len(views) - 1, "componentType": ctype,
                              "count": count, "type": kind})
        images.append({"uri": "data:image/png;base64,"
                       + base64.b64encode(_png(p["texels"])).decode()})
        textures.append({"source": k})
        materials.append({"pbrMetallicRoughness": {"baseColorTexture": {"index": k},
                                                   "metallicFactor": p["metallic"],
                                                   "roughnessFactor": p["roughness"]}})
        meshes.append({"primitives": [{"attributes": {"POSITION": base, "TEXCOORD_0": base + 1},
                                       "indices": base + 2, "material": k}]})
        nodes.append({"mesh": k})
    doc = {"asset": {"version": "2.0"}, "buffers": [{"byteLength": len(blob)}],
           "bufferViews": views, "accessors": accessors, "meshes": meshes,
           "materials": materials, "images": images, "textures": textures, "nodes": nodes,
           "scenes": [{"nodes": list(range(n_parts))}], "scene": 0}
    jb = json.dumps(doc).encode()
    jb += b" " * (-len(jb) % 4)
    blob += b"\x00" * (-len(blob) % 4)
    glb = b"glTF" + struct.pack("<II", 2, 12 + 8 + len(jb) + 8 + len(blob))
    glb += struct.pack("<II", len(jb), 0x4E4F534A) + jb
    glb += struct.pack("<II", len(blob), 0x004E4942) + blob
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(glb)
    os.replace(tmp, path)


def describe(res: int, n_parts: int, seed: int, ground: dict, sky: dict) -> dict:
    """The scene's description: the ground's two textures, its checker and
    material and two triangles first (as the scene is built: the ground,
    then the glTF), then each part's texture, material and triangles."""
    s = float(ground["size"]) / 2.0
    z = float(ground["z"])
    textures = [{"kind": "solid", "color": tuple(ground["even"])},
                {"kind": "solid", "color": tuple(ground["odd"])},
                {"kind": "checker", "scale": float(ground["scale"]), "even": 0, "odd": 1}]
    materials = [{"kind": "lambertian", "texture": 2}]
    qa, qb, qc, qd = (-s, -s, z), (s, -s, z), (s, s, z), (-s, s, z)
    uv0 = np.array([[0.0, 0.0], [1.0, 0.0], [0.5, 1.0]], np.float32)
    tri_a, tri_b, tri_c = [np.array([qa, qa], np.float32)], [np.array([qb, qc], np.float32)], [
        np.array([qc, qd], np.float32)]
    tri_uv, tri_mat = [np.stack([uv0, uv0])], [np.zeros(2, np.int64)]
    for p in parts(res, n_parts, seed):
        textures.append({"kind": "image", "image": p["texels"].astype(np.float32) / 255.0})
        kind = "metal" if p["metallic"] >= 0.5 else "lambertian"
        materials.append({"kind": kind, "texture": len(textures) - 1, "fuzz": p["roughness"]
                          if kind == "metal" else 0.0})
        tri = p["idx"].reshape(-1, 3).astype(np.int64)
        verts = p["pos"][tri]
        tri_a.append(verts[:, 0])
        tri_b.append(verts[:, 1])
        tri_c.append(verts[:, 2])
        tri_uv.append(p["uv"][tri])
        tri_mat.append(np.full(len(tri), len(materials) - 1, np.int64))
    cat = np.concatenate
    return {
        "textures": textures, "materials": materials,
        "spheres": {"center": np.zeros((0, 3)), "radius": np.zeros(0), "front": np.zeros((0, 3)),
                    "material": np.zeros(0, np.int64)},
        "triangles": {"a": cat(tri_a), "b": cat(tri_b), "c": cat(tri_c), "uv": cat(tri_uv),
                      "material": cat(tri_mat)},
        "sky": sky,
    }
