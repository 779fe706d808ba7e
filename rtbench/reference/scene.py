"""Per-primitive arrays of the reference, worked out from a raw scene
description (``rtbench.inputs``), never from the program's tables.

A description is a dict:

- ``textures``: a list of ``{"kind": "solid", "color": rgb}``,
  ``{"kind": "checker", "scale": s, "even": id, "odd": id}`` (3-D checker
  on floor(point / scale) parity, solid children) and ``{"kind":
  "image", "image": f32[h, w, 3]}``;
- ``materials``: a list of ``{"kind": "lambertian" | "metal" | "dielectric"
  | "emissive", "texture": id, "fuzz": f, "ior": f}``;
- ``spheres``: ``center`` f32[S, 3], ``radius`` f32[S], ``front`` f32[S, 3]
  (the facing direction of a sphere's texture), ``material`` int[S];
- ``triangles``: ``a``, ``b``, ``c`` f32[T, 3], ``uv`` f32[T, 3, 2],
  ``material`` int[T];
- ``sky``: see ``reference.sky``.

Primitive ids are spheres first, then triangles, as the upstream World
orders its shapes.  ``Prims`` holds the geometry, the per-primitive
material and texture ids, and assembles the shading rows from the
scene's leaves (texture colours, image texels, fuzz, IOR).
"""

from __future__ import annotations

import numpy as np
import torch

MAT_KINDS = {"lambertian": 0, "metal": 1, "dielectric": 2, "emissive": 3}
TEX_KINDS = {"solid": 0, "checker": 1, "image": 2}


def _normalize(v: np.ndarray) -> np.ndarray:
    return v / np.maximum(np.linalg.norm(v, axis=-1, keepdims=True), 1.0e-20)


class Prims:
    """The reference's scene on ``device``: geometry in ``dtype``, and the
    leaves ``tex_color`` f32[X, 3], ``images`` (f32[sum h, max w, 3],
    stacked top to bottom), ``mat_fuzz`` f32[M], ``mat_ior`` f32[M]."""

    def __init__(self, desc: dict, device, dtype=torch.float32):
        self.device, self.dtype = torch.device(device), dtype
        sph, tri = desc["spheres"], desc["triangles"]
        ns, nt = len(sph["radius"]), len(tri["material"])
        self.ns, self.nt = ns, nt
        f32 = lambda a: np.asarray(a, np.float32)
        center, radius, front = f32(sph["center"]).reshape(ns, 3), f32(sph["radius"]), f32(
            sph["front"]).reshape(ns, 3)
        a, b, c = (f32(tri[k]).reshape(nt, 3) for k in ("a", "b", "c"))
        uv = f32(tri["uv"]).reshape(nt, 6)
        normal = _normalize(np.cross(_normalize(b - a), _normalize(c - a)))
        yaw = np.arctan2(front[:, 1], front[:, 0])
        pitch = np.arctan2(front[:, 2], np.sqrt(front[:, 0] ** 2 + front[:, 1] ** 2 + 1e-20))

        mats, texs = desc["materials"], desc["textures"]
        self.mat_kind_of = np.array([MAT_KINDS[m["kind"]] for m in mats], np.int64)
        self.mat_tex_of = np.array([m.get("texture", -1) for m in mats], np.int64)
        tex_kind = np.array([TEX_KINDS[t["kind"]] for t in texs], np.int64)
        tex_color = np.zeros((len(texs), 3), np.float32)
        children = np.zeros((len(texs), 2), np.int64)
        inv_scale = np.zeros(len(texs), np.float32)
        rect = np.zeros((len(texs), 4), np.int64)  # x0, y0, w, h in the stacked images
        images, y = [], 0
        for i, t in enumerate(texs):
            if t["kind"] == "solid":
                tex_color[i] = t["color"]
            elif t["kind"] == "checker":
                children[i] = (t["even"], t["odd"])
                inv_scale[i] = 1.0 / float(t["scale"])
            else:
                im = f32(t["image"])
                rect[i] = (0, y, im.shape[1], im.shape[0])
                images.append(im)
                y += im.shape[0]
        width = max([im.shape[1] for im in images], default=1)
        stack = np.zeros((max(y, 1), width, 3), np.float32)
        for i, t in enumerate(texs):
            if t["kind"] == "image":
                x0, y0, w, h = rect[i]
                stack[y0:y0 + h, :w] = f32(t["image"])

        mat_id = np.concatenate([np.asarray(sph["material"], np.int64),
                                 np.asarray(tri["material"], np.int64)])
        kind = self.mat_kind_of[mat_id]
        tid = self.mat_tex_of[mat_id]
        diel = kind == MAT_KINDS["dielectric"]
        tkind = np.where(diel, 0, tex_kind[np.where(tid >= 0, tid, 0)])
        tid = np.where(diel, 0, tid)
        checker = tkind == TEX_KINDS["checker"]
        even = np.where(checker, children[tid, 0], tid)
        odd = np.where(checker, children[tid, 1], tid)

        dev = self.device
        t64 = lambda v: torch.as_tensor(v, dtype=torch.int64, device=dev)
        tf = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=dev).to(dtype)
        # Geometry: spheres [S, 4] (center, radius); triangles [T, 9] (a, e1, e2).
        self.sph = tf(np.concatenate([center, radius[:, None]], 1))
        self.tri = tf(np.concatenate([a, b - a, c - a], 1))
        n_all = ns + nt
        is_sph = np.zeros(n_all, np.float32)
        is_sph[:ns] = 1.0
        pa = np.concatenate([center, a])
        pn = np.concatenate([front, normal])
        self.geo = {  # static rows, [n_all] each, in dtype
            "is_sphere": tf(is_sph), "ax": tf(pa[:, 0]), "ay": tf(pa[:, 1]), "az": tf(pa[:, 2]),
            "radius": tf(np.concatenate([radius, np.zeros(nt, np.float32)])),
            "nx": tf(pn[:, 0]), "ny": tf(pn[:, 1]), "nz": tf(pn[:, 2]),
            "bx": tf(np.concatenate([center[:, 0], b[:, 0]])),
            "by": tf(np.concatenate([center[:, 1], b[:, 1]])),
            "bz": tf(np.concatenate([center[:, 2], b[:, 2]])),
            "cx": tf(np.concatenate([center[:, 0], c[:, 0]])),
            "cy": tf(np.concatenate([center[:, 1], c[:, 1]])),
            "cz": tf(np.concatenate([center[:, 2], c[:, 2]])),
            "cyw": tf(np.concatenate([np.cos(yaw), np.zeros(nt, np.float32)])),
            "syw": tf(np.concatenate([np.sin(yaw), np.zeros(nt, np.float32)])),
            "cp": tf(np.concatenate([np.cos(pitch), np.zeros(nt, np.float32)])),
            "sp": tf(np.concatenate([np.sin(pitch), np.zeros(nt, np.float32)])),
            "kind": tf(kind), "tex_kind": tf(tkind),
            "inv_scale": tf(np.where(checker, inv_scale[tid], 0.0)),
        }
        for k in range(6):
            self.geo[f"uv{k}"] = tf(np.concatenate([np.zeros(ns, np.float32), uv[:, k]]))
        img = tkind == TEX_KINDS["image"]
        for k, name in enumerate(("rx0", "ry0", "rw", "rh")):
            self.geo[name] = t64(np.where(img, rect[tid, k], 0))
        self.mat_id, self.even, self.odd = t64(mat_id), t64(even), t64(odd)
        self.is_diel, self.is_checker = t64(diel).bool(), t64(checker).bool()
        self.has_images = bool(img.any())
        self.leaves = {
            "tex_color": torch.as_tensor(tex_color, device=dev),
            "images": torch.as_tensor(stack, device=dev),
            "mat_fuzz": torch.as_tensor(np.array([m.get("fuzz", 0.0) for m in mats], np.float32),
                                        device=dev),
            "mat_ior": torch.as_tensor(np.array([m.get("ior", 1.0) for m in mats], np.float32),
                                       device=dev),
        }

    def rows(self, leaves: dict | None = None) -> dict:
        """The per-primitive shading rows: the static ones and fuzz, ior,
        even (ce*) and odd (co*) colours gathered from ``leaves`` (default:
        the description's), in ``dtype``."""
        lv = self.leaves if leaves is None else leaves
        cast = lambda t: t.to(self.dtype)
        col = cast(lv["tex_color"])
        even = torch.where(self.is_diel[:, None], torch.ones_like(col[:1]), col[self.even])
        odd = torch.where(self.is_checker[:, None], col[self.odd], torch.zeros_like(col[:1]))
        out = dict(self.geo)
        out["fuzz"] = cast(lv["mat_fuzz"])[self.mat_id]
        out["ior"] = cast(lv["mat_ior"])[self.mat_id]
        for k in range(3):
            out[f"ce{k}"] = even[:, k]
            out[f"co{k}"] = odd[:, k]
        out["images"] = cast(lv["images"])
        return out
