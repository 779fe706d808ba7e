"""Wavefront OBJ loader.

Replaces the reference's use of the `tobj` crate with GPU_LOAD_OPTIONS
(triangulate + single index; hittable.rs:497-554).  Pure host-side Python
feeding SoA triangle arrays — there is no perf need for native code here
(SURVEY.md §2.2).

Behavior matched to the reference path:
- positions chunked into triangles via the face index list;
- default UVs per triangle ((0,0),(1,0),(0.5,1)) when the OBJ has no
  texcoords, matching Triangle::new (hittable.rs:175-177) — when texcoords
  exist they are carried through (tobj's single-index would too);
- optional 4x4 transform applied to vertices at load time (the reference
  rebuilds each Triangle through Triangle::transform, hittable.rs:214-227);
- polygon faces are fan-triangulated (tobj's `triangulate`).

The reference's broken `centered` re-centering path (hittable.rs:537-551,
author: "doesn't work at all") is implemented *correctly* here: opt-in
re-centering about the vertex mean.
"""

from __future__ import annotations

import numpy as np

from rt_tpu_torch import profiling

# Files loaded, face records read and triangles assembled (after fan
# triangulation), accumulated over calls; callers reset them.
COUNTS = {"files": 0, "faces": 0, "triangles": 0}


def load_obj(
    path: str,
    transform: np.ndarray | None = None,
    centered: bool = False,
) -> list[dict]:
    """Parse an OBJ file into per-object triangle arrays.

    Returns a list of models, each ``{"vertices": f32[n,3,3],
    "uvs": f32[n,3,2] | None, "name": str}``.  Spans: ``rt.obj.load``
    around ``rt.obj.parse`` (the text) and ``rt.obj.assemble`` (the
    arrays; its argument is the triangle count).
    """
    with profiling.span("obj.load"):
        with profiling.span("obj.parse"):
            positions, texcoords, groups, n_faces = _parse(path)
        n_triangles = sum(len(faces) for _, faces in groups)
        with profiling.span("obj.assemble", n_triangles):
            pos = np.asarray(positions, np.float32)
            tex = np.asarray(texcoords, np.float32) if texcoords else None
            models = [_assemble(pos, tex, faces, name) for name, faces in groups]
            for model in models:
                v = model["vertices"]
                if centered:
                    v = v - v.reshape(-1, 3).mean(axis=0, keepdims=True)
                if transform is not None:
                    t = np.asarray(transform, np.float32)
                    flat = v.reshape(-1, 3)
                    # nalgebra's transform_vector: rotation/scale only, no
                    # translation (hittable.rs:215-217 uses transform_vector).
                    flat = flat @ t[:3, :3].T
                    v = flat.reshape(-1, 3, 3)
                model["vertices"] = np.ascontiguousarray(v, np.float32)
    COUNTS["files"] += 1
    COUNTS["faces"] += n_faces
    COUNTS["triangles"] += n_triangles
    return models


def _parse(path: str):
    """(positions, texcoords, [(name, triangles as ((vi, ti) x 3))], face
    records) of an OBJ file; indices are resolved to 0-based, -1 for a
    missing texture coordinate."""
    positions: list[list[float]] = []
    texcoords: list[list[float]] = []
    groups: list[tuple[str, list]] = []
    cur_faces: list[list[tuple[int, int]]] = []
    cur_name = "default"
    n_faces = 0

    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            tag = parts[0]
            if tag == "v":
                positions.append([float(x) for x in parts[1:4]])
            elif tag == "vt":
                texcoords.append([float(parts[1]), float(parts[2]) if len(parts) > 2 else 0.0])
            elif tag in ("o", "g"):
                if cur_faces:
                    groups.append((cur_name, cur_faces))
                cur_faces = []
                cur_name = parts[1] if len(parts) > 1 else "default"
            elif tag == "f":
                n_faces += 1
                verts = []
                for token in parts[1:]:
                    fields = token.split("/")
                    vi = int(fields[0])
                    vi = vi - 1 if vi > 0 else len(positions) + vi
                    ti = -1
                    if len(fields) > 1 and fields[1]:
                        t = int(fields[1])
                        ti = t - 1 if t > 0 else len(texcoords) + t
                    verts.append((vi, ti))
                # Fan triangulation (tobj `triangulate` equivalent).
                for k in range(1, len(verts) - 1):
                    cur_faces.append([verts[0], verts[k], verts[k + 1]])
    if cur_faces:
        groups.append((cur_name, cur_faces))
    return positions, texcoords, groups, n_faces


def _assemble(pos: np.ndarray, tex: np.ndarray | None, faces, name) -> dict:
    idx = np.asarray(faces, np.int64).reshape(len(faces), 3, 2)
    has_uv = tex is not None and bool((idx[..., 1] >= 0).all())
    vertices = pos[idx[..., 0]]
    uvs = tex[idx[..., 1]] if has_uv else None
    return {"vertices": vertices, "uvs": uvs, "name": name}
