"""Spatial clustering of primitives (rt_tpu/cluster.py, copied whole).

The clustered scenes' acceleration structure is a *fixed-stride two-level
cluster grid* derived from the SAH BVH, as in the JAX package (whose
Pallas kernels could not chase per-ray BVH pointers):

- level 0: primitives, reordered into BVH-leaf order and padded so every
  **cluster owns exactly CLUSTER_SLOTS (128) slots** (dummy slots can
  never hit);
- level 1: clusters, padded so every **super owns exactly SUPER_SLOTS
  (64) clusters** (dummy clusters have inverted AABBs).

Fixed strides mean the kernel addresses are ``super*64 + cluster`` and
``cluster*128 + slot`` — no indirection tables.  The port's kernels
(csrc/cluster_walk.cuh) walk them per ray: supers -> entered clusters ->
their 128 slots.

Spheres and triangles get separate cluster sets (homogeneous chunk
layouts).  The shade table (fast_shade.py) is emitted in *slot order* so
kernel winner ids index it directly.
"""

from __future__ import annotations

import numpy as np

CLUSTER_SLOTS = 128  # prims per cluster (= BVH leaf budget = kernel lane width)
SUPER_SLOTS = 64  # clusters per super


def _leaf_clusters(mins: np.ndarray, maxs: np.ndarray, leaf_size: int):
    """BVH-leaf clustering: returns (list of prim-id arrays) in DFS order."""
    from rt_tpu_torch.bvh.builder import build_arrays

    _, _, _, _, leaf_start, leaf_count, prim_order = build_arrays(mins, maxs, leaf_size)
    clusters = []
    for start, count in zip(leaf_start, leaf_count):
        if start >= 0 and count > 0:
            clusters.append(prim_order[start : start + count])
    return clusters


def _box_area(lo, hi):
    e = np.maximum(hi - lo, 0.0)
    return 2.0 * (e[0] * e[1] + e[1] * e[2] + e[0] * e[2])


def _pack_leaves(leaves, mins, maxs, max_clusters, cap=1.0):
    """Pack SAH leaves into <=CLUSTER_SLOTS clusters, merging CONSECUTIVE
    leaves only when the union AABB's surface area stays within ``cap`` x
    the summed areas (a free merge: side-by-side boxes pass, depth-
    separated boxes fail).  Round-3 packed the DFS order into EXACT
    128-prim windows for perfect fill — but windows cut ACROSS leaf
    boundaries, and on closed curved meshes the merged boxes overlap so
    badly that every grazing ray entered ~12 clusters instead of ~4
    (tools/bin_sim.py; the blob-class collapse's root cause).  Leaf-
    preserving packing costs ~30% fill and buys ~3x tighter entry sets.

    When the leaf count exceeds ``max_clusters`` (the clustered kernels'
    static super budget), the cap escalates (then falls back to plain
    windows) so huge streamed scenes keep their capacity."""
    for c in (cap, 2.0, 4.0, 16.0):
        out = []
        cur, clo, chi, n = None, None, None, 0
        for ids in leaves:
            llo = mins[ids].min(axis=0)
            lhi = maxs[ids].max(axis=0)
            if cur is None:
                cur, clo, chi, n = [ids], llo, lhi, len(ids)
                continue
            ulo = np.minimum(clo, llo)
            uhi = np.maximum(chi, lhi)
            if n + len(ids) <= CLUSTER_SLOTS and _box_area(
                ulo, uhi
            ) <= c * (_box_area(clo, chi) + _box_area(llo, lhi)):
                cur.append(ids)
                clo, chi, n = ulo, uhi, n + len(ids)
            else:
                out.append(np.concatenate(cur))
                cur, clo, chi, n = [ids], llo, lhi, len(ids)
        if cur is not None:
            out.append(np.concatenate(cur))
        if max_clusters is None or len(out) <= max_clusters:
            return out
    dfs_order = np.concatenate(leaves)
    return [
        dfs_order[i : i + CLUSTER_SLOTS]
        for i in range(0, len(dfs_order), CLUSTER_SLOTS)
    ]


def build_clusters(
    mins: np.ndarray, maxs: np.ndarray, max_clusters: int | None = None
):
    """Cluster primitives by AABB.

    Returns (slot_of_prim i32[P] -> slot index, slots i32[M*CLUSTER_SLOTS] -> prim id
    or -1, cluster_aabb f32[M_pad, 8], super_aabb f32[S, 8]) where M_pad is
    a SUPER_SLOTS multiple and dummy entries have inverted AABBs.

    ``max_clusters`` bounds the emitted cluster count (pre-padding); the
    leaf packer escalates its merge cap to honor it (see _pack_leaves).
    """
    p = mins.shape[0]
    if p == 0:
        clusters = []
    elif p <= CLUSTER_SLOTS:
        clusters = [np.arange(p, dtype=np.int32)]
    else:
        leaves = _leaf_clusters(mins, maxs, CLUSTER_SLOTS)
        clusters = _pack_leaves(leaves, mins, maxs, max_clusters)

    m = max(len(clusters), 1)
    m_pad = -(-m // SUPER_SLOTS) * SUPER_SLOTS
    slots = np.full((m_pad * CLUSTER_SLOTS,), -1, np.int64)
    # AABB tables are [M, 8]: clusters on sublanes (the kernels chunk or
    # scalar-index them along sublanes; the 8 fields pad to one lane tile).
    cluster_aabb = np.zeros((m_pad, 8), np.float32)
    cluster_aabb[:, 0:3] = np.inf  # dummy: inverted AABB never hits
    cluster_aabb[:, 3:6] = -np.inf
    for ci, ids in enumerate(clusters):
        assert len(ids) <= CLUSTER_SLOTS
        slots[ci * CLUSTER_SLOTS : ci * CLUSTER_SLOTS + len(ids)] = ids
        cluster_aabb[ci, 0:3] = mins[ids].min(axis=0)
        cluster_aabb[ci, 3:6] = maxs[ids].max(axis=0)

    n_supers = m_pad // SUPER_SLOTS
    super_aabb = np.zeros((max(n_supers, 1), 8), np.float32)
    for si in range(n_supers):
        block = cluster_aabb[si * SUPER_SLOTS : (si + 1) * SUPER_SLOTS]
        live = block[:, 0] <= block[:, 3]
        if live.any():
            super_aabb[si, 0:3] = block[live, 0:3].min(axis=0)
            super_aabb[si, 3:6] = block[live, 3:6].max(axis=0)
        else:
            super_aabb[si, 0:3] = np.inf
            super_aabb[si, 3:6] = -np.inf

    slot_of_prim = np.full((max(p, 1),), 0, np.int64)
    live = slots >= 0
    slot_of_prim[slots[live]] = np.nonzero(live)[0]
    return slot_of_prim, slots, cluster_aabb, super_aabb


MAX_INLINE_TEXREFS = 64  # 6-bit side-table ids in the essentials int row
MAX_INLINE_CHECKERS = MAX_INLINE_TEXREFS  # back-compat alias


def build_essentials(shade_cols: np.ndarray):
    """Per-prim shading essentials as 4 PLAIN-VALUE f32 rows (they ride
    the sublane-pad rows of the slot tables, so VMEM-free) plus a tiny
    deduplicated checker side table.

    The in-kernel fetch is a HIGHEST-precision one-hot matmul, which
    reproduces float VALUES to ~2^-22 relative but cannot carry bit
    patterns (sub-bf16 magnitudes flush to zero on the MXU).  So every
    row is either a plain value or a small integer (< 2^22 survives the
    matmul to within +-0.25 and rounds back exactly):

      e0: ce.r   (dielectric: IOR — its attenuation is identically 1,
                  material.rs:160, so colors are dead)
      e1: ce.g
      e2: ce.b
      e3: int(kind<<20 | tex_kind<<18 | texref_id<<12 | fuzz_q12)

    Per-texture data lives in the returned side table f32[8, 128]
    indexed by texref_id — scenes keep a handful of distinct
    checkers/images while prim counts reach millions:
      checker entry rows: inv_scale, even rgb, odd rgb, pad
      image entry rows:   front_dir xyz, rect x0 y0 w h  (sphere facing
                          + atlas rect; the atlas itself is a separate
                          VMEM input)

    Returns (essentials f32[4, P], tex_table f32[8, 128], ok) — ok is
    False when the scene exceeds MAX_INLINE_TEXREFS side entries or has
    image-textured TRIANGLES (their per-vertex UVs don't fit the slot
    tables; callers fall back to the HBM-DMA fetch path)."""
    from rt_tpu_torch import fast_shade as FS

    kind = shade_cols[FS.F_MAT_KIND].astype(np.int64)
    texk = shade_cols[FS.F_TEX_KIND].astype(np.int64)
    is_sph = shade_cols[FS.F_IS_SPHERE] > 0.5
    fuzz = shade_cols[FS.F_FUZZ]
    ior = shade_cols[FS.F_IOR].astype(np.float32)
    inv_scale = shade_cols[FS.F_INV_SCALE].astype(np.float32)
    ce = shade_cols[FS.F_CE : FS.F_CE + 3].astype(np.float32)
    co = shade_cols[FS.F_CO : FS.F_CO + 3].astype(np.float32)
    fdir = shade_cols[FS.F_NX : FS.F_NX + 3].astype(np.float32)
    rect = shade_cols[FS.F_RECT : FS.F_RECT + 4].astype(np.float32)

    tex_table = np.zeros((8, 128), np.float32)
    ref_id = np.zeros(shade_cols.shape[1], np.int64)
    n_used = 0
    ok = True

    def dedupe(mask, rows):
        nonlocal n_used, ok
        if not mask.any() or not ok:
            return
        rec = rows[:, mask].T.copy().view([("", np.float32)] * rows.shape[0])
        uniq, inv = np.unique(rec, return_inverse=True)
        if n_used + len(uniq) > MAX_INLINE_TEXREFS:
            ok = False
            return
        tex_table[: rows.shape[0], n_used : n_used + len(uniq)] = (
            uniq.view(np.float32).reshape(len(uniq), rows.shape[0]).T
        )
        ref_id[mask] = n_used + inv.reshape(-1)
        n_used += len(uniq)

    dedupe(
        texk == 1,
        np.stack([inv_scale, ce[0], ce[1], ce[2], co[0], co[1], co[2]]),
    )
    dedupe(
        is_sph & (texk == 2),
        np.stack([fdir[0], fdir[1], fdir[2], rect[0], rect[1], rect[2], rect[3]]),
    )
    # Image-textured TRIANGLES dedupe by atlas rect alone (facing rows
    # zeroed: triangles use their derived flat normal, never the table's);
    # their per-vertex UVs ride the 24-row triangle slot table.
    zero = np.zeros_like(rect[0])
    dedupe(
        ~is_sph & (texk == 2),
        np.stack([zero, zero, zero, rect[0], rect[1], rect[2], rect[3]]),
    )

    fuzz_q = np.clip(np.round(fuzz * 4095.0), 0, 4095).astype(np.int64)
    e3 = (
        ((kind & 3) << 20) | ((texk & 3) << 18) | ((ref_id & 63) << 12) | fuzz_q
    ).astype(np.float32)
    e0 = np.where(kind == 2, ior, ce[0]).astype(np.float32)
    ess = np.stack([e0, ce[1], ce[2], e3])
    return ess, tex_table, ok


def pack_sphere_slots(
    slots: np.ndarray,
    centers: np.ndarray,
    radius: np.ndarray,
    essentials: np.ndarray | None = None,
) -> np.ndarray:
    """Slot-ordered kernel sphere table f32[8, n_slots] (fields on
    sublanes, slots on lanes — the VMEM-exact layout; a [n,4] table would
    lane-pad 4 -> 128 and blow VMEM 32x); dummies r=0.

    Rows 0-3: center xyz, radius.  Rows 4-7: shade essentials
    (build_essentials rows for this set's prims) — they live in the
    sublane pad 4 -> 8, so the VMEM footprint is unchanged."""
    n = slots.shape[0]
    out = np.zeros((8, n), np.float32)
    live = slots >= 0
    out[0:3, live] = centers[slots[live]].T
    out[3, live] = radius[slots[live]]
    if essentials is not None:
        out[4:8, live] = essentials[:, slots[live]]
    return out


def pack_triangle_slots(
    slots: np.ndarray,
    a: np.ndarray,
    b: np.ndarray,
    c: np.ndarray,
    essentials: np.ndarray | None = None,
    uva: np.ndarray | None = None,
) -> np.ndarray:
    """Slot-ordered kernel triangle table f32[16, n_slots]
    (rows: a, e1, e2, valid, essentials x4, pad x2; same lane layout
    rationale and pad-row essentials as pack_sphere_slots); dummies
    valid=0.

    With ``uva`` (f32[6, n_tris] per-vertex UVs — present when the scene
    has image-textured triangles) the table grows to [24, n_slots] with
    the UVs at rows 16-21 in full precision."""
    n = slots.shape[0]
    rows = 24 if uva is not None else 16
    out = np.zeros((rows, n), np.float32)
    live = slots >= 0
    ids = slots[live]
    out[0:3, live] = a[ids].T
    out[3:6, live] = (b[ids] - a[ids]).T
    out[6:9, live] = (c[ids] - a[ids]).T
    out[9, live] = 1.0
    if essentials is not None:
        out[10:14, live] = essentials[:, slots[live]]
    if uva is not None:
        out[16:22, live] = uva[:, ids]
    return out
