"""K4 and K4b: the nearest hit per ray over a clustered scene's two-level
tables, a hand-written CUDA kernel.

Counterpart of rt_tpu/pallas_ops.py's clustered kernels:

- ``cluster_worklist_nearest`` (K4, ``pallas_call`` at :1015, body
  ``_worklist_kernel`` :562): the clustered wavefront's intersect, launched
  once per iteration over the whole tables (slot bases 0); it also takes
  one cluster page with the page's slot bases, as the JAX package calls it;
- ``cluster_nearest`` (K4b, :533, body ``_cluster_kernel`` :333): the same
  function, predicated; no caller but the tests, as in ``rt_tpu``.

Both take rays in the kernel layout f32[8, N] (rows: origin xyz, direction
xyz, two pad rows; N a multiple of ``RAY_TILE``) and, per primitive kind,
the super AABBs f32[S, 8] (one per 64 clusters), the cluster AABBs
f32[M, 8] (M a multiple of 64) and the slot table (cluster.pack_*_slots:
f32[>=4, M*128] for spheres, f32[>=10, M*128] for triangles).  They return
t f32[N] (``BIG`` on a miss) and the global slot id int32[N] (-1 on a
miss): a sphere winner is ``sph_slot_base`` + its slot, a triangle winner
``n_sph_slots + tri_slot_base`` + its slot.  Among equal t the lowest
primitive id wins, then the lowest slot, spheres before triangles.

On a CUDA tensor each wrapper launches the kernel of csrc/cluster_nearest.cu
(one kernel for both; the walk itself is csrc/cluster_walk.cuh, which K5
shares) or raises; the kernels also read each cluster's live count
(``live_counts``), so that an entered cluster's lanes past its last live
slot load nothing; on a CPU tensor it runs ``cluster_nearest_plain``, the
same walk in plain PyTorch, which the tests hold against the Pallas kernels
in interpret mode and against which the kernel is held on the card.  The
clustered megakernel's plain version searches through it too.
"""

from __future__ import annotations

import numpy as np
import torch

from torch.utils.weak import WeakIdKeyDictionary

from rt_tpu_torch import _build
from rt_tpu_torch.elementwise import div
from rt_tpu_torch.nearest_ops import BIG, RAY_TILE

SUPER_CLUSTERS = 64  # clusters per super (cluster.SUPER_SLOTS)
CLUSTER_SLOTS = 128  # slots per cluster (cluster.CLUSTER_SLOTS)
TRI_EPS = 1e-7
TINY = 1e-20
# The slab test's outward pad of the exit distance, as f32 values
# (rt_tpu/megakernel.py:922), and the inward pad of the entry distance by
# as much, so that the box that holds a ray's nearest hit is entered
# whatever the order of the walk (csrc/cluster_walk.cuh, "Exactness").
PAD_MUL = float(np.float32(1.0 + 6e-7))
ENTRY_MUL = float(np.float32(1.0 - 6e-7))
PAD_ADD = float(np.float32(1e-6))
LANES = 32  # a warp: the walk's lanes
NO_KEY = 0xFFFFFFFF  # a box not admitted, a slot not hit: the key of no float but a NaN
# Sphere boxes are widened by the reach of the sphere pair test's rounding
# past a sphere (csrc/cluster_walk.cuh admits), so that the walk finds
# what a brute-force search over every sphere finds: by the lesser of
# SPHERE_REACH * l1 and l1 * l1 * sphere_reach(slots), l1 the L1 distance
# from the ray's origin to the box's farthest corner.  SPHERE_K is the K of
# both: sqrt(K) and K / (2 * the set's least radius).  cluster_args hands
# both to the kernels.
SPHERE_K = 2e-6
SPHERE_REACH = float(np.float32(1.4142136e-3))  # sqrt(SPHERE_K)
# Rays per pass of the plain walk: bounds its [rays, 128] temporaries.
_PLAIN_CHUNK = 1 << 16

# Per kind: the slot table's row that says whether a slot is live, the value
# a live slot's row is above, and the field rows a lane loads for its pair
# tests (csrc/cluster_walk.cuh walk_cluster).
LIVE_ROW = {"sphere": 3, "triangle": 9}  # the radius; the valid flag
LIVE_MIN = {"sphere": 0.0, "triangle": 0.5}
PAIR_ROWS = {"sphere": 4, "triangle": 10}
LANE_SLOTS = 4  # slots a lane of the warp walk tests: one 16-byte load a row
# live_counts' and sphere_reach's results by slot table: (the table's
# version, the result).
_LIVE_COUNTS = WeakIdKeyDictionary()
_REACH = WeakIdKeyDictionary()

# Launches of the CUDA kernel per wrapper since the last reset.  Only the
# wrappers change them, once per launch; callers read and reset them to
# show that a run went through the kernel.
LAUNCHES = {"cluster_worklist_nearest": 0, "cluster_nearest": 0}


def live_counts(slots: torch.Tensor, kind: str) -> torch.Tensor:
    """Each cluster's live count in a slot table of ``kind`` ("sphere" or
    "triangle"): int32[n_clusters] on the table's device, the index of the
    cluster's last live slot plus one (0 for a cluster with none).  The
    kernels' walk loads and tests only the lanes that hold a slot below it.
    Computed once per table (again only after an in-place change to it) and
    kept while the table lives, so that a launch only looks it up."""
    got = _LIVE_COUNTS.get(slots)
    if got is not None and got[0] == slots._version:
        return got[1]
    alive = (slots[LIVE_ROW[kind]] > LIVE_MIN[kind]).reshape(-1, CLUSTER_SLOTS)
    pos = torch.arange(1, CLUSTER_SLOTS + 1, dtype=torch.int32, device=slots.device)
    counts = torch.where(alive, pos, 0).amax(dim=1).to(torch.int32).contiguous()
    _LIVE_COUNTS[slots] = (slots._version, counts)
    return counts


def sphere_reach(slots: torch.Tensor) -> float:
    """The reach factor of a sphere slot table's boxes: SPHERE_K over twice
    its least live radius, as an f32 value (0 for a table with no live
    slot).  Computed once per table (again only after an in-place change to
    it) and kept while the table lives."""
    got = _REACH.get(slots)
    if got is not None and got[0] == slots._version:
        return got[1]
    radius = slots[LIVE_ROW["sphere"]]
    live = radius > LIVE_MIN["sphere"]
    least = float(radius[live].min()) if bool(live.any()) else float("inf")
    reach = float(np.float32(SPHERE_K / (2.0 * least)))
    _REACH[slots] = (slots._version, reach)
    return reach


def row_bytes(live: int, kind: str) -> tuple[int, int]:
    """Slot-row bytes the warp walk loads for one ray entering a cluster of
    live count ``live``: (the lanes below the live count, all 32 lanes)."""
    lane_bytes = 4 * LANE_SLOTS * PAIR_ROWS[kind]
    return -(-live // LANE_SLOTS) * lane_bytes, CLUSTER_SLOTS // LANE_SLOTS * lane_bytes


def _enters(box, r, best, reach: float | None = None):
    """The padded slab test of rt_tpu/megakernel.py:903-923 for rays r
    (component tensors [K]) against boxes ``box`` f32[B, 8] -> (tn [K, B],
    entered ignoring best [K, B]); a ray enters when also tn <= its best.
    tn is padded inward as the exit distance is padded outward.
    With a ``reach`` (sphere boxes: ``sphere_reach``) each box is first
    widened by the sphere test's reach, as SPHERE_REACH says."""
    live = box[:, 0][None] <= box[:, 3][None]
    lx, ly, lz = box[:, 0][None], box[:, 1][None], box[:, 2][None]
    hx, hy, hz = box[:, 3][None], box[:, 4][None], box[:, 5][None]
    ox, oy, oz = r["ox"][:, None], r["oy"][:, None], r["oz"][:, None]
    idx, idy, idz = r["idx"][:, None], r["idy"][:, None], r["idz"][:, None]
    if reach is not None:
        ex = torch.maximum(torch.abs(lx - ox), torch.abs(hx - ox))
        ey = torch.maximum(torch.abs(ly - oy), torch.abs(hy - oy))
        ez = torch.maximum(torch.abs(lz - oz), torch.abs(hz - oz))
        l1 = ex + ey + ez
        pad = torch.minimum(l1 * SPHERE_REACH, l1 * l1 * reach)
        lx, ly, lz, hx, hy, hz = lx - pad, ly - pad, lz - pad, hx + pad, hy + pad, hz + pad
    t0x, t1x = (lx - ox) * idx, (hx - ox) * idx
    t0y, t1y = (ly - oy) * idy, (hy - oy) * idy
    t0z, t1z = (lz - oz) * idz, (hz - oz) * idz
    tn = torch.maximum(torch.maximum(torch.minimum(t0x, t1x), torch.minimum(t0y, t1y)),
                       torch.clamp(torch.minimum(t0z, t1z), min=0.0))
    tn = tn * ENTRY_MUL - PAD_ADD
    tf = torch.minimum(torch.minimum(torch.maximum(t0x, t1x), torch.maximum(t0y, t1y)),
                       torch.maximum(t0z, t1z))
    tf = tf * PAD_MUL + PAD_ADD
    return tn, (tn <= tf) & (tf >= 0.0) & live


def order_key(t):
    """order(t) of csrc/rt_common.cuh as int64: an unsigned that orders like
    the float, -0 taken as +0."""
    bits = torch.where(t == 0, 0.0, t).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(bits >= 1 << 31, ~bits & 0xFFFFFFFF, bits | (1 << 31))


def near_order(tn, admitted):
    """The kernels' near-to-far order (csrc/cluster_walk.cuh next_box) of a
    group of at most 64 boxes for each ray: ``tn``, ``admitted`` [K, G] ->
    the boxes' places [K, G], admitted boxes by their keys order(tn), equal
    keys by lane (box b is lane b % 32's), a lane's first box before its
    second."""
    b = torch.arange(tn.shape[1], device=tn.device)
    key = torch.where(admitted, order_key(tn), NO_KEY) * 64 + (b % LANES) * 2 + b // LANES
    return torch.argsort(key, dim=1)


def _sphere_pairs(r, s, t_min: float, t_max: float):
    """Sphere pair tests (pallas_ops.py:412-430) of rays r [K] against the
    slot columns s f32[>=4, 128] -> candidate t [K, 128], BIG where none."""
    ox, oy, oz = r["ox"][:, None], r["oy"][:, None], r["oz"][:, None]
    dx, dy, dz = r["dx"][:, None], r["dy"][:, None], r["dz"][:, None]
    a, inv_a = r["a"][:, None], r["inv_a"][:, None]
    rad = s[3][None]
    ocx, ocy, ocz = s[0][None] - ox, s[1][None] - oy, s[2][None] - oz
    h = dx * ocx + dy * ocy + dz * ocz
    c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad
    disc = h * h - a * c
    sd = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (h - sd) * inv_a
    t1 = (h + sd) * inv_a
    t = torch.where(t0 >= t_min, t0, t1)
    ok = (rad > 0.0) & (disc >= 0.0) & (t >= t_min) & (t < t_max)
    return torch.where(ok, t, BIG)


def _triangle_pairs(r, s, t_min: float, t_max: float, cull: bool):
    """Triangle pair tests (pallas_ops.py:442-480) of rays r [K] against
    the slot columns s f32[>=10, 128] -> candidate t [K, 128]."""
    ox, oy, oz = r["ox"][:, None], r["oy"][:, None], r["oz"][:, None]
    dx, dy, dz = r["dx"][:, None], r["dy"][:, None], r["dz"][:, None]
    ax, ay, az = s[0][None], s[1][None], s[2][None]
    e1x, e1y, e1z = s[3][None], s[4][None], s[5][None]
    e2x, e2y, e2z = s[6][None], s[7][None], s[8][None]
    uvx = dy * e2z - dz * e2y
    uvy = dz * e2x - dx * e2z
    uvz = dx * e2y - dy * e2x
    det = e1x * uvx + e1y * uvy + e1z * uvz
    det_ok = det > TRI_EPS if cull else torch.abs(det) > TRI_EPS
    inv_det = div(1.0, torch.where(det_ok, det, 1.0))
    aox, aoy, aoz = ox - ax, oy - ay, oz - az
    u = (aox * uvx + aoy * uvy + aoz * uvz) * inv_det
    vvx = aoy * e1z - aoz * e1y
    vvy = aoz * e1x - aox * e1z
    vvz = aox * e1y - aoy * e1x
    v = (dx * vvx + dy * vvy + dz * vvz) * inv_det
    t = (e2x * vvx + e2y * vvy + e2z * vvz) * inv_det
    ok = (det_ok & (s[9][None] > 0.5) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (u + v <= 1.0)
          & (t >= t_min) & (t < t_max) & (t > TRI_EPS))
    return torch.where(ok, t, BIG)


def _walk_set(r, best_t, best_i, best_r, supers, clusters, slots, prim, id_base: int,
              slot_base: int, pairs, work: dict | None, kind: str):
    """One kind's walk for all rays r, in ascending order: supers in
    turn, each entered super's clusters in turn, each entered cluster's
    slots; ``best_t``/``best_i`` [N] and the best's rank ``best_r`` [N]
    are updated in place.  Among equal t the lowest primitive id ``prim``
    (int32[slots]) wins, then the lowest slot (the first visited).  The
    kernels visit boxes near to far and enter fewer; they return the same
    winner (csrc/cluster_walk.cuh, "Exactness").  ``work``, when
    given, counts the slab tests and the pair tests the walk makes on live
    boxes and slots, as the kernel makes them, and the slot-row bytes the
    kernel loads for the clusters it enters (``row_bytes``:
    "<kind>_row_bytes" for the lanes below each cluster's live count,
    "<kind>_row_bytes_whole" for all 32 lanes) and the (ray, box) pairs it
    enters ("<kind>_super_entries", "<kind>_cluster_entries"), and gathers
    the supers and clusters some ray entered (by their index in the unpaged
    tables, ``slot_base`` / CLUSTER_SLOTS + the page's own index)."""
    reach = sphere_reach(slots) if kind == "sphere" else None
    ranks = prim.to(device=slots.device, dtype=torch.int64)
    no_rank = torch.iinfo(torch.int64).max
    sup_live = (supers[:, 0] <= supers[:, 3]).tolist()
    cl_live = (clusters[:, 0] <= clusters[:, 3]).tolist()
    n_clusters = clusters.shape[0]
    first = slot_base // CLUSTER_SLOTS
    if work is not None:
        alive = (slots[LIVE_ROW[kind]] > LIVE_MIN[kind]).reshape(-1, CLUSTER_SLOTS)
        live_slots = alive.sum(dim=1).tolist()
        loads = [row_bytes(n, kind) for n in live_counts(slots, kind).tolist()]
        for key in ("row_bytes", "row_bytes_whole", "super_entries", "cluster_entries"):
            work.setdefault(f"{kind}_{key}", 0)
        work["slab"] = work.get("slab", 0) + r["ox"].shape[0] * sum(sup_live)
        entered_supers = work.setdefault(f"{kind}_supers", set())
        entered_clusters = work.setdefault(f"{kind}_clusters", set())
    for si, live in enumerate(sup_live):
        if not live:
            continue
        tn, ent = _enters(supers[si : si + 1], r, best_t, reach)
        rays_s = torch.nonzero(ent[:, 0] & (tn[:, 0] <= best_t))[:, 0]
        if rays_s.numel() == 0:
            continue
        sub = {k: v[rays_s] for k, v in r.items()}
        bt, bi, br = best_t[rays_s], best_i[rays_s], best_r[rays_s]
        c_lo, c_hi = si * SUPER_CLUSTERS, min(n_clusters, (si + 1) * SUPER_CLUSTERS)
        tn_c, ent_c = _enters(clusters[c_lo:c_hi], sub, bt, reach)
        if work is not None:
            work["slab"] += rays_s.numel() * sum(cl_live[c_lo:c_hi])
            work[f"{kind}_super_entries"] += rays_s.numel()
            entered_supers.add((first + c_lo) // SUPER_CLUSTERS)
        for ci in range(c_lo, c_hi):
            if not cl_live[ci]:
                continue
            k = ci - c_lo
            rows = torch.nonzero(ent_c[:, k] & (tn_c[:, k] <= bt))[:, 0]
            if rows.numel() == 0:
                continue
            if work is not None:
                work[f"{kind}_pairs"] = work.get(f"{kind}_pairs", 0) + rows.numel() * live_slots[ci]
                work[f"{kind}_row_bytes"] += rows.numel() * loads[ci][0]
                work[f"{kind}_row_bytes_whole"] += rows.numel() * loads[ci][1]
                work[f"{kind}_cluster_entries"] += rows.numel()
                entered_clusters.add(first + ci)
            cand = pairs({key: v[rows] for key, v in sub.items()},
                         slots[:, ci * CLUSTER_SLOTS : (ci + 1) * CLUSTER_SLOTS])
            c_t = cand.min(dim=1).values
            rk = ranks[ci * CLUSTER_SLOTS : (ci + 1) * CLUSTER_SLOTS][None]
            tie = (cand == c_t[:, None]) & (cand < BIG)
            c_r = torch.where(tie, rk, no_rank).min(dim=1).values
            c_k = (tie & (rk == c_r[:, None])).to(torch.int8).argmax(dim=1)  # the first of them
            better = (c_t < bt[rows]) | ((c_t == bt[rows]) & (c_r < br[rows]))
            bt[rows] = torch.where(better, c_t, bt[rows])
            bi[rows] = torch.where(better, (c_k + (id_base + ci * CLUSTER_SLOTS)).to(torch.int32),
                                   bi[rows])
            br[rows] = torch.where(better, c_r, br[rows])
        best_t[rays_s], best_i[rays_s], best_r[rays_s] = bt, bi, br


def cluster_nearest_plain(rays, sph_super, sph_cluster, sph_slots, sph_prim, tri_super,
                          tri_cluster, tri_slots, tri_prim, n_sph_slots: int, t_min: float,
                          t_max: float, backface_cull: bool = True, sph_slot_base: int = 0,
                          tri_slot_base: int = 0, work: dict | None = None):
    """K4's plain version: the arguments and result of
    ``cluster_worklist_nearest`` (``rays`` f32[>=6, N], any N).  The walk of
    csrc/cluster_walk.cuh vectorized over rays, in the sequential order of a
    scan (supers, then each entered super's clusters, in ascending index):
    the entered masks per (ray, super) and per (ray, cluster) come from the
    same padded slab test and the same ``tn <= best`` rule, with pair tests
    over each ray's entered clusters only.  The kernels visit the admitted
    boxes near to far instead, and so enter fewer; the winner is the least
    (t, id, slot) over the valid slots of the entered clusters, and the
    cluster that holds it is entered in either order, so the two return
    the same t and slot.  Ties of t go to the lowest primitive id
    ``sph_prim`` / ``tri_prim`` (ClusterData's), then the lowest slot.
    ``work``, when given,
    accumulates the walk's slab tests ("slab") and pair tests ("sphere_pairs",
    "triangle_pairs"), the slot-row bytes the kernel loads under the live
    counts and under whole clusters ("sphere_row_bytes",
    "sphere_row_bytes_whole", "triangle_row_bytes",
    "triangle_row_bytes_whole"), the (ray, box) pairs entered
    ("sphere_super_entries", "sphere_cluster_entries",
    "triangle_super_entries", "triangle_cluster_entries"), and the sets of
    supers and clusters some
    ray entered ("sphere_supers", "sphere_clusters", "triangle_supers",
    "triangle_clusters"), from which a measurement works out the kernel's
    least time."""
    n = rays.shape[1]
    device = rays.device
    t_out = torch.full((n,), BIG, device=device)
    i_out = torch.full((n,), -1, dtype=torch.int32, device=device)
    sph_pairs = lambda r, s: _sphere_pairs(r, s, t_min, t_max)
    tri_pairs = lambda r, s: _triangle_pairs(r, s, t_min, t_max, backface_cull)
    tiny = torch.tensor(TINY, dtype=torch.float32)
    for lo in range(0, n, _PLAIN_CHUNK):
        ray = rays[:6, lo : lo + _PLAIN_CHUNK]
        ox, oy, oz, dx, dy, dz = ray
        a = dx * dx + dy * dy + dz * dz
        r = dict(ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz, a=a, inv_a=div(1.0, a))
        for axis, d in (("idx", dx), ("idy", dy), ("idz", dz)):
            r[axis] = div(1.0, torch.where(torch.abs(d) > tiny, d, tiny.to(device)))
        best_t, best_i = t_out[lo : lo + _PLAIN_CHUNK], i_out[lo : lo + _PLAIN_CHUNK]
        best_r = torch.full_like(best_i, -1, dtype=torch.int64)
        _walk_set(r, best_t, best_i, best_r, sph_super, sph_cluster, sph_slots, sph_prim,
                  sph_slot_base, sph_slot_base, sph_pairs, work, "sphere")
        _walk_set(r, best_t, best_i, best_r, tri_super, tri_cluster, tri_slots, tri_prim,
                  n_sph_slots + tri_slot_base, tri_slot_base, tri_pairs, work, "triangle")
    return t_out, i_out


def cluster_tables(cl) -> tuple:
    """The whole two-level tables of ``ClusterData`` and its slots'
    primitive ids in the order the wrappers take them: (sph_super,
    sph_cluster, sph_slots, sph_prim, tri_super, tri_cluster, tri_slots,
    tri_prim)."""
    return (cl.sph_super, cl.sph_cluster, cl.sph_slots, cl.sph_prim, cl.tri_super,
            cl.tri_cluster, cl.tri_slots, cl.tri_prim)


def check_tables(name: str, tables) -> None:
    """Raise unless ``tables`` (``cluster_tables``' order) have the
    two-level layout and an int32 primitive id for every slot."""
    def kind_ok(sup, cl, slots, prim, rows):
        return (sup.dim() == 2 and sup.shape[1] == 8 and cl.dim() == 2 and cl.shape[1] == 8
                and cl.shape[0] % SUPER_CLUSTERS == 0
                and sup.shape[0] * SUPER_CLUSTERS >= cl.shape[0]
                and slots.dim() == 2 and slots.shape[0] >= rows
                and slots.shape[1] == cl.shape[0] * CLUSTER_SLOTS
                and prim.dtype == torch.int32 and prim.shape == (slots.shape[1],))

    if not (kind_ok(*tables[0:4], 4) and kind_ok(*tables[4:8], 10)):
        raise ValueError(
            f"{name}: need per kind supers [S, 8] covering clusters [k*{SUPER_CLUSTERS}, 8], "
            f"slots [>=4 or >=10, clusters*{CLUSTER_SLOTS}] and int32 ids [clusters*"
            f"{CLUSTER_SLOTS}], got " + ", ".join(str(tuple(t.shape)) for t in tables))


def _check_rays(name: str, rays) -> None:
    if rays.dim() != 2 or rays.shape[0] != 8 or rays.shape[1] % RAY_TILE:
        raise ValueError(f"{name}: need rays [8, k*{RAY_TILE}], got {tuple(rays.shape)}")


def cluster_worklist_nearest(rays, sph_super, sph_cluster, sph_slots, sph_prim, tri_super,
                             tri_cluster, tri_slots, tri_prim, n_sph_slots: int, t_min: float,
                             t_max: float, backface_cull: bool = True, sph_slot_base: int = 0,
                             tri_slot_base: int = 0):
    """K4: (t f32[N], slot int32[N]) over the whole cluster tables, or
    over one page of them with its slot bases; ties of t as
    ``cluster_nearest_plain`` breaks them."""
    tables = (sph_super, sph_cluster, sph_slots, sph_prim, tri_super, tri_cluster, tri_slots,
              tri_prim)
    _check_rays("cluster_worklist_nearest", rays)
    check_tables("cluster_worklist_nearest", tables)
    if rays.device.type == "cpu":
        return cluster_nearest_plain(rays, *tables, n_sph_slots, t_min, t_max, backface_cull,
                                     sph_slot_base, tri_slot_base)
    return _launch("cluster_worklist_nearest", rays, tables, sph_slot_base,
                   n_sph_slots + tri_slot_base, t_min, t_max, backface_cull)


def cluster_nearest(rays, sph_super, sph_cluster, sph_slots, sph_prim, tri_super, tri_cluster,
                    tri_slots, tri_prim, n_sph_slots: int, t_min: float, t_max: float,
                    backface_cull: bool = True):
    """K4b: (t f32[N], slot int32[N]) over unpaged cluster tables."""
    tables = (sph_super, sph_cluster, sph_slots, sph_prim, tri_super, tri_cluster, tri_slots,
              tri_prim)
    _check_rays("cluster_nearest", rays)
    check_tables("cluster_nearest", tables)
    if rays.device.type == "cpu":
        return cluster_nearest_plain(rays, *tables, n_sph_slots, t_min, t_max, backface_cull)
    return _launch("cluster_nearest", rays, tables, 0, n_sph_slots, t_min, t_max, backface_cull)


def cluster_args(tables, device, name: str = "cluster tables") -> list:
    """The C arguments of one clustered scene's tables (``cluster_tables``'
    order) for the kernels of csrc/cluster_walk.cuh: per kind (supers,
    count, clusters, count, slots, live counts, slot primitive ids, the two
    widening factors), each table checked to be a contiguous f32 on
    ``device`` and the ids an int32, the live counts ``live_counts``'
    int32, the factors SPHERE_REACH and ``sphere_reach``'s for spheres and 0
    for triangles."""
    out = []
    for kind, (sup, cl, slots, prim) in (("sphere", tables[0:4]), ("triangle", tables[4:8])):
        for t, what in ((sup, "super"), (cl, "cluster"), (slots, "slots")):
            _build.require(t, f"{name}: {kind[:3]}_{what}", device)
        _build.require(prim, f"{name}: {kind[:3]}_prim", device, torch.int32)
        if prim.shape != (slots.shape[1],):
            raise ValueError(f"{name}: {kind[:3]}_prim needs [{slots.shape[1]}]")
        widen = (SPHERE_REACH, sphere_reach(slots)) if kind == "sphere" else (0.0, 0.0)
        out += [sup.data_ptr(), sup.shape[0], cl.data_ptr(), cl.shape[0], slots.data_ptr(),
                live_counts(slots, kind).data_ptr(), prim.data_ptr(), *widen]
    return out


def _launch(name: str, rays, tables, sph_base: int, tri_base: int, t_min: float, t_max: float,
            backface_cull: bool):
    """Wrapper of the CUDA kernel: checks its inputs, allocates the outputs
    and launches on the current stream.  Raises on any failure."""
    device = rays.device
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {device}")
    _build.require(rays, f"{name}: rays", device)
    args = cluster_args(tables, device, name)  # 9 a kind
    n = rays.shape[1]
    t_out = torch.empty((n,), dtype=torch.float32, device=device)
    idx = torch.empty((n,), dtype=torch.int32, device=device)
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.rt_cluster_nearest(
            rays.data_ptr(), n, *args[:9], int(sph_base), *args[9:], int(tri_base), t_min,
            t_max, int(bool(backface_cull)), t_out.data_ptr(), idx.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")
    LAUNCHES[name] += 1
    return t_out, idx
