"""The order of the warp-cooperative cluster walk (csrc/cluster_walk.cuh),
proved on the CPU.

The CUDA walk that K4/K4b and K5 share takes a ray with a whole warp: each
lane slab-tests boxes ``lane`` and ``lane + 32`` of a group of 64 ignoring
the ray's best t, and the admitted boxes are visited near to far (by their
entry distance; equal ones by lane, a lane's first box before its second),
each entered only if its entry distance is not above the best t at that
moment, the visit stopping at the first that is; supers so in groups of 64,
then each entered super's clusters.  An entered cluster's 128 slots are
tested 4 a lane (lane l takes slots 4l
to 4l + 3, and only when 4l is below the cluster's live count, the index of
its last live slot plus one: the other lanes load nothing and hold no
key), and the winner is the least packed key (order(t), slot) over a
lane's 4 slots, then over 32 lanes; where t ties within the cluster or
with the best so far, the lowest primitive id among the tied slots wins,
and it replaces a best of equal t only with a lower id, or an equal id and
a lower slot.  So the walk returns the least (t, id, slot) over the valid
slots of the clusters it enters, and the cluster that holds it is entered
in any order: ``warp_walk`` below is a plain-PyTorch model of exactly that
walk, vectorized over rays; the
tests hold it against ``cluster_ops.cluster_nearest_plain`` (the
sequential walk in ascending order that the kernels are held against), t
and ids bit for bit, with culling on and off, over triangle-cloud tables, a
sphere-and-triangle scene and a tie scene built here: a triangulated grid
(shared edges), a row of spheres, a slot that repeats
another within its cluster, and a new super whose clusters repeat the
first cluster of each kind, so that equal t occur within a cluster and
across clusters and supers.  Its rays run down through the grid's
vertices, edges and diagonals and along the planes of its boxes.  The
prefix scenes of tests/torch_cluster_cases.py fill their clusters to live
counts 1, 3, 4, 5, 64, 127 and 128, put a cluster with no live slot where
its predecessor's rays enter it, and make the last live slot tie an
earlier one; their rays go onto every live slot.  Its row scenes put
walls and spheres in a row whose cluster indices rise toward the rays'
origins, so that the two orders enter different clusters (one of them
with more than 64 supers).  Its face scene puts every nearest hit on the
entry face of its cluster's box, with a copy of equal t and higher id
that the near-to-far walk reaches first: the slab test's inward pad of the
entry distance is what lets the walk still enter the winner's box.

The kernels themselves are held against the plain version on the card
(tests/test_torch_cluster_cuda.py, chip_smoke.py), on these scenes too.
"""

import numpy as np
import pytest
import torch

from rt_tpu_torch import cluster_ops
from rt_tpu_torch.cluster import build_clusters, pack_sphere_slots, pack_triangle_slots
from rt_tpu_torch import scene as tscene
# The kernels' order(t) and their near-to-far visit order of a group of boxes.
from rt_tpu_torch.cluster_ops import (BIG, CLUSTER_SLOTS, LANES, NO_KEY, SUPER_CLUSTERS,
                                      near_order as visit_order, order_key)
from rt_tpu_torch.elementwise import div
from rt_tpu_torch.scene import ClusterData, slot_ids
import torch_cluster_cases as cases  # tests/torch_cluster_cases.py

torch.set_num_threads(2)

T_MIN, T_MAX = 1e-3, 1e9
GRID = 24  # cells a side of the tie scene's grid over [-3, 3]^2: 0.25 apart


# -- the model ------------------------------------------------------------------


def lane_minimum(cand: torch.Tensor, live: int, stats: dict):
    """The warp's winner of one cluster for each ray: ``cand`` [K, 128]
    holds each slot's t (BIG where the slot is not a valid hit), ``live``
    is the cluster's live count.  Lane l takes part only when 4l < live,
    and then keeps its least key over slots 4l + q, q ascending with a
    strict ``<``; the warp takes the least key, then the least slot among
    the lanes that hold it, then that slot's t.  Returns (t, slot, valid)."""
    valid = cand < BIG
    keys = torch.where(valid, order_key(cand), NO_KEY)
    k = cand.shape[0]
    lane = torch.arange(LANES)
    per_lane = CLUSTER_SLOTS // LANES
    part = per_lane * lane < live
    stats["idle_lanes"] = stats.get("idle_lanes", 0) + k * int((~part).sum())
    lane_key = torch.full((k, LANES), NO_KEY, dtype=torch.int64)
    lane_slot = torch.zeros((k, LANES), dtype=torch.int64)
    for q in range(per_lane):
        kq = keys[:, q::per_lane]  # lane l's slot 4l + q
        take = (kq < lane_key) & part
        lane_key = torch.where(take, kq, lane_key)
        lane_slot = torch.where(take, per_lane * lane + q, lane_slot)
    least = lane_key.min(dim=1).values
    slot = torch.where(lane_key == least[:, None], lane_slot, NO_KEY).min(dim=1).values
    found = least != NO_KEY
    stats["slot_ties"] = stats.get("slot_ties", 0) + int(((keys == least[:, None]).sum(dim=1) > 1)[found].sum())
    t = cand.gather(1, torch.where(found, slot, 0)[:, None])[:, 0]
    return t, slot, found


def walk_rays(rays: torch.Tensor) -> dict:
    """The ray components and reciprocals the walk uses, as the plain
    version computes them."""
    ox, oy, oz, dx, dy, dz = rays[:6]
    a = dx * dx + dy * dy + dz * dz
    r = dict(ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz, a=a, inv_a=div(1.0, a))
    tiny = torch.tensor(cluster_ops.TINY, dtype=torch.float32)
    for axis, d in (("idx", dx), ("idy", dy), ("idz", dz)):
        r[axis] = div(1.0, torch.where(torch.abs(d) > tiny, d, tiny))
    return r


def warp_walk(rays, tables, n_sph_slots: int, t_min: float, t_max: float, cull: bool,
              stats: dict | None = None):
    """The warp walk of csrc/cluster_walk.cuh for every ray of ``rays``
    f32[>=6, N] over whole tables (``cluster_ops.cluster_tables``' order):
    (t f32[N], slot id int32[N]).  Per kind, the supers of each group of 64
    (groups in index order) are visited near to far (``visit_order``), then
    each entered super's clusters near to far; a box is entered when its
    entry distance is not above the best t, and the visit stops at the
    first that is.
    ``stats`` counts the boxes the walk enters ("supers_entered",
    "clusters_entered": (ray, box) pairs), the admitted ones it passes over
    ("supers_passed", and "clusters_passed" in the supers it enters), the
    equal-t decisions it makes ("slot_ties": a cluster with two valid slots
    of its least key; "best_ties": a cluster winner equal to the best so
    far) and the lanes that sat out an entered cluster ("idle_lanes").  The
    live counts are the kernels' (``cluster_ops.live_counts``).  The slots'
    primitive ids decide ties of t as the kernel does: read only on a tie,
    the lowest id wins within a cluster, and a winner equal to the best so
    far replaces it only with a lower (id, slot)."""
    stats = {} if stats is None else stats
    for key in ("supers_entered", "clusters_entered", "supers_passed", "clusters_passed"):
        stats.setdefault(key, 0)
    r = walk_rays(rays)
    n = rays.shape[1]
    best_t = torch.full((n,), BIG)
    best_i = torch.full((n,), -1, dtype=torch.int32)
    kinds = ((tables[0:4], 0, "sphere",
              lambda rr, s: cluster_ops._sphere_pairs(rr, s, t_min, t_max)),
             (tables[4:8], n_sph_slots, "triangle",
              lambda rr, s: cluster_ops._triangle_pairs(rr, s, t_min, t_max, cull)))
    for (supers, clusters, slots, prim), id_base, kind, pairs in kinds:
        live = cluster_ops.live_counts(slots, kind).tolist()
        reach = cluster_ops.sphere_reach(slots) if kind == "sphere" else None
        for s0 in range(0, supers.shape[0], 2 * LANES):
            # Two slab tests a lane, ignoring the best.
            tn_s, adm_s = cluster_ops._enters(supers[s0 : s0 + 2 * LANES], r, None, reach)
            order = visit_order(tn_s, adm_s)
            entered = torch.zeros_like(adm_s)
            for k in range(order.shape[1]):
                place = order[:, k : k + 1]
                enter = adm_s.gather(1, place)[:, 0] & (tn_s.gather(1, place)[:, 0] <= best_t)
                if not enter.any():
                    break  # every ray has stopped: the keys left are larger, the best no larger
                entered.scatter_(1, place, enter[:, None])
                for sb in torch.unique(place[enter, 0]).tolist():
                    rows = torch.nonzero(enter & (place[:, 0] == sb))[:, 0]
                    _visit_clusters(r, rows, (s0 + sb) * SUPER_CLUSTERS, clusters, slots, prim,
                                    live, reach, id_base, pairs, best_t, best_i, stats)
            stats["supers_entered"] += int(entered.sum())
            stats["supers_passed"] += int((adm_s & ~entered).sum())
    return best_t, best_i


def _visit_clusters(r, rows, c0: int, clusters, slots, prim, live, reach, id_base: int, pairs,
                    best_t, best_i, stats):
    """The clusters c0.. of one super for the rays ``rows`` that entered it,
    near to far, each entered cluster's winner replacing the best as the
    kernel's walk_cluster decides; ``best_t``/``best_i`` are updated in
    place."""
    sub = {key: v[rows] for key, v in r.items()}
    tn_c, adm_c = cluster_ops._enters(clusters[c0 : c0 + SUPER_CLUSTERS], sub, None, reach)
    order = visit_order(tn_c, adm_c)
    entered = torch.zeros_like(adm_c)
    for j in range(order.shape[1]):
        place = order[:, j : j + 1]
        enter = adm_c.gather(1, place)[:, 0] & (tn_c.gather(1, place)[:, 0] <= best_t[rows])
        if not enter.any():
            break
        entered.scatter_(1, place, enter[:, None])
        for k in torch.unique(place[enter, 0]).tolist():
            ci = c0 + k
            hit = torch.nonzero(enter & (place[:, 0] == k))[:, 0]
            cand = pairs({key: v[hit] for key, v in sub.items()},
                         slots[:, ci * CLUSTER_SLOTS : (ci + 1) * CLUSTER_SLOTS])
            t, slot, found = lane_minimum(cand, live[ci], stats)
            g = rows[hit]
            stats["best_ties"] = stats.get("best_ties", 0) + int((found & (t == best_t[g])).sum())
            slot, wins = _id_winner(cand, slot, t, best_t[g], best_i[g], prim, ci, id_base)
            better = found & ((t < best_t[g]) | wins)
            best_t[g] = torch.where(better, t, best_t[g])
            best_i[g] = torch.where(better, (slot + id_base + ci * CLUSTER_SLOTS).to(torch.int32),
                                    best_i[g])
    stats["clusters_entered"] += int(entered.sum())
    stats["clusters_passed"] += int((adm_c & ~entered).sum())


def _id_winner(cand, slot, t, best_t, best_i, prim, ci: int, id_base: int):
    """The kernel's tie path for rays whose cluster winner ties within the
    cluster or with the best so far: (the slot of the least primitive id
    among the slots at the least key, then the least slot; whether it
    replaces a best of equal t, by a lower id than the best's, which is 0
    where the best is of another kind, or by an equal id and a lower
    slot)."""
    valid = cand < BIG
    keys = torch.where(valid, order_key(cand), NO_KEY)
    at = valid & (keys == order_key(t)[:, None])
    ids = prim[ci * CLUSTER_SLOTS : (ci + 1) * CLUSTER_SLOTS].to(torch.int64)[None]
    rank = torch.where(at, ids, 1 << 40).min(dim=1).values
    first = (at & (ids == rank[:, None])).to(torch.int8).argmax(dim=1)
    tied = (at.sum(dim=1) > 1) | (t == best_t)
    bi = best_i.to(torch.int64) - id_base
    own = (bi >= 0) & (bi < prim.shape[0])
    best_rank = torch.where(own, prim.to(torch.int64)[torch.clamp(bi, 0, prim.shape[0] - 1)], 0)
    slot = torch.where(tied, first, slot)
    lower = (rank < best_rank) | ((rank == best_rank)
                                  & (slot + id_base + ci * CLUSTER_SLOTS < best_i.to(torch.int64)))
    return slot, (t == best_t) & lower


def with_ids(tables, sph_prim, tri_prim) -> tuple:
    """``tables`` (``cluster_ops.cluster_tables``' order) with other
    primitive ids."""
    return (*tables[0:3], sph_prim, *tables[4:7], tri_prim)


def by_slot(tables) -> tuple:
    """``tables`` with their slot ids for primitive ids: the first slot
    visited keeps a tie of t."""
    return with_ids(tables, *slot_ids(tables[2].shape[1], tables[6].shape[1]))


# -- the tie scene ----------------------------------------------------------------


def _repeat_first_cluster(sup, cl, slots, shade, first_col: int):
    """Tables of one kind with a new super appended whose first two
    clusters repeat cluster 0 (slots and shade columns); the rest of the
    super is dummy clusters.  ``shade`` holds this kind's shade columns,
    starting at column ``first_col`` of the slot-ordered table."""
    n = CLUSTER_SLOTS
    new_cl = torch.zeros((SUPER_CLUSTERS, 8))
    new_cl[:, 0:3], new_cl[:, 3:6] = float("inf"), float("-inf")
    new_cl[0:2] = cl[0]
    new_slots = torch.zeros((slots.shape[0], SUPER_CLUSTERS * n))
    new_slots[:, 0:n] = new_slots[:, n : 2 * n] = slots[:, 0:n]
    new_shade = torch.zeros((shade.shape[0], SUPER_CLUSTERS * n))
    new_shade[:, 0:n] = new_shade[:, n : 2 * n] = shade[:, first_col : first_col + n]
    # The new super follows the last one of the tables, whose clusters
    # it must not share: pad the clusters to a whole number of supers.
    pad = sup.shape[0] * SUPER_CLUSTERS - cl.shape[0]
    dummy = torch.zeros((pad, 8))
    dummy[:, 0:3], dummy[:, 3:6] = float("inf"), float("-inf")
    return (torch.cat([sup, cl[0:1]]), torch.cat([cl, dummy, new_cl]),
            torch.cat([slots, torch.zeros((slots.shape[0], pad * n)), new_slots], dim=1),
            torch.cat([torch.zeros((shade.shape[0], pad * n)), new_shade], dim=1))


def tie_grid_scene(grid: int = GRID):
    """A grid of grid x grid cells of two triangles over [-3, 3]^2, its
    vertices at heights 0.5 to 0.75, a row of 16 spheres of radius 0.15
    along y = 0, z = 1.5, and a ground sphere, as the scene builder builds
    it (its slots' primitive ids included)."""
    b = tscene.SceneBuilder()
    b.add_sphere((0, 0, -1000), 1000, b.lambertian(b.solid_color((0.5, 0.5, 0.5))))
    tile = b.lambertian(b.checker(0.5, b.solid_color((0.2, 0.3, 0.4)), b.solid_color((0.9, 0.8, 0.7))))
    ball = b.metal(b.solid_color((0.8, 0.7, 0.6)), fuzz=0.1)
    step = 6.0 / grid

    def vertex(i, j):  # heights 0.5 to 0.75 in exact steps, so boxes are not flat
        return (-3.0 + step * i, -3.0 + step * j, 0.5 + 0.125 * ((i * i + j) % 3))

    for i in range(grid):
        for j in range(grid):
            p00, p10, p01, p11 = vertex(i, j), vertex(i + 1, j), vertex(i, j + 1), vertex(i + 1, j + 1)
            b.add_triangle(p00, p10, p11, tile)
            b.add_triangle(p00, p11, p01, tile)
    for k in range(16):
        b.add_sphere((-3.0 + 0.4 * k, 0.0, 1.5), 0.15, ball)
    return b.build()


def tie_scene(grid: int = GRID):
    """A scene of exact ties for the cluster walk (port only, on the CPU):
    ``tie_grid_scene``; then, in its cluster tables, slot 127 of the first
    cluster of each kind repeats that cluster's slot 0 (its lowest live
    slot), and a new super of each kind repeats the first cluster twice (the
    slots' primitive ids are their slot ids: ties go to the first slot)."""
    scene = tie_grid_scene(grid)
    cl = scene.clusters
    shade = cl.shade_table.clone()
    ns = cl.n_sph_slots
    sph_slots, tri_slots = cl.sph_slots.clone(), cl.tri_slots.clone()
    for slots, col in ((sph_slots, 0), (tri_slots, ns)):
        slots[:, CLUSTER_SLOTS - 1] = slots[:, 0]
        shade[:, col + CLUSTER_SLOTS - 1] = shade[:, col]
    sph = _repeat_first_cluster(cl.sph_super, cl.sph_cluster, sph_slots, shade[:, :ns], 0)
    tri = _repeat_first_cluster(cl.tri_super, cl.tri_cluster, tri_slots, shade[:, ns:], 0)
    sph_shade = torch.cat([shade[:, :ns], sph[3]], dim=1)
    n_sph_slots = sph_shade.shape[1]
    tri_shade = torch.cat([shade[:, ns : ns + cl.tri_slots.shape[1]], tri[3]], dim=1)
    tables = dict(sph_super=sph[0], sph_cluster=sph[1], sph_slots=sph[2], tri_super=tri[0],
                  tri_cluster=tri[1], tri_slots=tri[2])
    sph_prim, tri_prim = slot_ids(n_sph_slots, tri[2].shape[1])
    scene.clusters = ClusterData(
        n_sph_slots=n_sph_slots, sph_prim=sph_prim, tri_prim=tri_prim,
        shade_table=torch.cat([sph_shade, tri_shade], dim=1), **tables)
    return scene


def tie_rays(grid: int = GRID) -> torch.Tensor:
    """Rays f32[8, 2048] at the tie scene: straight down through the grid's
    vertices, edge midpoints and cell diagonals; slanted onto the same
    points; along the plane z = 0.5 (the bottom faces of the grid's boxes)
    and along the x = const planes of its vertex columns; along the sphere
    row; and random rays."""
    step = 6.0 / grid
    pts = []
    for i in range(0, grid, 3):
        for j in range(0, grid, 3):
            x, y = -3.0 + step * i, -3.0 + step * j
            pts += [(x, y), (x + step / 2, y), (x, y + step / 2), (x + step / 2, y + step / 2)]
    pts = np.asarray(pts, np.float32)
    rays = []

    def add(org, dirn):
        r = np.zeros((8, org.shape[0]), np.float32)
        r[0:3], r[3:6] = org.T, np.broadcast_to(dirn, org.shape).T
        rays.append(r)

    down = np.asarray((0.0, 0.0, -1.0), np.float32)
    add(np.c_[pts, np.full(len(pts), 2.0, np.float32)], down)
    slant = np.asarray((0.5, 0.25, -1.0), np.float32)
    add(np.c_[pts, np.full(len(pts), 0.5, np.float32)] - 1.5 * slant, slant)
    lines = np.arange(-3.0, 3.01, step, dtype=np.float32)
    add(np.c_[np.full(len(lines), -4.0), lines, np.full(len(lines), 0.5)].astype(np.float32),
        np.asarray((1.0, 0.0, 0.0), np.float32))
    add(np.c_[lines, np.full(len(lines), -4.0), np.full(len(lines), 1.0)].astype(np.float32),
        np.asarray((0.0, 1.0, -0.25), np.float32))
    row = np.c_[np.linspace(-3.5, 3.5, 64), np.zeros(64), np.full(64, 1.5)].astype(np.float32)
    add(row, np.asarray((1.0, 0.0, 0.0), np.float32))
    add(row, np.asarray((-1.0, 0.0, 0.0), np.float32))
    out = np.concatenate(rays, axis=1)
    rnd = cases.random_rays(np.random.default_rng(11), n=2048 - out.shape[1], extent=4.0)
    return torch.from_numpy(np.concatenate([out, rnd], axis=1))


# -- the tests ------------------------------------------------------------------------


# The row scene with a super a cluster: more than 64 supers of triangles.
ROW_SUPERS = dict(per_super=1, walls=66, spheres=4)


def _scenes():
    scenes = {
        "tri_cloud": lambda: cases.tri_cloud(tscene, n_tris=3000).build(),
        "spheres_and_triangles": lambda: cases.cluster_scene(tscene, np.random.default_rng(4)),
        "ties": tie_scene,
        "rows": cases.row_scene,
        "row_supers": lambda: cases.row_scene(**ROW_SUPERS),
    }
    for case in cases.PREFIX_CASES:
        scenes[case] = lambda case=case: cases.prefix_scene(case)[0]
    return scenes


def _rays(name, cl):
    if name == "ties":
        return tie_rays()
    if name in cases.PREFIX_CASES:
        return cases.prefix_rays(cl)
    if name.startswith("row"):
        return cases.row_rays()
    return torch.from_numpy(cases.random_rays(np.random.default_rng(5), n=1024, extent=4.0))


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("name", ["tri_cloud", "spheres_and_triangles", "ties", "rows",
                                  "row_supers", *cases.PREFIX_CASES])
def test_warp_walk_matches_sequential_walk(name, cull):
    scene = _scenes()[name]()
    cl = scene.clusters
    rays = _rays(name, cl)
    tables = cluster_ops.cluster_tables(cl)
    stats = {}
    got = warp_walk(rays, tables, cl.n_sph_slots, T_MIN, T_MAX, cull, stats)
    ref = cluster_ops.cluster_nearest_plain(rays, *tables, cl.n_sph_slots, T_MIN, T_MAX, cull)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert (ref[1] >= 0).sum() > rays.shape[1] // 8
    if name == "ties":
        # The data holds the ties the proof is about.
        assert stats["slot_ties"] > 10 and stats["best_ties"] > 50, stats
    if name == "last_slot_tie":
        assert stats["slot_ties"] > 10, stats
    if name in cases.PREFIX_CASES and name != "live_128":
        # Lanes past the live counts sat out clusters that rays entered.
        assert stats["idle_lanes"] > 0, stats


def test_visit_order_is_near_to_far():
    """Admitted boxes by entry distance, equal ones by lane (box b is lane
    b % 32's), a lane's first box before its second; boxes not admitted
    last."""
    tn = torch.full((1, 64), 5.0)
    adm = torch.zeros((1, 64), dtype=torch.bool)
    for b, t in ((40, 1.0), (3, 2.0), (35, 2.0), (8, 2.0), (60, 0.0), (61, -0.0), (17, 9.0)):
        tn[0, b], adm[0, b] = t, True
    order = visit_order(tn, adm)[0].tolist()
    assert order[:7] == [60, 61, 40, 3, 35, 8, 17]
    assert sorted(order[7:]) == [b for b in range(64) if b not in (40, 3, 35, 8, 60, 61, 17)]


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("layout", ["rows", "row_supers"])
def test_near_order_enters_fewer_clusters(layout, cull):
    """On a row scene the rays that come down the row of walls from +x
    meet the walls' clusters in falling index.  The near-to-far walk enters
    the nearest wall's cluster and stops (and again in the second group of
    64 supers where each wall is a super), passing over the rest; the
    ascending walk enters every one.  Both return the same t and id, on
    these rays and on all of the scene's."""
    scene = _scenes()[layout]()
    cl = scene.clusters
    tables = cluster_ops.cluster_tables(cl)
    rays = cases.row_rays()
    walls = ROW_SUPERS["walls"] if layout == "row_supers" else cases.ROW_WALLS
    groups = 2 if layout == "row_supers" else 1  # groups of 64 supers the walls span
    q = rays.shape[1] // 4
    for batch in (rays, rays[:, :q]):  # every ray, then those down the row of walls
        stats, work = {}, {}
        got = warp_walk(batch, tables, cl.n_sph_slots, T_MIN, T_MAX, cull, stats)
        ref = cluster_ops.cluster_nearest_plain(batch, *tables, cl.n_sph_slots, T_MIN, T_MAX, cull,
                                                work=work)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
        ascending = sum(work[f"{k}_row_bytes_whole"] / cluster_ops.row_bytes(0, k)[1]
                        for k in ("sphere", "triangle"))
        assert stats["clusters_entered"] < ascending
    assert bool((got[1] >= cl.n_sph_slots).all())
    assert ascending == q * walls
    assert stats["clusters_entered"] == groups * q and stats["supers_entered"] == groups * q
    passed = ("supers_passed" if layout == "row_supers" else "clusters_passed")
    assert stats[passed] == (walls - groups) * q


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("copy", [20, 48])
def test_equal_t_and_id_go_to_the_lower_slot(copy, cull):
    """On the row scene, the nearest wall's cluster (47: lane 15's second
    box) repeated in cluster ``copy`` with its slots' primitive ids: the
    rays down the row meet both at the same t and id.  The near-to-far walk
    visits the copy second (lane 20's or lane 16's first box): at 20, below
    47, it must replace the best; at 48 it must not.  Either way the lower
    slot wins, as in the ascending walk."""
    cl = cases.row_scene().clusters
    tables = cases.copy_nearest_wall(cluster_ops.cluster_tables(cl), copy)
    rays = cases.row_rays()[:, : 2048 // 4]
    stats = {}
    got = warp_walk(rays, tables, cl.n_sph_slots, T_MIN, T_MAX, cull, stats)
    ref = cluster_ops.cluster_nearest_plain(rays, *tables, cl.n_sph_slots, T_MIN, T_MAX, cull)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    low = cl.n_sph_slots + min(copy, cases.ROW_WALLS - 1) * CLUSTER_SLOTS
    assert bool(((got[1] >= low) & (got[1] < low + CLUSTER_SLOTS)).all())
    assert stats["best_ties"] == rays.shape[1]


@pytest.mark.parametrize("name", ["rows", "row_supers", "ties", "spheres_and_triangles"])
def test_order_counts_replay_the_near_walk(name):
    """walk_counts_cuda.order_counts replays the walk from the rays' slab
    tests and each admitted cluster's least t: in the near-to-far order it
    enters the supers and clusters the model enters, fewer clusters than
    the plain walk enters in ascending order (``ascending_counts``, from
    the plain walk's counters, which agree with its slot-row bytes)."""
    from walk_counts_cuda import ascending_counts, order_counts

    cl = _scenes()[name]().clusters
    rays = _rays(name, cl)
    tables = cluster_ops.cluster_tables(cl)
    stats, work = {}, {}
    warp_walk(rays, tables, cl.n_sph_slots, T_MIN, T_MAX, True, stats)
    cluster_ops.cluster_nearest_plain(rays, *tables, cl.n_sph_slots, T_MIN, T_MAX, True, work=work)
    got = order_counts(rays, tables, cl.n_sph_slots, T_MIN, T_MAX, True)
    ascending = ascending_counts(work)
    kinds = ("sphere", "triangle")
    assert ascending["clusters"] == sum(
        work[f"{k}_row_bytes_whole"] // cluster_ops.row_bytes(0, k)[1] for k in kinds)
    assert ascending["supers"] >= got["near"]["supers"] > 0
    assert got["near"]["clusters"] == stats["clusters_entered"]
    assert got["near"]["supers"] == stats["supers_entered"]
    assert got["near"]["clusters"] < ascending["clusters"]
    assert got["near"]["live_slots"] < ascending["live_slots"]


@pytest.mark.parametrize("cull", [True, False])
def test_entry_face_hits_go_to_the_lower_id(cull, monkeypatch):
    """On the face scene every ray's nearest hit lies on the entry face of
    two flat cluster boxes, FACE_LOW's and its copy FACE_HIGH's (higher
    ids), and the near-to-far walk enters the copy first.  With the entry
    distance padded inward the walk still enters FACE_LOW's box and returns
    its slot, as the ascending walk does; with the entry distance left
    as the slab test computes it, rounding puts it past the hit's t on
    some rays, and the walk stops before FACE_LOW's box."""
    cl = cases.face_scene().clusters
    tables = cluster_ops.cluster_tables(cl)
    rays = cases.face_rays()
    n = rays.shape[1]
    low = cl.n_sph_slots + cases.FACE_LOW * CLUSTER_SLOTS
    stats = {}
    got = warp_walk(rays, tables, cl.n_sph_slots, T_MIN, T_MAX, cull, stats)
    ref = cluster_ops.cluster_nearest_plain(rays, *tables, cl.n_sph_slots, T_MIN, T_MAX, cull)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert bool(((got[1] >= low) & (got[1] < low + CLUSTER_SLOTS)).all())
    assert stats["clusters_entered"] == 2 * n and stats["best_ties"] == n
    monkeypatch.setattr(cluster_ops, "ENTRY_MUL", 1.0)
    monkeypatch.setattr(cluster_ops, "PAD_ADD", 0.0)
    bare = warp_walk(rays, tables, cl.n_sph_slots, T_MIN, T_MAX, cull)
    assert torch.equal(bare[0], ref[0])
    assert int((bare[1] >= low + CLUSTER_SLOTS).sum()) > n // 20


def _reversed_ids(cl):
    """Slot primitive ids per kind that fall as slots rise (spheres below
    triangles): ties then go to the last slot visited, not the first."""
    ns, nt = cl.sph_slots.shape[1], cl.tri_slots.shape[1]
    return (torch.arange(ns - 1, -1, -1, dtype=torch.int32),
            torch.arange(ns + nt - 1, ns - 1, -1, dtype=torch.int32))


@pytest.mark.parametrize("cull", [True, False])
@pytest.mark.parametrize("name", ["ties", "grid"])
def test_warp_walk_breaks_ties_by_primitive_id(name, cull):
    """The warp walk and the sequential walk agree bit for bit on the tie
    scene with primitive ids that reverse the slot order (so that every tie
    the first slot keeps goes elsewhere) and on the grid scene with its own
    ids; t is that of the slot-id walk."""
    scene = tie_scene() if name == "ties" else tie_grid_scene()
    cl = scene.clusters
    rays = tie_rays()
    tables = cluster_ops.cluster_tables(cl)
    if name == "ties":
        tables = with_ids(tables, *_reversed_ids(cl))
    stats = {}
    got = warp_walk(rays, tables, cl.n_sph_slots, T_MIN, T_MAX, cull, stats)
    ref = cluster_ops.cluster_nearest_plain(rays, *tables, cl.n_sph_slots, T_MIN, T_MAX, cull)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    first = cluster_ops.cluster_nearest_plain(rays, *by_slot(tables), cl.n_sph_slots, T_MIN,
                                              T_MAX, cull)
    assert torch.equal(ref[0], first[0])
    if name == "ties":
        assert (ref[1] != first[1]).sum() > 50 and stats["best_ties"] > 50, stats


def test_walk_breaks_ties_as_brute_force():
    """On the grid scene, rays through its shared vertices tie between
    triangles: with its slots' primitive ids the cluster walk returns the t
    and the primitive of a brute-force search over every primitive in id
    order (K1's, the reference's), where the first slot would have won
    another.  Rays parallel to an axis are left out: one that runs in the
    plane of a box's face meets the slab test's edge case (a zero direction
    component with the origin on the face), in which the box is not
    admitted."""
    from rt_tpu_torch import megakernel
    from rt_tpu_torch.config import RenderConfig

    scene = tie_grid_scene()
    cl, cfg = scene.clusters, RenderConfig()
    rays = tie_rays()
    rays = rays[:, (rays[3:6] != 0).all(dim=0)]
    t_flat, id_flat = megakernel.flat_search(scene, cfg, rays)
    t_walk, slot = megakernel.cluster_search(scene, cfg, rays)
    ids = torch.cat([cl.sph_prim, cl.tri_prim]).to(torch.int64)
    walk_ids = torch.where(slot >= 0, ids[torch.clamp(slot, min=0).to(torch.int64)], -1)
    assert torch.equal(t_walk, t_flat) and torch.equal(walk_ids, id_flat.to(torch.int64))
    _, first = cluster_ops.cluster_nearest_plain(rays, *by_slot(cluster_ops.cluster_tables(cl)),
                                                 cl.n_sph_slots, cfg.t_min, cfg.t_max)
    first_ids = torch.where(first >= 0, ids[torch.clamp(first, min=0).to(torch.int64)], -1)
    assert (first_ids != walk_ids).sum() > 10


@pytest.mark.parametrize("name", list(cases.PREFIX_CASES))
def test_prefix_scene_last_live_slots_win(name):
    """On a prefix scene the ray straight down onto each cluster's last
    live slot is won by that slot, unless the slot repeats an earlier one,
    which then wins: so a walk that left out a live lane, or the live part
    of the last one, would not match."""
    scene, lasts = cases.prefix_scene(name)
    cl = scene.clusters
    rays = cases.prefix_rays(cl)
    for cull in (True, False):
        _, slot = cluster_ops.cluster_nearest_plain(rays, *cluster_ops.cluster_tables(cl),
                                                    cl.n_sph_slots, T_MIN, T_MAX, cull)
        won = set(slot.tolist())
        for kind, base in (("sphere", 0), ("triangle", cl.n_sph_slots)):
            for ci, last, source in lasts[kind]:
                if source is None:
                    assert last in won, (kind, ci, last)
                else:
                    assert last not in won and base + ci * CLUSTER_SLOTS + source in won


def test_live_counts_and_row_bytes():
    """The live counts of a table whose clusters hold live slots at their
    front, with gaps, and none; they follow an in-place change of it."""
    slots = torch.zeros((16, 4 * CLUSTER_SLOTS))
    slots[9, 0:5] = 1.0  # slots 0-4
    slots[9, CLUSTER_SLOTS + 3] = slots[9, CLUSTER_SLOTS + 126] = 1.0  # slots 3 and 126
    slots[9, 3 * CLUSTER_SLOTS :] = 1.0  # all 128
    assert cluster_ops.live_counts(slots, "triangle").tolist() == [5, 127, 0, 128]
    assert cluster_ops.live_counts(slots, "triangle").dtype == torch.int32
    slots[9, 2 * CLUSTER_SLOTS] = 1.0
    assert cluster_ops.live_counts(slots, "triangle").tolist() == [5, 127, 1, 128]
    spheres = torch.zeros((8, CLUSTER_SLOTS))
    spheres[3, 0:64] = 0.5  # radii
    assert cluster_ops.live_counts(spheres, "sphere").tolist() == [64]
    assert cluster_ops.row_bytes(5, "triangle") == (2 * 10 * 16, 32 * 10 * 16)
    assert cluster_ops.row_bytes(3, "sphere") == (4 * 16, 32 * 4 * 16)
    assert cluster_ops.row_bytes(128, "triangle") == (5120, 5120)
    assert cluster_ops.row_bytes(0, "sphere") == (0, 2048)


def test_walk_counts_row_bytes_of_a_two_cluster_scene():
    """The plain walk's slot-row bytes on a scene of one sphere cluster (3
    live slots: one lane of 4 rows) and one triangle cluster (5 live slots:
    two lanes of 10 rows), worked out by hand: 16 bytes a row a lane."""
    centers = np.asarray([(-5.0 + k, 0.0, 0.5) for k in range(3)], np.float32)
    radius = np.full(3, 0.3, np.float32)
    _, sph, sph_cl, sph_sup = build_clusters(centers - 0.3, centers + 0.3)
    x = np.arange(4.0, 9.0, dtype=np.float32)[:, None]
    a = np.c_[x, np.full_like(x, -0.4), np.full_like(x, 0.5)]
    b, c = a + np.float32([0.8, 0.0, 0.0]), a + np.float32([0.4, 0.8, 0.0])
    _, tri, tri_cl, tri_sup = build_clusters(np.minimum(np.minimum(a, b), c),
                                             np.maximum(np.maximum(a, b), c))
    raw = [torch.from_numpy(t) for t in (sph_sup, sph_cl, pack_sphere_slots(sph, centers, radius),
                                         tri_sup, tri_cl, pack_triangle_slots(tri, a, b, c))]
    tables = by_slot((*raw[0:3], None, *raw[3:6], None))
    n_sph_slots = tables[2].shape[1]
    assert cluster_ops.live_counts(tables[2], "sphere").tolist() == [3] + [0] * 63
    assert cluster_ops.live_counts(tables[6], "triangle").tolist() == [5] + [0] * 63
    # Straight down onto each sphere (3 rays), each triangle (5), and one
    # ray that meets no box.
    xs = [-5.0, -4.0, -3.0, 4.4, 5.4, 6.4, 7.4, 8.4, 0.0]
    rays = torch.zeros((8, len(xs)))
    rays[0] = torch.tensor(xs)
    rays[2], rays[5] = 3.0, -1.0
    work = {}
    t, slot = cluster_ops.cluster_nearest_plain(rays, *tables, n_sph_slots, T_MIN, T_MAX, True,
                                                work=work)
    assert (slot[:8] >= 0).all() and slot[8] == -1
    assert work["sphere_row_bytes"] == 3 * (1 * 4 * 16)
    assert work["sphere_row_bytes_whole"] == 3 * (32 * 4 * 16)
    assert work["triangle_row_bytes"] == 5 * (2 * 10 * 16)
    assert work["triangle_row_bytes_whole"] == 5 * (32 * 10 * 16)
    assert work["sphere_pairs"] == 3 * 3 and work["triangle_pairs"] == 5 * 5


def test_tie_scene_winners_are_the_first_copies():
    """On the tie scene the first copy wins every tie: no ray's winner is
    slot 127 of a first cluster or a slot of an appended super."""
    scene = tie_scene()
    cl = scene.clusters
    rays = tie_rays()
    t, slot = cluster_ops.cluster_nearest_plain(rays, *cluster_ops.cluster_tables(cl),
                                                cl.n_sph_slots, T_MIN, T_MAX, True)
    ns = cl.n_sph_slots
    copies = [ns - SUPER_CLUSTERS * CLUSTER_SLOTS, cl.shade_table.shape[1] - SUPER_CLUSTERS * CLUSTER_SLOTS]
    won = slot[slot >= 0].to(torch.int64)
    assert not ((won == CLUSTER_SLOTS - 1) | (won == ns + CLUSTER_SLOTS - 1)).any()
    assert not (((won >= copies[0]) & (won < ns)) | (won >= copies[1])).any()
    assert (won < CLUSTER_SLOTS).any() and ((won >= ns) & (won < ns + CLUSTER_SLOTS)).any()


def test_negative_t_min_orders_negative_keys():
    """With t_min below 0 a sphere behind the origin is a valid hit, so
    winners' keys are negative floats: the key's flip orders them."""
    scene = tie_scene()
    cl = scene.clusters
    rays = tie_rays()
    tables = cluster_ops.cluster_tables(cl)
    got = warp_walk(rays, tables, cl.n_sph_slots, -1.0, T_MAX, True)
    ref = cluster_ops.cluster_nearest_plain(rays, *tables, cl.n_sph_slots, -1.0, T_MAX, True)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    assert (ref[0] < 0).sum() > 10


def test_order_key_orders_like_the_float():
    vals = torch.tensor([-3e38, -1.0, -1e-30, -0.0, 0.0, 1e-30, 1e-3, 1.0, 2.5, 3e38])
    keys = order_key(vals)
    assert bool((keys[1:] >= keys[:-1]).all()) and keys[3] == keys[4]
    assert bool((keys[:3] < keys[3]).all()) and bool((keys[5:] > keys[4]).all())
    assert int(keys.max()) < NO_KEY


# -- far grazing rays ---------------------------------------------------------------


# Bands of distance from a ray's origin to the sphere it grazes, with how
# far above the sphere the rays pass: the second is the largest distance
# that a configuration's sphere walk meets (main_default_scene: the
# lattice's spheres, radius 0.2 (its least), over [-300, 300]^2, so at most
# ~850 apart), where the rounding reaches furthest.
FAR_BANDS = {"far": ((150.0, 300.0), 0.06), "farthest": ((800.0, 900.0), 0.4)}


def _far_field(band: str = "far"):
    """A field of 3,000 spheres of radius 0.2 on z = 0 over [-300, 300]^2
    (cluster tables, no BVH) and 2,048 rays each aimed to pass just above
    one of them from ``FAR_BANDS[band]``'s distances, nearly level: where
    the float32 discriminant of such a ray cancels to >= 0, a brute-force
    search takes a hit outside the sphere's box."""
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.scene import SceneBuilder

    g = np.random.default_rng(11)
    centers = np.c_[g.uniform(-300, 300, (3000, 2)), np.zeros(3000)]
    b = SceneBuilder()
    mat = b.lambertian_rgb(0.5, 0.5, 0.5)
    for c in centers:
        b.add_sphere(c, 0.2, mat)
    scene = b.build(use_bvh=False)
    aim = centers[g.integers(0, 3000, 2048)]
    heading = g.uniform(0, 2 * np.pi, 2048)
    level = np.c_[np.cos(heading), np.sin(heading), np.zeros(2048)]
    side = np.c_[-np.sin(heading), np.cos(heading), np.zeros(2048)]
    (near, far), above = FAR_BANDS[band]
    lift = 0.2 + g.uniform(0.0, above, 2048)
    tilt = g.uniform(-2e-3, 2e-3, 2048)
    dirs = level + tilt[:, None] * np.float64([0, 0, 1])
    up = np.cross(side, dirs)
    up /= np.linalg.norm(up, axis=1, keepdims=True)
    dist = g.uniform(near, far, 2048)
    origins = aim + lift[:, None] * up - dist[:, None] * dirs
    rays = np.c_[origins, dirs * g.uniform(0.5, 6.0, (2048, 1))].T
    rays = torch.from_numpy(rays.astype(np.float32))
    return scene, RenderConfig(), rays


@pytest.mark.parametrize("band", list(FAR_BANDS))
def test_walk_finds_the_brute_force_hits_of_far_grazing_rays(band, monkeypatch):
    """The walk widens sphere boxes by the reach of the sphere test's
    rounding (``cluster_ops.SPHERE_REACH``), so that it returns the t of a
    brute-force search over every sphere (K1's, the reference's) on rays
    whose rounding takes hits outside a sphere's box, out to the largest
    distance a configuration meets; unwidened, it misses some of them."""
    from rt_tpu_torch import megakernel

    scene, cfg, rays = _far_field(band)
    assert scene.clusters is not None
    t_flat, _ = megakernel.flat_search(scene, cfg, rays)
    t_walk, _ = megakernel.cluster_search(scene, cfg, rays)
    assert (t_flat < BIG).sum() > 100
    assert torch.equal(t_walk, t_flat)
    monkeypatch.setattr(cluster_ops, "SPHERE_REACH", 0.0)
    t_bare, _ = megakernel.cluster_search(scene, cfg, rays)
    assert (t_bare != t_flat).sum() > 10
