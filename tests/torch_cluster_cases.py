"""Shared by the port's tests of clustered scenes: the scenes of
tests/test_megakernel_cluster.py and tests/test_cluster.py, built with
either package's SceneBuilder from the same seeds, a table-by-table
comparison of a port scene with a JAX package scene (every table, the
whole cluster tables, the BVH arrays and the sky equal bit for bit), and
the JAX package's cluster pages cut from a port scene's whole tables."""

import time

import numpy as np

from rt_tpu_torch.scene import BVH_TABLES, CLUSTER_TABLES, TABLES

# The walk's tables in the order cluster_ops.cluster_tables gives them, and
# those of them that the JAX package's cluster pages hold too.
WALK_TABLES = ("sph_super", "sph_cluster", "sph_slots", "sph_prim", "tri_super", "tri_cluster",
               "tri_slots", "tri_prim")
PAGE_TABLES = tuple(name for name in WALK_TABLES if not name.endswith("_prim"))


def load_jax_native(seconds: float = 120.0) -> bool:
    """Load the JAX package's native BVH builder, which its cluster tables
    need.  Its loader builds the library in place on first use and, if a
    load fails while another test process is still writing the file,
    falls back to the NumPy builder for the rest of the process; retry
    until the file is complete."""
    from rt_tpu.bvh import native as jnative

    deadline = time.monotonic() + seconds
    while not jnative.available():
        if time.monotonic() > deadline:
            return False
        time.sleep(1.0)
        jnative._load_failed = False
    return True


def assert_same_tables(got, ref, names, where=""):
    for name in names:
        r = getattr(ref, name)
        g = getattr(got, name)
        if r is None:
            assert g is None, where + name
            continue
        r = np.asarray(r)
        assert g.numpy().dtype == r.dtype, where + name
        np.testing.assert_array_equal(g.numpy(), r, err_msg=where + name)


def assert_same_clusters(got, ref):
    assert (got is None) == (ref is None)
    if ref is None:
        return
    assert_same_tables(got, ref, CLUSTER_TABLES, "clusters.")
    assert got.n_sph_slots == ref.n_sph_slots


def cluster_pages(cl, size: int = 512):
    """The JAX package's pages of a port ClusterData's whole tables
    (rt_tpu/scene.py:617-676): per kind, slices of at most ``size``
    clusters with their supers beside the other kind's empty dummy tables,
    sphere pages first; or one page of the whole tables where neither kind
    needs more than one.  Returns [(tables, sph_slot_base, tri_slot_base)]
    a page, the tables contiguous on the clusters' device in
    ``WALK_TABLES`` order, as K4 takes them with the page's slot bases (a
    page's primitive ids are its slots' ids in the whole tables; the dummy
    tables' are a dead slot's)."""
    import torch

    from rt_tpu_torch import cluster_ops

    whole = cluster_ops.cluster_tables(cl)
    spans = [[(lo, min(lo + size, table.shape[0])) for lo in range(0, table.shape[0], size)]
             for table in (cl.sph_cluster, cl.tri_cluster)]
    if all(len(kind) <= 1 for kind in spans):
        return [(whole, 0, 0)]
    dev = cl.sph_cluster.device
    inf = float("inf")
    empty_box = torch.tensor([inf, inf, inf, -inf, -inf, -inf, 0.0, 0.0], device=dev)
    no_super, no_clusters = empty_box.repeat(1, 1), empty_box.repeat(64, 1)
    no_sph, no_tri = (torch.zeros((rows, 64 * 128), device=dev) for rows in (8, 16))
    no_prim = torch.full((64 * 128,), 2**31 - 1, dtype=torch.int32, device=dev)

    def cut(sup, clusters, slots, prim, lo, hi):
        return (sup[lo // 64 : -(-hi // 64)].contiguous(), clusters[lo:hi].contiguous(),
                slots[:, lo * 128 : hi * 128].contiguous(), prim[lo * 128 : hi * 128].contiguous())

    return ([((*cut(*whole[0:4], lo, hi), no_super, no_clusters, no_tri, no_prim), lo * 128, 0)
             for lo, hi in spans[0]]
            + [((no_super, no_clusters, no_sph, no_prim, *cut(*whole[4:8], lo, hi)), 0, lo * 128)
               for lo, hi in spans[1]])


def assert_same_scene(got, ref):
    assert_same_tables(got, ref, TABLES)
    assert (got.num_spheres, got.num_triangles, got.has_image_textures) == (
        ref.num_spheres, ref.num_triangles, ref.has_image_textures)
    for name in ("sun_direction", "turbidity", "exposure"):
        np.testing.assert_array_equal(getattr(got.sky, name).numpy(),
                                      np.asarray(getattr(ref.sky, name)))
    assert (got.sky.hw_params is None) == (ref.sky.hw_params is None)
    assert got.sky.cos_gamma_as_angle == ref.sky.cos_gamma_as_angle
    assert_same_clusters(got.clusters, ref.clusters)
    assert (got.bvh is None) == (ref.bvh is None)
    if ref.bvh is not None:
        assert_same_tables(got.bvh, ref.bvh, BVH_TABLES, "bvh.")


def tri_cloud(mod, n_tris=150, with_materials=True, seed=0, checker=True):
    """test_megakernel_cluster.py's ``_tri_cloud_scene``; ``mod`` is
    ``rt_tpu.scene`` or ``rt_tpu_torch.scene``.  Without ``checker`` the
    checker material is a solid lambertian and the metal has no fuzz."""
    rng = np.random.default_rng(seed)
    b = mod.SceneBuilder()
    g = b.lambertian(b.solid_color((0.5, 0.5, 0.5)))
    b.add_sphere((0, 0, -1000), 1000, g)
    mats = [b.metal(b.solid_color((0.8, 0.7, 0.6)), fuzz=0.1 if checker else None)]
    if with_materials:
        mats += [
            b.lambertian(b.checker(0.5, b.solid_color((0.1, 0.2, 0.3)),
                                   b.solid_color((0.9, 0.9, 0.8))))
            if checker else b.lambertian_rgb(0.3, 0.6, 0.9),
            b.dielectric(1.5),
            b.emissive((2.0, 1.5, 1.0)),
        ]
    for i in range(n_tris):
        c = rng.uniform(-3, 3, 3)
        c[2] = rng.uniform(0.2, 2.0)
        d1 = rng.uniform(-0.3, 0.3, 3)
        d2 = rng.uniform(-0.3, 0.3, 3)
        b.add_triangle(tuple(c), tuple(c + d1), tuple(c + d2), mats[i % len(mats)])
    b.add_sphere((0, 0, 1), 1, b.lambertian(b.solid_color((0.8, 0.2, 0.1))))
    return b


def spheres_2100(mod):
    """test_megakernel_cluster.py's sphere-heavy scene: 2100 small spheres
    on a ground sphere."""
    rng = np.random.default_rng(1)
    b = mod.SceneBuilder()
    g = b.lambertian(b.solid_color((0.5, 0.5, 0.5)))
    b.add_sphere((0, 0, -1000), 1000, g)
    for _ in range(2100):
        c = rng.uniform(-8, 8, 3)
        c[2] = rng.uniform(0.1, 1.5)
        b.add_sphere(tuple(c), 0.08, g)
    return b


def image_tris(mod):
    """test_megakernel_cluster.py's 140 image-textured triangles (the
    24-row triangle slot table)."""
    rng = np.random.default_rng(7)
    b = mod.SceneBuilder()
    b.add_sphere((0, 0, -1000), 1000, b.lambertian(b.solid_color((0.5, 0.5, 0.5))))
    img = rng.uniform(0.1, 1.0, (16, 16, 3)).astype(np.float32)
    mat = b.metal(b.image_texture(img), fuzz=0.05)
    for _ in range(140):
        c = rng.uniform(-3, 3, 3)
        c[2] = rng.uniform(0.2, 2.0)
        d1 = rng.uniform(-0.4, 0.4, 3)
        d2 = rng.uniform(-0.4, 0.4, 3)
        uv = rng.uniform(0, 1, (3, 2))
        b.add_triangle(tuple(c), tuple(c + d1), tuple(c + d2), mat,
                       uv_a=tuple(uv[0]), uv_b=tuple(uv[1]), uv_c=tuple(uv[2]))
    return b


def spheres_16500(mod):
    """test_cluster.py's paged scene: 16,500 spheres (with pages of 64
    clusters, three sphere pages)."""
    rng = np.random.default_rng(1234)
    b = mod.SceneBuilder()
    m = b.lambertian_rgb(0.6, 0.5, 0.4)
    for c, r in zip(rng.uniform(-40, 40, (16500, 3)), rng.uniform(0.2, 0.5, 16500)):
        b.add_sphere(c, r, m)
    return b


def cluster_scene(mod, rng, n_sph=300, n_tri=200):
    """test_cluster.py's ``_cluster_scene``: random spheres and triangles,
    no BVH."""
    b = mod.SceneBuilder()
    for _ in range(n_sph):
        m = b.lambertian_rgb(*rng.uniform(0.2, 0.9, 3))
        b.add_sphere(rng.uniform(-8, 8, 3), rng.uniform(0.2, 0.8), m)
    mt = b.metal_solid((0.8, 0.7, 0.6), 0.1)
    for _ in range(n_tri):
        base = rng.uniform(-8, 8, 3)
        b.add_triangle(base, base + rng.normal(size=3), base + rng.normal(size=3), mt)
    return b.build(use_bvh=False)


def random_rays(rng, n=256, extent=10.0):
    """test_cluster.py's rays in the kernel layout f32[8, n]."""
    rays = np.zeros((8, n), np.float32)
    rays[0:3] = rng.uniform(-extent, extent, (3, n))
    rays[3:6] = rng.normal(size=(3, n))
    return rays


# Cluster fills for the warp walk's live counts (csrc/cluster_walk.cuh: lane
# l loads and tests slots 4l..4l+3 of an entered cluster only when 4l is
# below the cluster's last live slot + 1).  Each case is a pattern of
# (live count, source) that ``prefix_scene`` repeats over a scene's
# primitives: one slot, part of a lane, one lane, a lane and a slot, half
# the lanes, all but the last slot, all of them; a count 0 is a cluster with
# a live box (its predecessor's) and no live slot; a source s makes the
# last live slot a copy of slot s, so that the two tie.
PREFIX_CASES = {
    "live_1": ((1, None),),
    "live_3": ((3, None),),
    "live_4": ((4, None),),
    "live_5": ((5, None),),
    "live_64": ((64, None),),
    "live_127": ((127, None),),
    "live_128": ((128, None),),
    "all_dead": ((5, None), (0, None), (127, None)),
    "last_slot_tie": ((5, 1), (127, 2), (128, 0)),
}


def _regroup(slots, shade, alive, pattern, kind: str):
    """One kind's live slot columns, in slot order, regrouped into clusters
    filled as ``pattern`` says -> (supers, clusters, slots, shade columns,
    [(cluster, last live slot, source)])."""
    cols = alive.nonzero()[:, 0]
    groups, k, at = [], 0, 0
    while at < cols.numel():
        count, source = pattern[k % len(pattern)]
        k += 1
        want = count - (source is not None)
        take = min(want, cols.numel() - at)
        if take < want:
            source = None  # the last cluster takes what is left, with no copy
        groups.append((cols[at : at + take], source))
        at += take
    return _pack_groups(slots, shade, groups, range(len(groups)), kind)


def _pack_groups(slots, shade, groups, places, kind: str, pad: float = 1e-3):
    """One kind's tables with group k of ``groups`` [(slot columns, source)]
    in cluster ``places[k]`` (the clusters between them dummies) ->
    (supers, clusters, slots, shade columns, [(cluster, last live slot,
    source)]).  A source s makes the group's last live slot a copy of its
    slot s; a group of no column takes its predecessor's box.  Each box is
    its primitives' bounds grown by ``pad`` on every side."""
    import torch

    n = 128
    places = list(places)
    m = -(-(max(places) + 1) // 64) * 64
    new_slots = torch.zeros((slots.shape[0], m * n))
    new_shade = torch.zeros((shade.shape[0], m * n))
    boxes = torch.zeros((m, 8))
    boxes[:, 0:3], boxes[:, 3:6] = float("inf"), float("-inf")
    last = []
    for ci, (g, source) in zip(places, groups):
        base = ci * n
        new_slots[:, base : base + g.numel()] = slots[:, g]
        new_shade[:, base : base + g.numel()] = shade[:, g]
        live = g.numel()
        if source is not None:
            new_slots[:, base + live] = new_slots[:, base + source]
            new_shade[:, base + live] = new_shade[:, base + source]
            live += 1
        if live == 0:  # a cluster with no live slot, entered where its predecessor is
            boxes[ci] = boxes[ci - 1]
            continue
        s = new_slots[:, base : base + live]
        if kind == "sphere":
            lo, hi = s[0:3] - s[3], s[0:3] + s[3]
        else:
            verts = torch.stack([s[0:3], s[0:3] + s[3:6], s[0:3] + s[6:9]])
            lo, hi = verts.amin(dim=0), verts.amax(dim=0)
        boxes[ci, 0:3], boxes[ci, 3:6] = lo.amin(dim=1) - pad, hi.amax(dim=1) + pad
        last.append((ci, base + live - 1, source))
    supers = torch.zeros((m // 64, 8))
    supers[:, 0:3], supers[:, 3:6] = float("inf"), float("-inf")
    for si in range(m // 64):
        block = boxes[si * 64 : (si + 1) * 64]
        block = block[block[:, 0] <= block[:, 3]]
        if block.shape[0]:
            supers[si, 0:3], supers[si, 3:6] = block[:, 0:3].amin(dim=0), block[:, 3:6].amax(dim=0)
    return supers, boxes, new_slots, new_shade, last


def _with_tables(scene, sph, tri):
    """``scene`` with cluster tables made of ``_pack_groups``' results for
    each kind, the slots' primitive ids their slot ids."""
    import torch

    from rt_tpu_torch.scene import ClusterData, slot_ids

    n_sph_slots = sph[2].shape[1]
    sph_prim, tri_prim = slot_ids(n_sph_slots, tri[2].shape[1])
    scene.clusters = ClusterData(
        n_sph_slots=n_sph_slots, sph_prim=sph_prim, tri_prim=tri_prim,
        shade_table=torch.cat([sph[3], tri[3]], dim=1), sph_super=sph[0], sph_cluster=sph[1],
        sph_slots=sph[2], tri_super=tri[0], tri_cluster=tri[1], tri_slots=tri[2])
    return scene


def prefix_scene(case: str, grid: int = 12):
    """A scene (port only) whose cluster tables are filled as
    ``PREFIX_CASES[case]`` says: a grid x grid height field of triangles
    over [-3, 3]^2 (heights 0.5 to 0.75, facing up) and a grid x grid
    field of spheres of radius 0.12 at z 0.6 over [4, 9.5] x [-3, 3], so
    that a ray straight down onto a primitive hits it first.  Returns
    (scene, {kind: [(cluster, last live slot id, source)]}), the slot ids
    global as the kernels return them.  The slots' primitive ids are their
    slot ids (``scene.slot_ids``): a slot that repeats an earlier one loses
    the tie."""
    from rt_tpu_torch import cluster_ops
    from rt_tpu_torch.scene import SceneBuilder

    b = SceneBuilder()
    tile = b.lambertian(b.checker(0.5, b.solid_color((0.2, 0.3, 0.4)),
                                  b.solid_color((0.9, 0.8, 0.7))))
    ball = b.lambertian_rgb(0.8, 0.5, 0.3)
    step = 6.0 / grid

    def vertex(i, j):
        return (-3.0 + step * i, -3.0 + step * j, 0.5 + 0.125 * ((i * i + j) % 3))

    for i in range(grid):
        for j in range(grid):
            b.add_triangle(vertex(i, j), vertex(i + 1, j), vertex(i + 1, j + 1), tile)
            b.add_triangle(vertex(i, j), vertex(i + 1, j + 1), vertex(i, j + 1), tile)
            b.add_sphere((4.0 + 5.5 * i / (grid - 1), -3.0 + 6.0 * j / (grid - 1), 0.6), 0.12, ball)
    scene = b.build()
    cl = scene.clusters
    ns = cl.n_sph_slots
    pattern = PREFIX_CASES[case]
    out, lasts = {}, {}
    for kind, slots, shade in (("sphere", cl.sph_slots, cl.shade_table[:, :ns]),
                               ("triangle", cl.tri_slots, cl.shade_table[:, ns:])):
        alive = slots[cluster_ops.LIVE_ROW[kind]] > cluster_ops.LIVE_MIN[kind]
        out[kind] = _regroup(slots, shade[:, : slots.shape[1]], alive, pattern, kind)
    n_sph_slots = out["sphere"][2].shape[1]
    for kind, base in (("sphere", 0), ("triangle", n_sph_slots)):
        lasts[kind] = [(ci, base + slot, source) for ci, slot, source in out[kind][4]]
    return _with_tables(scene, out["sphere"], out["triangle"]), lasts


def prefix_rays(clusters, seed: int = 0, n: int = 2048):
    """Rays f32[8, n] on the CPU (n a multiple of 256, at least two a live
    slot) at a prefix scene's tables: one straight down onto each live slot's
    primitive (a sphere's centre, a triangle's centroid) from z 4, one
    slanted onto it, and random rays for the rest."""
    import torch

    from rt_tpu_torch import cluster_ops

    targets = []
    for kind, slots in (("sphere", clusters.sph_slots.cpu()),
                        ("triangle", clusters.tri_slots.cpu())):
        alive = slots[cluster_ops.LIVE_ROW[kind]] > cluster_ops.LIVE_MIN[kind]
        s = slots[:, alive]
        targets.append(s[0:3] if kind == "sphere" else s[0:3] + (s[3:6] + s[6:9]) / 3.0)
    targets = torch.cat(targets, dim=1)
    rng = np.random.default_rng(seed)
    k = targets.shape[1]
    n = max(n, -(-2 * k // 256) * 256)
    rays = torch.from_numpy(random_rays(rng, n=n, extent=4.0))
    org = targets.clone()
    org[2] = 4.0
    rays[0:3, :k], rays[3:6, :k] = org, targets - org
    org = targets + torch.from_numpy(rng.uniform(-0.5, 0.5, (3, k)).astype(np.float32))
    org[2] = 3.0
    rays[0:3, k : 2 * k], rays[3:6, k : 2 * k] = org, targets - org
    return rays


# The row scene: walls across the x axis and a row of spheres beside them,
# one cluster each, whose cluster indices rise toward +x, where rays start.
ROW_WALLS, ROW_SPHERES = 48, 40
ROW_STEP = 0.2  # x between neighbouring walls (and spheres)
ROW_FAR = 16.0  # x of the rays that run down the row


def row_scene(per_super: int = 64, walls: int = ROW_WALLS, spheres: int = ROW_SPHERES):
    """A scene (port only) for the order of the cluster walk: ``walls``
    walls of 4 triangles facing +x at x = ROW_STEP * k over y, z in [-1, 1]
    x [0, 2], and ``spheres`` spheres of radius 0.08 at x = ROW_STEP * k, y
    3, z 1.  Each wall and each sphere is a cluster of its own; wall k is
    cluster ``(k // per_super) * 64 + k % per_super`` (sphere k likewise),
    so that a ray coming down the row from +x meets the clusters in falling
    index: an ascending walk enters every one, a near-to-far walk the
    first.  With ``per_super`` 1 each cluster is a super of its own."""
    from rt_tpu_torch import cluster_ops
    from rt_tpu_torch.scene import SceneBuilder

    b = SceneBuilder()
    wall = b.lambertian_rgb(0.7, 0.6, 0.5)
    ball = b.lambertian_rgb(0.3, 0.5, 0.8)
    for k in range(walls):
        x = ROW_STEP * k
        for y0, y1 in ((-1.0, 0.0), (0.0, 1.0)):
            b.add_triangle((x, y0, 0.0), (x, y1, 0.0), (x, y1, 2.0), wall)
            b.add_triangle((x, y0, 0.0), (x, y1, 2.0), (x, y0, 2.0), wall)
    for k in range(spheres):
        b.add_sphere((ROW_STEP * k, 3.0, 1.0), 0.08, ball)
    scene = b.build(use_bvh=False)
    cl = scene.clusters
    ns = cl.n_sph_slots
    out = {}
    for kind, slots, prim, shade, base, per in (
            ("sphere", cl.sph_slots, cl.sph_prim, cl.shade_table[:, :ns], 0, 1),
            ("triangle", cl.tri_slots, cl.tri_prim, cl.shade_table[:, ns:], spheres, 4)):
        alive = slots[cluster_ops.LIVE_ROW[kind]] > cluster_ops.LIVE_MIN[kind]
        cols = alive.nonzero()[:, 0]
        item = (prim[cols].long() - base) // per  # the wall or sphere of each live slot
        count = walls if kind == "triangle" else spheres
        groups = [(cols[item == k], None) for k in range(count)]
        places = [(k // per_super) * 64 + k % per_super for k in range(count)]
        out[kind] = _pack_groups(slots, shade[:, : slots.shape[1]], groups, places, kind)
    return _with_tables(scene, out["sphere"], out["triangle"])


def copy_nearest_wall(tables, copy: int) -> tuple:
    """``row_scene``'s walk tables (``cluster_ops.cluster_tables``' order)
    with the nearest wall's cluster repeated in cluster ``copy``, its slots'
    primitive ids too: rays down the row meet both at the same t and id."""
    tables = list(tables)
    near, n = ROW_WALLS - 1, 128
    src, dst = slice(near * n, (near + 1) * n), slice(copy * n, (copy + 1) * n)
    boxes, slots, prim = tables[5].clone(), tables[6].clone(), tables[7].clone()
    boxes[copy], slots[:, dst], prim[dst] = boxes[near], slots[:, src], prim[src]
    tables[5:8] = boxes, slots, prim
    return tuple(tables)


def row_rays(seed: int = 0, n: int = 2048):
    """Rays f32[8, n] on the CPU (n a multiple of 256) at ``row_scene``:
    a quarter coming down the row of walls from x = ROW_FAR (through the
    walls' y, z span, slightly slanted), an eighth down the row of spheres,
    an eighth up the walls from x = -4 and the rest random."""
    import torch

    rng = np.random.default_rng(seed)
    rays = random_rays(rng, n=n, extent=6.0)
    q, e = n // 4, n // 8
    rays[0, :q] = ROW_FAR
    rays[1, :q], rays[2, :q] = rng.uniform(-0.9, 0.9, q), rng.uniform(0.1, 1.9, q)
    rays[3, :q], rays[4:6, :q] = -1.0, rng.uniform(-0.002, 0.002, (2, q))
    rows = slice(q, q + e)
    rays[0, rows], rays[1, rows], rays[2, rows] = ROW_FAR, 3.0 + rng.uniform(-0.05, 0.05, e), 1.0
    rays[3, rows], rays[4:6, rows] = -1.0, rng.uniform(-0.002, 0.002, (2, e))
    back = slice(q + e, q + 2 * e)
    rays[0, back], rays[1, back], rays[2, back] = -4.0, rng.uniform(-0.9, 0.9, e), 1.0
    rays[3, back], rays[4:6, back] = 1.0, rng.uniform(-0.002, 0.002, (2, e))
    return torch.from_numpy(rays)


# The face scene: a wall of triangles in the plane x = FACE_X, in cluster
# FACE_LOW and again in cluster FACE_HIGH (lane 1's second box, which the
# near-to-far walk reaches before lane 2's first box, FACE_LOW), each box
# exactly the wall's bounds, flat in x.
FACE_X = 0.3
FACE_LOW, FACE_HIGH = 2, 33


def face_scene(grid: int = 7):
    """A scene (port only) whose nearest hits lie on the entry face of their
    clusters' boxes: a wall of grid x grid cells of two triangles facing +x
    at x = FACE_X over y, z in [-1, 1], packed twice, into clusters
    FACE_LOW and FACE_HIGH with boxes of no margin; a strip of 40 triangles
    apart (cluster 0, so that SceneBuilder.build makes cluster tables) and a
    sphere.  Slot ids are the primitive ids, so the copy in FACE_HIGH loses
    every tie: a ray onto the wall meets both at the same t, and only
    FACE_LOW's slots are the brute-force winners."""
    from rt_tpu_torch import cluster_ops
    from rt_tpu_torch.scene import SceneBuilder

    b = SceneBuilder()
    wall = b.lambertian_rgb(0.7, 0.6, 0.5)
    step = 2.0 / grid
    for i in range(grid):
        for j in range(grid):
            y0, z0 = -1.0 + step * i, -1.0 + step * j
            y1, z1 = y0 + step, z0 + step
            b.add_triangle((FACE_X, y0, z0), (FACE_X, y1, z0), (FACE_X, y1, z1), wall)
            b.add_triangle((FACE_X, y0, z0), (FACE_X, y1, z1), (FACE_X, y0, z1), wall)
    for k in range(40):
        b.add_triangle((0.5 * k, 8.0, 0.0), (0.5 * k + 0.4, 8.0, 0.0), (0.5 * k, 8.0, 0.4), wall)
    b.add_sphere((0.0, 5.0, 0.0), 0.5, b.lambertian_rgb(0.3, 0.5, 0.8))
    scene = b.build(use_bvh=False)
    cl = scene.clusters
    ns = cl.n_sph_slots
    out = {}
    for kind, slots, prim, shade in (("sphere", cl.sph_slots, cl.sph_prim, cl.shade_table[:, :ns]),
                                     ("triangle", cl.tri_slots, cl.tri_prim,
                                      cl.shade_table[:, ns:])):
        alive = slots[cluster_ops.LIVE_ROW[kind]] > cluster_ops.LIVE_MIN[kind]
        cols = alive.nonzero()[:, 0]
        if kind == "sphere":
            groups, places = [(cols, None)], [0]
        else:
            on_wall = prim[cols].long() - 1 < 2 * grid * grid  # the sphere is primitive 0
            face = (cols[on_wall], None)
            groups, places = [(cols[~on_wall], None), face, face], [0, FACE_LOW, FACE_HIGH]
        out[kind] = _pack_groups(slots, shade[:, : slots.shape[1]], groups, places, kind, pad=0.0)
    return _with_tables(scene, out["sphere"], out["triangle"])


def face_rays(seed: int = 0, n: int = 2048):
    """Rays f32[8, n] on the CPU onto ``face_scene``'s wall from +x: origins
    at x 1 to 40 over the wall's y, z span, directions nearly along -x and
    of lengths 0.5 to 3, so that each meets the wall inside one triangle."""
    import torch

    rng = np.random.default_rng(seed)
    rays = np.zeros((8, n), np.float32)
    rays[0] = rng.uniform(1.0, 40.0, n)
    rays[1:3] = rng.uniform(-0.8, 0.8, (2, n))
    tilt = rng.uniform(-0.005, 0.005, (2, n))
    scale = rng.uniform(0.5, 3.0, n)
    rays[3], rays[4:6] = -scale, tilt * scale
    return torch.from_numpy(rays)
