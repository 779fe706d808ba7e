#!/usr/bin/env python3
"""Per-ray counts of K5's cluster walk in rtbench's K5 cells, from the plain
walk's counters (the ``work`` of ``cluster_ops.cluster_nearest_plain``) and
a replay of the same rays in the kernels' visit order.

    python3 walk_counts_cuda.py [--pixels N] [--spp S] [--device D] [CELL ...]

For each cell (by default blob-frames, car-preview, field-frames and
atrium-frames) the
scene, camera and depth are the cell's, built as rtbench builds them.
The megakernel's plain bounce loop (``megakernel.trace_paths``) traces
samples 0..S-1 of N pixels (drawn from a fixed seed, render seed 1) on the
device, its search counting the walk's work, and the script prints one JSON
line a cell: rays a path, clusters entered a ray, the mean live slots of an
entered cluster, the slot-row bytes the kernels load a ray (only the lanes
below each entered cluster's live count) and what whole clusters would
take, whether every cluster's live slots are a prefix of it, and the
slot-row bytes a unit (a frame, or a sweep) asks for at the cell's spp.
Under "orders" it gives, for the same rays, the clusters and supers
entered and the live slots tested a ray in the kernels' near-to-far order
("near", replayed by ``order_counts``) and in ascending index order
("ascending", the plain walk's own counters), and the share of each that
the near order saves.
The plain walk takes minutes on a card for the defaults.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from rt_tpu_torch import cluster_ops

DEFAULT_CELLS = ("blob-frames", "car-preview", "field-frames", "atrium-frames")
# Rays a pass of order_counts: bounds its [rays, clusters] tables.
ORDER_CHUNK = 4096


def cell_scene(name: str, device):
    """(scene on ``device``, camera, RenderConfig, the unit's spp) of
    rtbench's cell ``name``, built as the benchmark builds it."""
    from rtbench import check, drivers, harness

    cell = harness.load_cell(name)
    config, traffic = cell["config_spec"], cell["traffic_spec"]
    drivers.ensure_inputs(config)
    scene, camera, cfg = drivers.build_scene(config, check.describe(config), {})
    unit_spp = int(traffic.get("spp", traffic.get("sweep_spp", 1)))
    return scene.to(device), camera, cfg, unit_spp


def prefix_share(clusters) -> float:
    """Share of the clusters whose live slots are the first ones of it."""
    ok = total = 0
    for kind, slots in (("sphere", clusters.sph_slots), ("triangle", clusters.tri_slots)):
        alive = slots[cluster_ops.LIVE_ROW[kind]] > cluster_ops.LIVE_MIN[kind]
        count = alive.reshape(-1, cluster_ops.CLUSTER_SLOTS).sum(dim=1)
        real = count > 0
        ok += int(((cluster_ops.live_counts(slots, kind) == count) & real).sum())
        total += int(real.sum())
    return ok / max(total, 1)


def _replay(best, tn_s, adm_s, tn_c, adm_c, least, n_live) -> dict:
    """One kind's near-to-far walk of rays whose best t is ``best`` [K]
    (updated in place), replayed from their slab tests ignoring the best
    (``tn_s``, ``adm_s`` [K, supers]; ``tn_c``, ``adm_c`` [K, clusters])
    and each admitted cluster's least valid t (``least`` [K, clusters], BIG
    where none): supers in groups of 64, near to far within each, then each
    entered super's clusters near to far; a box is entered when admitted
    and its tn is not above the best t when it is reached, and the visit
    stops at the first that is.  Returns the (ray, box) pairs entered and
    the live slots (``n_live`` [clusters]) of the clusters entered."""
    k, n_sup = adm_s.shape
    out = {"supers": 0, "clusters": 0, "live_slots": 0}
    group = 2 * cluster_ops.LANES
    for s0 in range(0, n_sup, group):
        ts, adm = tn_s[:, s0 : s0 + group], adm_s[:, s0 : s0 + group]
        places = cluster_ops.near_order(ts, adm)
        for p in range(ts.shape[1]):
            sb = places[:, p : p + 1]
            enter_s = adm.gather(1, sb)[:, 0] & (ts.gather(1, sb)[:, 0] <= best)
            if not enter_s.any():
                break  # the keys left are larger, the best no larger
            out["supers"] += int(enter_s.sum())
            cols = (s0 + sb) * 64 + torch.arange(64, device=sb.device)[None]
            ac = (cols < adm_c.shape[1]) & enter_s[:, None]
            cols = torch.clamp(cols, max=adm_c.shape[1] - 1)
            tc, ac, lc = tn_c.gather(1, cols), ac & adm_c.gather(1, cols), least.gather(1, cols)
            order = cluster_ops.near_order(tc, ac)
            for j in range(64):
                c = order[:, j : j + 1]
                enter = ac.gather(1, c)[:, 0] & (tc.gather(1, c)[:, 0] <= best)
                if not enter.any():
                    break
                out["clusters"] += int(enter.sum())
                out["live_slots"] += int(n_live[cols.gather(1, c)[:, 0]][enter].sum())
                best.copy_(torch.where(enter, torch.minimum(best, lc.gather(1, c)[:, 0]), best))
    return out


def ascending_counts(work: dict) -> dict:
    """What the plain walk (ascending order) entered, from its ``work``
    counters: the counts ``order_counts`` gives for the near order."""
    kinds = ("sphere", "triangle")
    out = {"supers": sum(work.get(f"{k}_super_entries", 0) for k in kinds),
           "clusters": sum(work.get(f"{k}_cluster_entries", 0) for k in kinds),
           "live_slots": sum(work.get(f"{k}_pairs", 0) for k in kinds)}
    for k in kinds:
        out[f"{k}_clusters"] = work.get(f"{k}_cluster_entries", 0)
    return out


def order_counts(rays, tables, n_sph_slots: int, t_min: float, t_max: float, cull: bool) -> dict:
    """The rays ``rays`` f32[>=6, N] walked over whole cluster tables
    (``cluster_ops.cluster_tables``' order) in the kernels' near-to-far
    order, replayed from their slab tests and each admitted cluster's least
    valid t (the plain walk's pair tests): {"near": {...}, "admitted":
    {...}}: the (ray, box) pairs of supers and clusters entered (also by
    kind: "sphere_clusters", "triangle_clusters") and the live slots of the
    clusters entered, summed over the rays; and the (ray, cluster) pairs
    whose slab tests admit the cluster and its super, by kind.  The plain
    walk's ``work`` gives the same counts in ascending order
    (``ascending_counts``); the order changes what is entered, not the
    winner."""
    from rt_tpu_torch.elementwise import div

    n = rays.shape[1]
    counted = ("supers", "clusters", "live_slots", "sphere_clusters", "triangle_clusters")
    near = dict.fromkeys(counted, 0)
    admitted = {"sphere_clusters": 0, "triangle_clusters": 0}
    kinds = ((tables[0:4], "sphere", lambda r, s: cluster_ops._sphere_pairs(r, s, t_min, t_max)),
             (tables[4:8], "triangle",
              lambda r, s: cluster_ops._triangle_pairs(r, s, t_min, t_max, cull)))
    tiny = torch.tensor(cluster_ops.TINY, dtype=torch.float32, device=rays.device)
    for lo in range(0, n, ORDER_CHUNK):
        ox, oy, oz, dx, dy, dz = rays[:6, lo : lo + ORDER_CHUNK]
        a = dx * dx + dy * dy + dz * dz
        r = dict(ox=ox, oy=oy, oz=oz, dx=dx, dy=dy, dz=dz, a=a, inv_a=div(1.0, a))
        for axis, d in (("idx", dx), ("idy", dy), ("idz", dz)):
            r[axis] = div(1.0, torch.where(torch.abs(d) > tiny, d, tiny))
        best = torch.full_like(ox, cluster_ops.BIG)
        for (supers, clusters, slots, _), kind, pairs in kinds:
            reach = cluster_ops.sphere_reach(slots) if kind == "sphere" else None
            tn_s, adm_s = cluster_ops._enters(supers, r, None, reach)
            tn_c, adm_c = cluster_ops._enters(clusters, r, None, reach)
            least = torch.full_like(tn_c, cluster_ops.BIG)
            for ci in torch.nonzero(adm_c.any(dim=0))[:, 0].tolist():
                rows = torch.nonzero(adm_c[:, ci])[:, 0]
                block = slots[:, ci * cluster_ops.CLUSTER_SLOTS : (ci + 1) * cluster_ops.CLUSTER_SLOTS]
                least[rows, ci] = pairs({key: v[rows] for key, v in r.items()}, block).min(dim=1).values
            alive = slots[cluster_ops.LIVE_ROW[kind]] > cluster_ops.LIVE_MIN[kind]
            n_live = alive.reshape(-1, cluster_ops.CLUSTER_SLOTS).sum(dim=1)
            own_super = torch.arange(adm_c.shape[1], device=adm_c.device) // 64
            admitted[f"{kind}_clusters"] += int((adm_c & adm_s[:, own_super]).sum())
            got = _replay(best, tn_s, adm_s, tn_c, adm_c, least, n_live)
            got[f"{kind}_clusters"] = got["clusters"]
            for key, v in got.items():
                near[key] += v
    return {"near": near, "admitted": admitted}


def counts(name: str, n_pixels: int, spp: int, device) -> dict:
    import numpy as np

    from rt_tpu_torch import megakernel
    from rt_tpu_torch.camera import generate_rays

    scene, camera, cfg, unit_spp = cell_scene(name, device)
    cl = scene.clusters
    work, traced = {}, []

    def search(scene_, cfg_, rays):
        traced.append(rays[:6].clone())
        return cluster_ops.cluster_nearest_plain(
            rays, *cluster_ops.cluster_tables(cl), cl.n_sph_slots, cfg_.t_min, cfg_.t_max,
            cfg_.compat.triangle_backface_cull, work=work)

    w, h = camera.image_width, camera.image_height
    pix = np.random.default_rng(0).choice(w * h, size=min(n_pixels, w * h), replace=False)
    pix = torch.from_numpy(np.sort(pix)).to(device)
    for s in range(spp):
        org, dirn, gwork = generate_rays(camera, pix, torch.full_like(pix, s), 1, cfg.compat)
        megakernel.trace_paths(scene, cfg, 1, megakernel.frame_scalars(scene.sky), org, dirn,
                               gwork, search, cl.shade_table)
    paths = pix.numel() * spp
    walked = torch.cat(traced, dim=1)
    rays = walked.shape[1]
    orders = order_counts(walked, cluster_ops.cluster_tables(cl), cl.n_sph_slots, cfg.t_min,
                          cfg.t_max, cfg.compat.triangle_backface_cull)
    orders["ascending"] = ascending_counts(work)
    per_ray = {o: {f"{key}_a_ray": v / rays for key, v in c.items()} for o, c in orders.items()}
    saved = {f"{key}_saved": 1.0 - c / orders["ascending"][key]
             for key, c in orders["near"].items() if orders["ascending"][key]}
    kinds = ("sphere", "triangle")
    live = sum(work.get(f"{k}_row_bytes", 0) for k in kinds)
    whole = sum(work.get(f"{k}_row_bytes_whole", 0) for k in kinds)
    entered = sum(work.get(f"{k}_row_bytes_whole", 0) / cluster_ops.row_bytes(0, k)[1]
                  for k in kinds)
    pairs = sum(work.get(f"{k}_pairs", 0) for k in kinds)
    unit_paths = w * h * unit_spp
    return {"cell": name, "pixels": pix.numel(), "spp": spp, "paths": paths, "rays": rays,
            "rays_a_path": rays / paths, "clusters_a_ray": entered / rays,
            "live_slots_an_entered_cluster": pairs / max(entered, 1),
            "row_bytes_a_ray": live / rays, "row_bytes_a_ray_whole": whole / rays,
            "row_bytes_share": live / max(whole, 1), "live_prefix_share": prefix_share(cl),
            "unit_paths": unit_paths, "unit_row_bytes": unit_paths * live / paths,
            "unit_row_bytes_whole": unit_paths * whole / paths,
            "orders": {**per_ray, **saved}}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("cells", nargs="*", default=list(DEFAULT_CELLS))
    parser.add_argument("--pixels", type=int, default=1024)
    parser.add_argument("--spp", type=int, default=2)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    for name in args.cells:
        print(json.dumps(counts(name, args.pixels, args.spp, torch.device(args.device))),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
