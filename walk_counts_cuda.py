#!/usr/bin/env python3
"""Per-ray counts of K5's cluster walk in rtbench's K5 cells, from the plain
walk's counters (the ``work`` of ``cluster_ops.cluster_nearest_plain``).

    python3 walk_counts_cuda.py [--pixels N] [--spp S] [--device D] [CELL ...]

For each cell (by default blob-frames and car-preview) the scene, camera
and depth are the cell's, built as rtbench builds them.
The megakernel's plain bounce loop (``megakernel.trace_paths``) traces
samples 0..S-1 of N pixels (drawn from a fixed seed, render seed 1) on the
device, its search counting the walk's work, and the script prints one JSON
line a cell: rays a path, clusters entered a ray, the mean live slots of an
entered cluster, the slot-row bytes the kernels load a ray (only the lanes
below each entered cluster's live count) and what whole clusters would
take, whether every cluster's live slots are a prefix of it, and the
slot-row bytes a unit (a frame, or a sweep) asks for at the cell's spp.
The plain walk takes minutes on a card for the defaults.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

DEFAULT_CELLS = ("blob-frames", "car-preview")


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
    from rt_tpu_torch import cluster_ops

    ok = total = 0
    for kind, slots in (("sphere", clusters.sph_slots), ("triangle", clusters.tri_slots)):
        alive = slots[cluster_ops.LIVE_ROW[kind]] > cluster_ops.LIVE_MIN[kind]
        count = alive.reshape(-1, cluster_ops.CLUSTER_SLOTS).sum(dim=1)
        real = count > 0
        ok += int(((cluster_ops.live_counts(slots, kind) == count) & real).sum())
        total += int(real.sum())
    return ok / max(total, 1)


def counts(name: str, n_pixels: int, spp: int, device) -> dict:
    import numpy as np

    from rt_tpu_torch import cluster_ops, megakernel
    from rt_tpu_torch.camera import generate_rays

    scene, camera, cfg, unit_spp = cell_scene(name, device)
    cl = scene.clusters
    work, n_rays = {}, [0]

    def search(scene_, cfg_, rays):
        n_rays[0] += rays.shape[1]
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
    rays = n_rays[0]
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
            "unit_row_bytes_whole": unit_paths * whole / paths}


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
