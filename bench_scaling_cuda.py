#!/usr/bin/env python
"""Device-count scaling benchmark of the PyTorch/CUDA port, the port's
counterpart of bench_scaling.py (BASELINE.md: Mray/s at 1 card, 1 host,
N hosts).

Renders the 11x11 cover scene (400x225, depth 50, 16 spp) with
``parallel.render_sharded`` on tile meshes of 1, 2, 4, ... ranks and prints
bench_scaling.py's JSON line for each: the best of 3 warm frames (the frame
on every rank of the mesh, ended by the collectives), and Mray/s over it.
``scaling_vs_1dev`` is what bench_scaling.py prints under that name (the
mesh's Mray/s again, None on the 1-rank row); ``speedup_vs_1dev``, which
bench_scaling.py lacks, is the ratio of the mesh's Mray/s to the 1-rank
row's.

    python bench_scaling_cuda.py                  # one process: the 1-card row
    torchrun --nproc-per-node 4 bench_scaling_cuda.py --multihost
    python bench_scaling_cuda.py --device cpu --size 32x18 --spp 2

A single process joins a group of its own (NCCL on the card, gloo on the
CPU); ``--multihost`` reads the launcher's environment (one rank a card).
"""

import argparse
import json
import sys
import time

from bench_cuda import device_name, sync


def main(argv=None) -> int:
    import torch
    import torch.distributed as dist

    from rt_tpu_torch import scenes
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.parallel import free_port, initialize_multihost, make_mesh, render_sharded
    from rt_tpu_torch.render import _device

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--devices", type=int, default=None,
                        help="largest mesh (default: all ranks)")
    parser.add_argument("--multihost", action="store_true",
                        help="join the group the launcher (torchrun) describes")
    parser.add_argument("--spp", type=int, default=16)
    parser.add_argument("--size", default="400x225")
    parser.add_argument("--device", default="cuda", help="cuda | cpu")
    args = parser.parse_args(argv)

    device = _device(args.device)
    backend = "nccl" if device.type == "cuda" else "gloo"
    if args.multihost:
        initialize_multihost(backend=backend)
    else:
        initialize_multihost(f"localhost:{free_port()}", 1, 0, backend=backend)
    try:
        if device.type == "cuda":
            device = _device(f"cuda:{torch.cuda.current_device()}")
        width, height = (int(v) for v in args.size.split("x"))
        camera = scenes.cam1(width, height)
        scene = scenes.cover_scene(11, 11, camera, z=-0.2, seed=0)
        cfg = RenderConfig(width=width, height=height, max_depth=50)
        rank, top = dist.get_rank(), args.devices or dist.get_world_size()
        if rank == 0:
            print(f"bench_scaling_cuda: {dist.get_world_size()} rank(s), {backend}, rank 0 on "
                  f"{device_name(device)}", flush=True)
        counts, c = [], 1
        while c <= top:
            counts.append(c)
            c *= 2
        base = None
        for n in counts:
            mesh = make_mesh(n, tiles=n)
            if mesh.get_coordinate() is None:
                continue
            render = lambda: render_sharded(scene, camera, cfg, mesh, spp=args.spp, device=device)
            render()  # warm
            best = float("inf")
            for _ in range(3):
                sync(device)
                t0 = time.perf_counter()
                render().cpu()
                best = min(best, time.perf_counter() - t0)
            mray = args.spp * width * height / 1e6 / best
            base = mray if n == 1 else base
            if rank == 0:
                print(json.dumps({
                    "devices": n,
                    "mray_per_s": round(mray, 3),
                    "wall_s": round(best, 4),
                    "scaling_vs_1dev": None if n == 1 else round(mray, 3),
                    "speedup_vs_1dev": None if n == 1 else round(mray / base, 3),
                }), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
