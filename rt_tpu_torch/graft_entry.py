"""Compile-check and multi-rank entry points (the port of ``__graft_entry__.py``).

- ``entry()``: a forward step (a cover-scene ``render_chunk``) and its
  arguments, on one card by default.
- ``dryrun_multichip(n)``: spawns ``n`` ranks (gloo over
  ``tcp://localhost``, on one card by default: several ranks share it)
  that build a ('tiles', 'spp') mesh and run the sharded renders (the
  cover through ``render_sharded`` and the wavefront, the clustered
  megakernel on a triangle cloud), each held bit for bit against the same
  shards run serially, and one sharded inverse-rendering training step.

    python -c "from rt_tpu_torch.graft_entry import dryrun_multichip; dryrun_multichip(2)"
"""

from __future__ import annotations

import os


def entry(device="cuda"):
    """(forward, args): ``forward(*args)`` renders the 64x36 frame of the
    3x3 cover scene at 2 spp and depth 8 through ``render_chunk`` on
    ``device``, returning f32[2304, 3]."""
    import torch

    from rt_tpu_torch import rng, scenes
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.render import _device, render_chunk

    device = _device(device)
    camera = scenes.cam1(64, 36)
    scene = scenes.cover_scene(3, 3, camera, z=-0.2, seed=0).to(device)
    cfg = RenderConfig(width=64, height=36, samples_per_pixel=2, max_depth=8)
    pixel_idx = torch.arange(64 * 36, dtype=torch.int32, device=device)

    def forward(scene, camera, pixel_idx, key):
        return render_chunk(scene, camera, pixel_idx, cfg, 2, 0, key)

    return forward, (scene, camera, pixel_idx, rng.key(0))


def cloud_scene():
    """The dryrun's clustered scene (``__graft_entry__.py:77-99``): a ground
    sphere and 150 random triangles, built with cluster tables and no
    BVH."""
    import numpy as np

    from rt_tpu_torch.scene import SceneBuilder
    from rt_tpu_torch.sky import SkyParams

    rs = np.random.default_rng(0)
    b = SceneBuilder()
    b.add_sphere((0, 0, -1000), 1000, b.lambertian(b.solid_color((0.5, 0.5, 0.5))))
    mat = b.lambertian(b.solid_color((0.6, 0.4, 0.3)))
    for _ in range(150):
        c = rs.uniform(-3, 3, 3)
        c[2] = rs.uniform(0.2, 2.0)
        d1 = rs.uniform(-0.3, 0.3, 3)
        d2 = rs.uniform(-0.3, 0.3, 3)
        b.add_triangle(tuple(c), tuple(c + d1), tuple(c + d2), mat)
    return b.build(sky=SkyParams.default())


# The dryrun's samples a pixel and learning rate.
DRYRUN_SPP, DRYRUN_LR = 2, 1e-2


def dryrun_setup(n_devices: int):
    """The dryrun's mesh shape (tiles, spp), with ``tiles = n // 2`` for an
    even n > 1 and n otherwise, and its two scenes as (scene, camera, cfg):
    the 2x2 cover at 32x16 (2 spp, depth 4, 3 differentiable) and the
    triangle cloud at 64 x (n * 256 / 64) (1 spp, depth 3)."""
    from rt_tpu_torch import scenes
    from rt_tpu_torch.config import RenderConfig

    n = n_devices
    tiles = max(n // 2, 1) if n % 2 == 0 and n > 1 else n
    camera = scenes.cam1(32, 16)
    cover = (scenes.cover_scene(2, 2, camera, z=-0.2, seed=0), camera,
             RenderConfig(width=32, height=16, samples_per_pixel=DRYRUN_SPP, max_depth=4,
                          diff_max_depth=3))
    wc, hc = 64, (n * 256) // 64
    cam_cl = scenes.cam1(wc, hc)
    cloud = (cloud_scene(), cam_cl,
             RenderConfig(width=wc, height=hc, samples_per_pixel=1, max_depth=3))
    return (tiles, n // tiles), cover, cloud


def _dryrun(n_devices: int, device) -> dict:
    """One rank's dryrun; returns what it ran and saw.  On rank (0, 0)
    every sharded frame is held bit for bit against the same shards run
    one after another on that rank (the spp group has at most two ranks,
    and a sum of two partial sums does not depend on their order)."""
    import numpy as np
    import torch

    from rt_tpu_torch import grad as grad_mod
    from rt_tpu_torch import megakernel, nearest_ops, prim_ops, rng
    from rt_tpu_torch.parallel import (
        assemble_render, make_mesh, megakernel_shard, render_shard, render_sharded,
        render_sharded_megakernel, render_sharded_wavefront, train_step_sharded, wavefront_shard,
    )

    def check(cond, msg):
        if not cond:
            raise RuntimeError(msg)

    n = n_devices
    shape, (scene, camera, cfg), (scene_cl, cam_cl, cfg_cl) = dryrun_setup(n)
    mesh = make_mesh(n, tiles=shape[0])
    first = tuple(mesh.get_coordinate()) == (0, 0)
    launches = lambda: {"megakernel_clustered": megakernel.LAUNCHES_CLUSTERED,
                        "sphere_nearest": nearest_ops.LAUNCHES["sphere_nearest"],
                        "prim_nearest_shaded": prim_ops.LAUNCHES["prim_nearest_shaded"]}
    before = launches()

    spp, key = DRYRUN_SPP, rng.key(cfg.seed)
    img = render_sharded(scene, camera, cfg, mesh, spp=spp, device=device)
    frame = (camera.image_height, camera.image_width, 3)
    check(img.shape == frame and bool(torch.isfinite(img).all()), "render_sharded")
    img_wf = render_sharded_wavefront(scene, camera, cfg, mesh, spp=spp, device=device)
    check(img_wf.shape == frame and bool(torch.isfinite(img_wf).all()),
          "render_sharded_wavefront")

    # The production kernel family under the mesh: the clustered megakernel
    # (K5) on the triangle cloud, 256 pixels a rank.  (The JAX dryrun
    # forces its expansion sweep here; K5 has none, its warp walk carries
    # the scene.)
    check(megakernel.eligible_clustered(scene_cl, cfg_cl), "the cloud is not clustered")
    k5_before = megakernel.LAUNCHES_CLUSTERED
    img_cl = render_sharded_megakernel(scene_cl, cam_cl, cfg_cl, mesh, spp=1, device=device)
    k5_sharded = megakernel.LAUNCHES_CLUSTERED - k5_before
    check(img_cl.shape == (cam_cl.image_height, cam_cl.image_width, 3)
          and bool(torch.isfinite(img_cl).all()), "render_sharded_megakernel")
    serial_equal, before_serial = None, launches()
    if first:
        t, s = shape
        sums = [[render_shard(scene, camera, cfg, shape, (i, j), spp, key) for j in range(s)]
                for i in range(t)]
        serial = assemble_render([sum(p[1:], p[0]) for p in sums], camera, spp, shape)
        serial_wf = wavefront_shard(scene, camera, cfg, 1, 0, spp, key).reshape(frame)
        key_cl = rng.key(cfg_cl.seed)
        serial_cl = torch.cat([megakernel_shard(scene_cl, cam_cl, cfg_cl, n, r, 1, key_cl)
                               for r in range(n)]).reshape(img_cl.shape)
        serial_equal = {"render_sharded": bool(torch.equal(img, serial)),
                        "render_sharded_wavefront": bool(torch.equal(img_wf, serial_wf)),
                        "render_sharded_megakernel": bool(torch.equal(img_cl, serial_cl))}
        check(all(serial_equal.values()), f"mesh-shape-dependent result: {serial_equal}")
    serial_launches = {k: v - before_serial[k] for k, v in launches().items()}

    # One training step: pixels over 'tiles', samples over 'spp', params
    # replicated, gradients summed over the mesh.
    n_pixels, lr = camera.image_width * camera.image_height, DRYRUN_LR
    target = img.reshape(n_pixels, 3).cpu().numpy()
    old = [p.detach().clone() for p in grad_mod.get_params(scene)]
    loss, new_scene = train_step_sharded(scene, camera, cfg, mesh,
                                         np.arange(n_pixels, dtype=np.int32), target, spp=spp,
                                         lr=lr, device=device)
    check(bool(torch.isfinite(loss)) and bool(torch.isfinite(new_scene.tex_color).all()),
          "train_step_sharded")
    after = launches()
    return {
        "mesh": dict(zip(mesh.mesh_dim_names, shape)),
        "loss": float(loss),
        "update": [((new.detach() - o) / lr).cpu().numpy()
                   for new, o in zip(grad_mod.get_params(new_scene), old)],
        "k5_sharded": k5_sharded,
        "serial_equal": serial_equal,
        "frames": ({"render_sharded": img.cpu().numpy(),
                    "render_sharded_wavefront": img_wf.cpu().numpy(),
                    "render_sharded_megakernel": img_cl.cpu().numpy()} if first else None),
        "launches": {k: after[k] - before[k] - serial_launches[k] for k in after},
        "device": str(img.device),
    }


def _rank_main(rank: int, n: int, port: int, device: str, queue) -> None:
    import torch
    import torch.distributed as dist

    from rt_tpu_torch.parallel import initialize_multihost

    if device == "cpu":
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // n))
    else:
        torch.cuda.set_device(rank % torch.cuda.device_count())
    initialize_multihost(f"localhost:{port}", n, rank, backend="gloo")
    try:
        result = _dryrun(n, device)
        queue.put(dict(result, rank=rank))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device="cuda") -> list[dict]:
    """Spawn ``n_devices`` gloo ranks on ``device`` ("cuda": all on the
    visible cards, several ranks a card; "cpu") and run the dryrun in each.
    Prints the JAX dryrun's line and returns each rank's result (rank
    order): mesh, loss, the parameters' update ``(new - old) / lr``, K5
    launches of its sharded megakernel, the kernel launches of its sharded
    calls (not of rank 0's serial checks; 0 on the CPU, where the wrappers
    run the plain versions), and on rank 0 its three sharded frames and
    their serial checks."""
    import torch.multiprocessing as mp

    from rt_tpu_torch.parallel import free_port
    from rt_tpu_torch.render import _device

    device = _device(device).type
    queue = mp.get_context("spawn").Queue()
    procs = mp.start_processes(_rank_main, args=(n_devices, free_port(), device, queue),
                               nprocs=n_devices, join=False, start_method="spawn")
    results = []
    while not procs.join(timeout=1):
        while not queue.empty():
            results.append(queue.get())
    while len(results) < n_devices:
        results.append(queue.get(timeout=30))
    results.sort(key=lambda r: r["rank"])
    print(f"dryrun_multichip({n_devices}): mesh={results[0]['mesh']} "
          f"loss={results[0]['loss']:.6f}", flush=True)
    return results
