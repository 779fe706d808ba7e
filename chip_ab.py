#!/usr/bin/env python3
"""Time the kernels of two checkouts of the port in turns, on one NVIDIA
GPU.

    python3 chip_ab.py PARENT_DIR

PARENT_DIR is the root of another checkout that holds ``rt_tpu_torch/``
(for example the parent commit, unpacked with ``git archive`` into a
git-ignored directory); each checkout builds its own kernels into its own
``build/``.  The script runs parent, change, change, parent, each in a
fresh process that imports only that checkout's package, and times, with
this checkout's ``chip_smoke.timed_cuda``, at the bench configuration:

- K1 (``megakernel.render_megakernel``) on the cover frame at 400x225, 10
  and 640 spp, and at 1600x900, 10 spp, and on the scene, camera and depth
  (100) of rtbench's cover-final cell at 640 spp, built as rtbench builds
  it;
- K3 and K3b (``prim_ops.prim_nearest_shaded`` / ``_packed``) on the
  65,536 rays of ``chip_smoke.prim_rays``;
- K2 and K2b (``nearest_ops.sphere_nearest`` / ``_packed``) on the 90,000
  rays of ``chip_smoke.nearest_phase`` against the cover scene's spheres;
- K6's scatter, reduce and gather ("full" and "unaligned")
  (``micro_probe.scatter``, ``reduce``, ``gather``) at the probe's inputs
  and shapes, at 8 and 1,024 reps, and each one's time a rep between the
  two;
- K5 (``megakernel.render_megakernel`` on a clustered scene) on the scenes,
  cameras and depths of rtbench's K5 cells, built as rtbench builds them:
  a blob-frames frame (800x450, 64 spp), a car-preview sweep (1920x1080,
  4 spp) and a field-frames frame (800x600, 64 spp);
- K4 and K4b (``cluster_ops.cluster_worklist_nearest`` / ``cluster_nearest``)
  on 65,536 rays of that blob frame (``chip_smoke.mesh_rays``: camera rays
  and first bounces).

It prints the card, the registers and spills of each checkout's kernels
(nvcc's ``-Xptxas -v`` lines, from the run that builds them), one JSON line
per run and, last, whether each output of the first change run equals the
first parent run's bit for bit, and exits non-zero if one differs.  Outputs
go to ``build/chip_ab/``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(HERE, "build", "chip_ab")


def cell_scene(name: str, dev):
    """(scene on ``dev``, camera, RenderConfig) of rtbench's cell ``name``,
    built as the benchmark builds it."""
    from rtbench import check, drivers, harness

    config = harness.load_cell(name)["config_spec"]
    drivers.ensure_inputs(config)
    scene, camera, cfg = drivers.build_scene(config, check.describe(config), {})
    return scene.to(dev), camera, cfg


def run(root: str, tag: str) -> None:
    """One timed run of the package of the checkout at ``root``."""
    sys.path.insert(0, root)
    spec = importlib.util.spec_from_file_location("chip_smoke_here",
                                                  os.path.join(HERE, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import torch

    from rt_tpu_torch import _build, cluster_ops
    from rt_tpu_torch import megakernel as mk
    from rt_tpu_torch import micro_probe as mp
    from rt_tpu_torch import nearest_ops as no
    from rt_tpu_torch import prim_ops as po
    from rt_tpu_torch import scenes
    from rt_tpu_torch.config import RenderConfig

    if not mk.__file__.startswith(root + os.sep):
        raise RuntimeError(f"{tag}: imported {mk.__file__}, not the checkout at {root}")
    timed = smoke.timed_cuda
    dev = torch.device("cuda:0")
    _build.library()
    for line in _build.build_info["log"].splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print(f"[ptxas {tag}] {line.strip()}", flush=True)
    scene, camera, cfg = scenes.bench_cover_config()
    scene.to(dev)
    wide_cam = scenes.cam1(1600, 900)
    wide = scenes.cover_scene(11, 11, wide_cam, z=-0.2, seed=0).to(dev)
    wide_cfg = RenderConfig(width=1600, height=900, samples_per_pixel=10, max_depth=50)
    rays = smoke.prim_rays(scene, camera, cfg, 65_536, dev)
    args = (rays, scene.sph_packed, scene.tri_packed)
    ns = scene.num_spheres
    outs, ms = {}, {}
    outs["k1_10"], ms["k1_10spp_ms"] = timed(
        lambda: mk.render_megakernel(scene, camera, cfg, 10, 0, cfg.seed), 5)
    outs["k1_640"], ms["k1_640spp_ms"] = timed(
        lambda: mk.render_megakernel(scene, camera, cfg, 640, 0, cfg.seed), 2)
    outs["k1_wide"], ms["k1_1600x900_ms"] = timed(
        lambda: mk.render_megakernel(wide, wide_cam, wide_cfg, 10, 0, wide_cfg.seed), 3)
    cover, cover_cam, cover_cfg = cell_scene("cover-final", dev)
    outs["k1_cover_final"], ms["k1_cover_final_640spp_ms"] = timed(
        lambda: mk.render_megakernel(cover, cover_cam, cover_cfg, 640, 0, 1), 3)
    outs["k3"], ms["k3_ms"] = timed(
        lambda: po.prim_nearest_shaded(*args, scene.shade_table, ns, 1e-3, 3e38), 20)
    outs["k3b"], ms["k3b_ms"] = timed(lambda: po.prim_nearest_packed(*args, ns, 1e-3, 3e38), 20)
    org, dirn = smoke.random_rays(90_000, 1, dev)
    spheres = (scene.sph_center[:ns], scene.sph_radius[:ns])
    packed = torch.zeros((8, 90_112), device=dev)
    packed[0:3, :90_000], packed[3:6, :90_000], packed[3:6, 90_000:] = org.T, dirn.T, 1.0
    outs["k2"], ms["k2_ms"] = timed(lambda: no.sphere_nearest(org, dirn, *spheres, 1e-3, 3e38), 20)
    outs["k2b"], ms["k2b_ms"] = timed(
        lambda: no.sphere_nearest_packed(packed, scene.sph_packed, 1e-3, 3e38), 20)
    sc = mp.SCATTER_SHAPE
    data = mp.inputs("all", dev)
    d, red, g = data["scatter"], data["reduce"], data["gather"]
    gather_args = (g["rays_t"], g["slots"], g["item"], g["vcl"])
    k6 = {"scatter": lambda reps: mp.scatter(d["vals"], d["dst"], reps, mp.NI // sc["ch"], **sc),
          "reduce": lambda reps: mp.reduce(red["rid"], red["key"], reps, mp.NI),
          "gather": lambda reps: mp.gather(*gather_args, reps, mp.NV),
          "gather_unaligned": lambda reps: mp.gather(*gather_args, reps, mp.NV, mode="unaligned")}
    for body, fn in k6.items():
        for reps in (8, 1024):
            outs[f"{body}_{reps}"], ms[f"{body}_{reps}reps_ms"] = timed(lambda: fn(reps), 5)
        ms[f"{body}_ms_per_rep"] = (ms[f"{body}_1024reps_ms"] - ms[f"{body}_8reps_ms"]) / 1016
    blob, blob_cam, blob_cfg = cell_scene("blob-frames", dev)
    car, car_cam, car_cfg = cell_scene("car-preview", dev)
    outs["k5_blob"], ms["k5_blob_frame_ms"] = timed(
        lambda: mk.render_megakernel(blob, blob_cam, blob_cfg, 64, 0, 1), 3)
    outs["k5_car"], ms["k5_car_sweep_ms"] = timed(
        lambda: mk.render_megakernel(car, car_cam, car_cfg, 4, 0, 1), 5)
    field, field_cam, field_cfg = cell_scene("field-frames", dev)
    outs["k5_field"], ms["k5_field_frame_ms"] = timed(
        lambda: mk.render_megakernel(field, field_cam, field_cfg, 64, 0, 1), 3)
    cl = blob.clusters
    walk = (smoke.mesh_rays(blob, blob_cam, blob_cfg, 65_536, dev),
            *cluster_ops.cluster_tables(cl), cl.n_sph_slots, blob_cfg.t_min, blob_cfg.t_max,
            blob_cfg.compat.triangle_backface_cull)
    outs["k4"], ms["k4_ms"] = timed(lambda: cluster_ops.cluster_worklist_nearest(*walk), 20)
    outs["k4b"], ms["k4b_ms"] = timed(lambda: cluster_ops.cluster_nearest(*walk), 20)
    os.makedirs(OUT, exist_ok=True)
    torch.save({k: [x.cpu() for x in v] if isinstance(v, tuple) else v.cpu()
                for k, v in outs.items()}, os.path.join(OUT, f"{tag}.pt"))
    print(json.dumps({"run": tag, **ms}), flush=True)


def main() -> int:
    if len(sys.argv) == 4 and sys.argv[1] == "--run":
        run(os.path.abspath(sys.argv[2]), sys.argv[3])
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    parent = os.path.abspath(sys.argv[1])
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[card] {card}")
    for root, tag in ((parent, "parent1"), (HERE, "change1"), (HERE, "change2"),
                      (parent, "parent2")):
        subprocess.run([sys.executable, os.path.abspath(__file__), "--run", root, tag], check=True)
    a = torch.load(os.path.join(OUT, "parent1.pt"))
    b = torch.load(os.path.join(OUT, "change1.pt"))
    same = {k: (all(torch.equal(x, y) for x, y in zip(a[k], b[k])) if isinstance(a[k], list)
                else torch.equal(a[k], b[k])) for k in a}
    print(json.dumps({"bit_equal_parent_change": same}))
    return 0 if all(same.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
