#!/usr/bin/env python3
"""Time variants of the compile-time shapes of K2 and K6's reduce, gather
and scatter in turns, on one NVIDIA GPU.

    python3 chip_variants.py [PARENT_DIR]

Each variant is a copy of ``rt_tpu_torch/csrc`` under ``build/chip_variants/``
with K2's lanes a ray (``kGroup`` in csrc/nearest.cu), the scatter's
threads and columns a block (``kScatterThreads``, ``kScatterCols``),
reduce's blocks (a thread block cluster when more than one,
``kReduceCluster``) and the gather's slot lanes a thread and visits a block
(``kGatherLanes``, ``kGatherVisits``, all in csrc/micro_probe.cu) set to
other values; the first is the checkout's own.
PARENT_DIR, the root of another checkout (for example the parent commit,
unpacked with ``git archive``), adds that checkout's kernels.  Every
library is built with the package's own flags, checked against the plain
versions (K2 and K2b bit for bit on 90,000 rays x the cover scene's 447
spheres, on a 2,500-sphere table and on the tie scene at t_max 1e9, 3e38
and inf; the scatter bit for bit against the sequential model of
tests/torch_micro_cases.py; reduce and gather bit for bit against their
plain versions in the cases of ``chip_smoke.micro_exact_cases``), then
timed three rounds in turns with ``chip_smoke.timed_cuda``: K2 and K2b,
and at 8 and 1,024 reps (the time a rep is the slope between them) the
scatter, reduce at n 8,192 and 1,024 and the gather ("full" at 1,024 and
128 visits, "unaligned" at 1,024).  It prints one line per
library and round, and the card last; it exits non-zero if a check fails.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
OUT = HERE / "build" / "chip_variants"
# (K2 lanes a ray, scatter threads a block, scatter columns a block, reduce
# blocks, gather lanes a thread, gather visits a block); the first row is
# the checkout's own values.  The kernels are independent, so each row
# varies several of them at once.
VARIANTS = [(4, 256, 16, 1, 1, 4), (1, 256, 32, 8, 1, 1), (2, 128, 32, 4, 2, 2),
            (8, 512, 32, 2, 1, 8), (16, 256, 8, 8, 4, 2), (4, 256, 16, 1, 2, 1),
            (4, 256, 16, 2, 1, 2)]
CONSTANTS = (("nearest.cu", "kGroup"), ("micro_probe.cu", "kScatterThreads"),
             ("micro_probe.cu", "kScatterCols"), ("micro_probe.cu", "kReduceCluster"),
             ("micro_probe.cu", "kGatherLanes"), ("micro_probe.cu", "kGatherVisits"))


def variant_csrc(values: tuple) -> tuple[str, Path]:
    """(name, a copy of csrc with the constants set to ``values``); raises
    if a constant is not found with the checkout's value."""
    name = "g{}_t{}_c{}_r{}_l{}v{}".format(*values)
    dst = OUT / name / "csrc"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(HERE / "rt_tpu_torch" / "csrc", dst)
    for (file, const), own, new in zip(CONSTANTS, VARIANTS[0], values):
        path = dst / file
        text = path.read_text()
        old = f"constexpr int {const} = {own};"
        if old not in text:
            raise RuntimeError(f"{file}: {old!r} not found")
        path.write_text(text.replace(old, f"constexpr int {const} = {new};"))
    return name, dst


def main() -> int:
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(HERE / "tests"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_variants: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 1
    import chip_smoke as smoke
    import torch_brute_cases as brute  # by path: another package may be "tests"
    import torch_micro_cases as micro

    from rt_tpu_torch import _build
    from rt_tpu_torch import micro_probe as mp
    from rt_tpu_torch import nearest_ops as no
    from rt_tpu_torch.scenes import bench_cover_config

    libs = dict(variant_csrc(v) for v in VARIANTS)
    if len(sys.argv) == 2:
        libs["parent"] = Path(sys.argv[1]).resolve() / "rt_tpu_torch" / "csrc"

    def use(name: str) -> None:
        _build.CSRC, _build.BUILD_DIR, _build._lib = libs[name], OUT / name / "build", None
        _build.library()

    for name in libs:
        use(name)
        log = _build.build_info["log"].splitlines()
        for i, line in enumerate(log):
            kernel = next((k for k in ("sphere_nearest", "scatter_kernel", "reduce_kernel",
                                       "gather_kernel") if k in line), None)
            if "Compiling entry function" in line and kernel:
                for x in log[i + 1 : i + 4]:
                    if "spill" in x or "registers" in x:
                        print(f"[build] {name} {kernel}: {x.strip()}")

    dev = torch.device("cuda:0")
    scene = bench_cover_config()[0].to(dev)
    ns = scene.num_spheres
    spheres = (scene.sph_center[:ns], scene.sph_radius[:ns])
    org, dirn = smoke.random_rays(90_000, 1, dev)
    packed = torch.zeros((8, 90_112), device=dev)
    packed[0:3, :90_000], packed[3:6, :90_000], packed[3:6, 90_000:] = org.T, dirn.T, 1.0
    rs = np.random.default_rng(5)
    big_c = rs.uniform((-8, -8, 0), (8, 8, 2), (2500, 3)).astype(np.float32)
    big_r = rs.uniform(0.05, 0.4, (2500,)).astype(np.float32)
    big_c[2000], big_r[2000] = big_c[7], big_r[7]  # a tie across the table's tiles
    big = (torch.from_numpy(big_c).to(dev), torch.from_numpy(big_r).to(dev))
    big_org, big_dir = smoke.random_rays(20_000, 3, dev)
    big_org[:500] = big[0][7]
    tie, tie_rays = brute.tie_scene().to(dev), brute.tie_rays().to(dev)
    tns = tie.num_spheres
    sc = mp.SCATTER_SHAPE
    s = mp.inputs("scatter", dev)["scatter"]
    rep_dst = micro.repeated_dst(sc["kk"], 3).to(dev)
    scr0 = torch.from_numpy(np.random.default_rng(1).standard_normal((8, mp.NI))
                            .astype(np.float32)).to(dev)

    k2_cases = [(org, dirn, *spheres, 3e38), (big_org, big_dir, *big, 3e38)]
    k2_cases += [(tie_rays[0:3].T, tie_rays[3:6].T, tie.sph_center[:tns], tie.sph_radius[:tns],
                  t_max) for t_max in (1e9, 3e38, float("inf"))]
    k2b_cases = [(packed, scene.sph_packed, 3e38)]
    k2b_cases += [(tie_rays, tie.sph_packed, t_max) for t_max in (1e9, 3e38, float("inf"))]
    k2_refs = [no.sphere_nearest_plain(*c[:4], 1e-3, c[4]) for c in k2_cases]
    k2b_refs = [no.sphere_nearest_packed_plain(*c[:2], 1e-3, c[2]) for c in k2b_cases]
    scatter_cases = [(s["dst"], reps, 16, None) for reps in (1, 3)]
    scatter_cases += [(rep_dst, reps, 18, scr0) for reps in (1, 3)]
    scatter_refs = [micro.scatter_sequential(s["vals"].cpu(), d.cpu(), reps, nch,
                                             scr=None if s0 is None else s0.cpu())
                    for d, reps, nch, s0 in scatter_cases]
    micro_cases = smoke.micro_exact_cases(dev)
    micro_refs = [plain() for _, _, plain in micro_cases]
    probe = mp.inputs("all", dev)  # the probe's own inputs, as chip_smoke.py times them
    red, g = probe["reduce"], probe["gather"]
    gather_args = (g["rays_t"], g["slots"], g["item"], g["vcl"])
    per_rep = {"scatter": lambda reps: mp.scatter(s["vals"], s["dst"], reps, mp.NI // sc["ch"], **sc),
               "reduce": lambda reps: mp.reduce(red["rid"], red["key"], reps, mp.NI),
               "reduce_n1024": lambda reps: mp.reduce(red["rid"], red["key"], reps, mp.NI // 8),
               "gather": lambda reps: mp.gather(*gather_args, reps, mp.NV),
               "gather_nv128": lambda reps: mp.gather(*gather_args, reps, mp.NV // 8),
               "gather_unaligned": lambda reps: mp.gather(*gather_args, reps, mp.NV,
                                                          mode="unaligned")}
    ok = True
    for name in libs:
        use(name)
        same = {"k2": all(smoke.equal(no.sphere_nearest(*c[:4], 1e-3, c[4]), r)
                          for c, r in zip(k2_cases, k2_refs)),
                "k2b": all(smoke.equal(no.sphere_nearest_packed(*c[:2], 1e-3, c[2]), r)
                           for c, r in zip(k2b_cases, k2b_refs)),
                "scatter": all(smoke.equal([x.cpu() for x in mp.scatter(s["vals"], d, reps, nch,
                                                                       scr=s0)], r)
                               for (d, reps, nch, s0), r in zip(scatter_cases, scatter_refs)),
                "reduce_gather": [label for (label, kernel, _), ref in zip(micro_cases, micro_refs)
                                  if not smoke.equal(kernel(), ref)] == []}
        print(f"[check] {name}: bit-equal {json.dumps(same)}", flush=True)
        ok = ok and all(same.values())

    names = list(libs)
    for rnd in range(3):
        for name in names if rnd % 2 == 0 else names[::-1]:
            use(name)
            t = {"k2_ms": smoke.timed_cuda(
                     lambda: no.sphere_nearest(org, dirn, *spheres, 1e-3, 3e38), 20)[1],
                 "k2b_ms": smoke.timed_cuda(
                     lambda: no.sphere_nearest_packed(packed, scene.sph_packed, 1e-3, 3e38), 20)[1]}
            for body, fn in per_rep.items():
                for reps in (8, 1024):
                    t[f"{body}_{reps}reps_ms"] = smoke.timed_cuda(lambda: fn(reps), 5)[1]
                t[f"{body}_ms_per_rep"] = (t[f"{body}_1024reps_ms"] - t[f"{body}_8reps_ms"]) / 1016
            print(json.dumps({"variant": name, "round": rnd, **t}), flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"[card] {card}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
