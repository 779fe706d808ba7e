"""The control of a cell's check: the reference computed in bfloat16, the
nearest precision below the float32 that the configurations state, put in
the program's place and held against the float32 reference by the same
numbers and limits.  It has to come out as not correct.

    python3 rtbench/control.py --workload <cell> --seeds A,B,C [--sweeps K]

For each seed it builds the answers a run would compare (the first unit's
frame, or a progressive image after ``K`` sweeps, over the
pixels drawn from the seed), prints one JSON line of the numbers beside
their limits, and whether the control passed.  The benchmark's own runs do
not run it.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np


def control_numbers(cell: dict, seed: int, device, sweeps: int = 16) -> dict:
    """The numbers of the bfloat16 control against the float32 reference on
    the answers of seed ``seed``."""
    import torch

    from rtbench import check, harness

    config, traffic, spec = cell["config_spec"], cell["traffic_spec"], cell["check_spec"]
    f32 = check.Reference(config, device)
    b16 = check.Reference(config, device, torch.bfloat16)
    s = harness.unit_seed(seed, 0)
    entry = traffic["entry"]
    if entry == "frames":
        pix = check.sample_pixels(seed, f32.n_pixels, spec["pixels"], 0)
        spp = int(traffic["spp"])
        return check.image_numbers(b16.frame_pixels(pix, spp, s), f32.frame_pixels(pix, spp, s))
    pix = check.sample_pixels(seed, f32.n_pixels, spec["pixels"], 0)
    ns, wf = int(traffic["sweep_spp"]), traffic["engine"] == "wavefront"
    return check.image_numbers(b16.progressive_pixels(pix, s, sweeps, ns, wf),
                               f32.progressive_pixels(pix, s, sweeps, ns, wf))


def main(argv=None) -> int:
    import argparse
    import time

    from rtbench import harness

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated run seeds")
    ap.add_argument("--sweeps", type=int, default=16, help="sweeps of a progressive image")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    cell = harness.load_cell(args.workload)
    limits = cell["check_spec"]["limits"]
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        nums = control_numbers(cell, seed, args.device, args.sweeps)
        passed = all(nums.get(k, np.inf) <= v for k, v in limits.items())
        print(json.dumps({"cell": args.workload, "seed": seed, "control_passed": passed,
                          "seconds": time.perf_counter() - t0,
                          "numbers": {k: {"value": nums.get(k), "limit": v}
                                      for k, v in limits.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [p for p in sys.path if os.path.abspath(p or ".") != here]
    sys.path.insert(0, os.path.dirname(here))
    sys.exit(main())
