"""One run of one benchmark cell: set-up, warm-up, the measured window (or,
with ``--trace 1``, a profiled run of a fixed count of units), the check of
the answers against the reference, and the result line.

A cell is an entry of ``workloads`` in BENCHMARK.json: a configuration
(``rtbench/configs/<config>.json``) under a traffic mix
(``rtbench/workloads/<traffic>.json``), with its check
(``rtbench/checks/<cell>.json``: how many answers and pixels are compared,
and each number's limit).  A configuration's ``scene.generator`` names its
scene's generator (``load_generator``), and a per-layer metric is read by
``rtbench/metrics/<metric>.py``.  All are found by name.

The loop is closed: one user, each unit (a frame or a sweep)
starting when the one before has ended.  A unit ends when its call has
returned and the card has finished the work it was given (a device
synchronize), so a program that returns before its kernels and copies
are done is still timed whole.  Every unit's render seed
comes from ``--seed`` and the unit's index; the scene is the
configuration's.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import re
import statistics
import sys
import time
import traceback

import numpy as np

from rtbench import stats

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "rtbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "rt_tpu")
_MASK64 = (1 << 64) - 1


def process_start() -> float:
    """This process's start on ``time.monotonic``'s clock (Linux's
    /proc/self/stat start time), or now where that is not readable."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.monotonic() - (uptime - start)
    except (OSError, ValueError, IndexError):
        return time.monotonic()


def load_json(*parts) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def load_cell(name: str, root: str = ROOT) -> dict:
    """The cell's entry of BENCHMARK.json with its configuration, traffic,
    check and the per-layer metrics it reports."""
    bench = load_json(root, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"rtbench: no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
    return assemble_cell(dict(cells[name]), bench, root)


def assemble_cell(cell: dict, bench: dict, root: str = ROOT) -> dict:
    """``cell`` (name, config, traffic) with its files and the metrics of
    ``bench`` that it reports."""
    name = cell["name"]
    cell["config_spec"] = load_json(root, "rtbench", "configs", cell["config"] + ".json")
    cell["traffic_spec"] = load_json(root, "rtbench", "workloads", cell["traffic"] + ".json")
    cell["check_spec"] = load_json(root, "rtbench", "checks", name + ".json")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    e2e_names = {m["name"] for m in e2e}
    cell["end_to_end"] = e2e
    cell["per_layer"] = [m for m in bench["per_layer"]
                         if name in m.get("workloads", [name] if m["moves"] in e2e_names else [])]
    return cell


def unit_seed(seed: int, k: int) -> int:
    """The render seed of unit ``k`` of a run (31 bits; splitmix64 of the
    run's seed and the unit's index)."""
    z = ((int(seed) & _MASK64) * 0x9E3779B97F4A7C15 + (k + 1) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return (z ^ (z >> 31)) & 0x7FFFFFFF


WARM_STREAM = 1 << 40  # unit indices of warm-up units, apart from the window's


class Reservoir:
    """A uniform sample of ``m`` answers of a stream (algorithm R), drawn
    from the run's seed."""

    def __init__(self, m: int, seed: int):
        self.m, self.kept, self.n = m, [], 0
        self.rng = np.random.default_rng([int(seed) & 0xFFFFFFFFFFFF, 7])

    def offer(self, item) -> None:
        if item is None:
            return
        if len(self.kept) < self.m:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.n + 1))
            if j < self.m:
                self.kept[j] = item
        self.n += 1


def _load_file(path: str, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_metric(name: str):
    """The reader module of a per-layer metric (rtbench/metrics/<name>.py)."""
    return _load_file(os.path.join(HERE, "metrics", name + ".py"),
                      "rtbench_metric_" + name.replace(".", "_"))


def load_generator(name: str, side: str = "inputs"):
    """A half of the scene generator that a configuration's
    ``scene.generator`` names: ``rtbench/inputs/<name>.py``, the reference's
    side, which every generator has, or ``rtbench/scenes/<name>.py``, the
    program's side, which is optional (None where it is missing).  A
    generator without its reference's side stops the run."""
    rel = {s: f"rtbench/{s}/{name}.py" for s in ("inputs", "scenes")}
    if not re.fullmatch(r"[A-Za-z0-9_][A-Za-z0-9_.-]*", name) or not os.path.exists(
            os.path.join(ROOT, rel["inputs"])):
        raise SystemExit(f"rtbench: no scene generator {name!r}: looked for {rel['inputs']} "
                         f"(the reference's side) and {rel['scenes']} (the program's side)")
    path = os.path.join(ROOT, rel[side])
    if not os.path.exists(path):
        return None
    return _load_file(path, f"rtbench_{side}_" + re.sub(r"[.-]", "_", name))


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell: dict, seed: int, seconds: float, trace: bool, device, t_start: float,
             log=sys.stderr) -> dict:
    """One run; returns the result dict (the keys of the result line)."""
    import torch

    from rtbench import check, drivers

    config, traffic, spec = cell["config_spec"], cell["traffic_spec"], cell["check_spec"]
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    timings: dict = {}
    drivers.ensure_inputs(config)
    scene, camera, cfg = drivers.build_scene(config, check.describe(config), timings)
    scene.to(dev)
    make = lambda stream: drivers.make_driver(config, traffic, scene, camera, cfg, dev,
                                              lambda j: unit_seed(seed, stream + j))
    warm = make(WARM_STREAM)
    for i in range(int(traffic.get("warmup_units", 1))):
        warm.unit(unit_seed(seed, WARM_STREAM + i))
    warm.close()
    del warm
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    driver = make(0)
    keep = Reservoir(int(spec.get("answers", 1)), seed)
    starts, ends, work = [], [], []
    failed = 0
    first_error = None

    def one(k: int) -> None:
        nonlocal failed, first_error
        s = time.monotonic()
        try:
            w, bad, answer = driver.unit(unit_seed(seed, k))
            if cuda:  # the card's work is the unit's, whatever the program waited for
                torch.cuda.synchronize(dev)
        except Exception:  # a unit that raises is counted, and the run goes on
            failed += 1
            first_error = first_error or traceback.format_exc()
            w, answer = 0, None
        else:
            failed += bad
            keep.offer(answer)
        e = time.monotonic()
        starts.append(s)
        ends.append(e)
        work.append(w)

    setup_s = None
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        n_units = int(traffic["trace_units"])
        setup_s = time.monotonic() - t_start
        with profile(activities=acts) as prof:
            for k in range(n_units):
                with record_function("rtbench.unit." + traffic["entry"]):
                    one(k)
            if cuda:
                torch.cuda.synchronize(dev)
    else:
        setup_s = time.monotonic() - t_start
        while True:
            one(len(starts))
            if ends[-1] - starts[0] >= seconds:
                break
    bad_last, final_answer = driver.close()
    failed += bad_last
    if final_answer is not None:
        keep = Reservoir(1, seed)
        keep.offer(final_answer)
    attempted = len(starts)
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"rtbench: the run loaded {found}; the benchmark measures the port only")

    result = {"correct": False, "attempted": attempted, "failed": failed, "metrics": {},
              "device": {}}
    if trace:
        from rtbench import trace as trace_mod

        tr = trace_mod.from_profiler(prof, attempted)
        del prof
        ctx = {"trace": tr, "timings": timings, "units": attempted, "config": config,
               "traffic": traffic, "cell": cell, "device": dev}
        for m in cell["per_layer"]:
            value = load_metric(m["name"]).read(ctx)
            if value is not None:
                result["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}
        result["device"].update(busy_s=tr.busy_seconds(), window_s=tr.window[1] - tr.window[0])
        result["breakdown"] = trace_mod.breakdown(tr)
    else:
        names = {m["name"] for m in cell["end_to_end"]}
        unit_s = [e - s for s, e in zip(starts, ends)]
        values = {
            "mray_s": lambda: stats.window_rate(work, starts, ends) / 1e6,
            "sweep_ms_p95": lambda: 1e3 * stats.percentile(unit_s, 95.0),
            "setup_s": lambda: setup_s,
        }
        units = {m["name"]: m["unit"] for m in cell["end_to_end"]}
        for name in sorted(names):
            result["metrics"][name] = {"value": float(values[name]()), "unit": units[name]}
        print(f"rtbench: {attempted} units in {ends[-1] - starts[0]:.3f} s, min / median / max "
              f"{1e3 * min(unit_s):.3f} / {1e3 * statistics.median(unit_s):.3f} / "
              f"{1e3 * max(unit_s):.3f} ms", file=log)

    # The check: the program's state freed first, so the reference's memory
    # does not count in the peak.
    del driver, scene
    if cuda:
        torch.cuda.empty_cache()
    numbers = check.compare(traffic["entry"], keep.kept, config, traffic, spec, seed, dev, log=log)
    limits = spec["limits"]
    ok_numbers = bool(keep.kept) and all(numbers.get(k, float("inf")) <= v
                                         for k, v in limits.items())
    if first_error:
        print(first_error, file=log)
    result["correct"] = bool(ok_numbers and failed == 0 and attempted > 0)
    result["device"].update(platform="gpu" if cuda else "cpu",
                            kind=torch.cuda.get_device_name(dev) if cuda else "cpu",
                            count=1, memory_peak_bytes=peak)
    # The numbers compared, each beside its limit: the result line's last
    # key, and the last lines on standard error.
    result["check"] = {k: {"value": numbers.get(k), "limit": v} for k, v in limits.items()}
    for k, v in limits.items():
        print(f"check {k} = {numbers.get(k)!r} (limit {v!r})", file=log)
    return result


def main(argv=None) -> int:
    t_start = process_start()
    import argparse

    ap = argparse.ArgumentParser(description="Run one benchmark cell once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = load_cell(args.workload)

    import torch

    chips = int(cell.get("chips", 1))
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"rtbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    with contextlib.redirect_stdout(sys.stderr):
        result = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_start)
    print(json.dumps(result), flush=True)
    return 0
