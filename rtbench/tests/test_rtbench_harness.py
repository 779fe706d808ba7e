"""The harness: its files are found by name, its arithmetic, its refusal
without a card, and what it loads."""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from rtbench import harness, stats

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
ENTRIES = {"frames", "sweeps"}


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_parses_and_names_a_generator(config):
    spec = harness.load_json(ROOT, "rtbench", "configs", config + ".json")
    entry = next(c for c in BENCH["configs"] if c["name"] == config)
    assert entry["file"] == f"rtbench/configs/{config}.json"
    assert spec["name"] == config
    assert spec["scene"]["generator"] in ("cover", "car")
    assert set(entry["reduced"]) <= set(spec.get("upstream", {}))
    for key in ("width", "height", "camera", "render"):
        assert key in spec


@pytest.mark.parametrize("traffic", sorted(f[:-5] for f in os.listdir(
    os.path.join(ROOT, "rtbench", "workloads"))))
def test_traffic_parses_and_names_an_entry_point(traffic):
    spec = harness.load_json(ROOT, "rtbench", "workloads", traffic + ".json")
    assert spec["entry"] in ENTRIES
    assert int(spec["trace_units"]) >= 1 and int(spec["warmup_units"]) >= 1
    from rt_tpu_torch import progressive, render

    entry = {"frames": render.render_image,
             "sweeps": progressive.ProgressiveRenderer.step}[spec["entry"]]
    assert callable(entry)


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c["config_spec"]["name"] == c["config"]
    assert c["check_spec"]["limits"]
    assert {m["name"] for m in c["end_to_end"]} >= {"setup_s"}
    assert len(c["end_to_end"]) >= 2 and c["per_layer"]
    for m in c["per_layer"]:
        assert callable(harness.load_metric(m["name"]).read)


def test_every_metric_has_a_reader():
    names = {m["name"] for m in BENCH["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(ROOT, "rtbench", "metrics"))
             if f.endswith(".py")}
    assert names <= files
    for name in files:
        assert callable(harness.load_metric(name).read)


def test_every_cell_has_its_files():
    for w in BENCH["workloads"]:
        for part in (("configs", w["config"]), ("workloads", w["traffic"]),
                     ("checks", w["name"])):
            assert os.path.exists(os.path.join(ROOT, "rtbench", part[0], part[1] + ".json"))


def test_unknown_cell_is_refused():
    with pytest.raises(SystemExit):
        harness.load_cell("no-such-cell")


def test_rate_and_percentile():
    assert stats.window_rate([2.0, 2.0, 4.0], [0.0, 1.0, 2.0], [1.0, 2.0, 4.0]) == 2.0
    xs = list(np.random.default_rng(0).uniform(0, 1, 101))
    for q in (50, 95, 99):
        assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_idle_share_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert stats.union_length(iv) == 3.0
    assert stats.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    assert stats.idle_pct(iv, 0.0, 5.0) == pytest.approx(40.0)
    assert stats.idle_pct([(-1.0, 6.0)], 0.0, 5.0) == 0.0


def test_roofline_share():
    # 67 GFLOP in 10 ms is 1 ms at the FP32 peak: 10%.
    assert stats.roofline_pct(67e9, 1.0, 0.01) == pytest.approx(10.0)
    # Bound by bytes: 3.35 GB in 10 ms is 1 ms at the HBM peak.
    assert stats.roofline_pct(1.0, 3.35e9, 0.01) == pytest.approx(10.0)


def test_unit_seeds_differ_and_repeat():
    seeds = [harness.unit_seed(2**31 + 5, k) for k in range(1000)]
    assert len(set(seeds)) == 1000 and all(0 <= s < 2**31 for s in seeds)
    assert seeds == [harness.unit_seed(2**31 + 5, k) for k in range(1000)]
    assert harness.unit_seed(2**33 + 1, 0) != harness.unit_seed(2**33 + 2, 0)


def test_reservoir_keeps_a_uniform_sample():
    counts = np.zeros(10)
    for s in range(400):
        r = harness.Reservoir(2, s)
        for i in range(10):
            r.offer(i)
        for i in r.kept:
            counts[i] += 1
    assert counts.min() > 40 and counts.max() < 120


def test_run_exits_without_a_card(root):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run([sys.executable, "rtbench/run.py", "--workload", "cover-final", "--seed",
                          "4294967311", "--seconds", "1", "--trace", "0"], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert res.stdout.strip() == ""


def _top_level(mods):
    return {m.split(".")[0] for m in mods}


def test_nothing_loaded_is_jax_or_the_jax_package(root):
    code = (
        "import sys, json; sys.path.insert(0, '.');"
        "from rtbench import harness, drivers, check, trace, roofline;"
        "import rt_tpu_torch.render, rt_tpu_torch.progressive;"
        "[harness.load_metric(m['name']) for m in json.load(open('BENCHMARK.json'))['per_layer']];"
        "print(json.dumps(sorted(sys.modules)))")
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=300, check=True)
    loaded = _top_level(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "rt_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "rt_tpu"}


def test_reference_imports_nothing_of_the_program(root):
    code = ("import sys, json; sys.path.insert(0, '.');"
            "import rtbench.check, rtbench.control, rtbench.reference.tracer;"
            "print(json.dumps(sorted(sys.modules)))")
    res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=300, check=True)
    loaded = _top_level(json.loads(res.stdout.strip().splitlines()[-1]))
    assert not loaded & {"rt_tpu_torch", "rt_tpu", "jax", "jaxlib", "flax"}
    # And no file of the reference names them, even in a function body.
    ref_dir = os.path.join(root, "rtbench", "reference")
    files = [os.path.join(ref_dir, f) for f in os.listdir(ref_dir) if f.endswith(".py")]
    files += [os.path.join(root, "rtbench", f) for f in ("check.py", "stats.py", "roofline.py")]
    files += [os.path.join(root, "rtbench", "inputs", f) for f in ("cover.py", "car.py")]
    for path in files:
        for node in ast.walk(ast.parse(open(path).read())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            assert not _top_level(names) & {"rt_tpu_torch", "rt_tpu", "jax", "jaxlib", "flax"}, path
