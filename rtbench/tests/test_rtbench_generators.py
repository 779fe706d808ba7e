"""Scene generators are found by name: what the configurations give is
pinned, and a new generator runs end to end as new files only.

The descriptions' hashes were computed from the code before generators
were looked up by name, the scene tables' from the program as it stood
when the pin was limited to the tables it renders from; a numpy whose
float64 ``sin`` rounds otherwise reads other hashes.
"""

import hashlib
import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from rtbench import check, drivers, harness

from conftest import tiny_cell

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))

DESCRIPTIONS = {  # the configurations' descriptions at their published sizes
    "cover-final": "d234872bcf060ac4c39033528b92e3208a83f3be1c00d01c5b4cf42647eedee6",
    "car-preview": "cad81fca2665ad3e593c23c8ac4a50f633be60a62c7bfabc67f460b85eff839c",
}
TINY_TABLES = {  # the program's scene tables (``scene_tables``) at ``tiny_cell``'s size
    "blob-frames": "0c9ba5ecb7baa3cbcf01ffefd6e50349a61aeeb24db8ec61457857ef23e5c9fd",
    "car-preview": "8fbcc6d9f7eb60c78f48e85c0164787bb73bc14cd1745a6391c09f5e68009748",
    "cover-final": "6823dd8ee93ec26e8c80d53816282c8e62a9273e16bab64b8ec819252eae656f",
}


def digest(obj, h=None):
    """sha256 of a nest of dicts (keys sorted), lists and tuples (in order),
    arrays and tensors (dtype, shape, bytes) and plain values (repr)."""
    top = h is None
    h = hashlib.sha256() if top else h
    if isinstance(obj, dict):
        h.update(b"{%d" % len(obj))
        for k in sorted(obj):
            h.update(repr(k).encode())
            digest(obj[k], h)
    elif isinstance(obj, (list, tuple)):
        h.update(b"[%d" % len(obj))
        for v in obj:
            digest(v, h)
    elif isinstance(obj, torch.Tensor):
        digest(obj.detach().cpu().numpy(), h)
    elif isinstance(obj, (np.ndarray, np.generic)):
        a = np.ascontiguousarray(obj)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    else:
        h.update(repr(obj).encode())
    return h.hexdigest() if top else None


# What the port renders from, by name: SceneData's tables and sizes, the
# whole cluster tables that K5 and the wavefront's K4 walk, and the BVH.
# Not the JAX package's parity payload (the cluster pages and their slot
# bases, ``checker_table``, ``inline_ok``, ``chord_clusters``), which no
# kernel of the port reads; a buffer added beside these is not pinned either.
SCENE_TABLES = (
    "sph_center", "sph_radius", "sph_front_dir", "sph_material",
    "tri_a", "tri_b", "tri_c", "tri_normal", "tri_uv", "tri_material",
    "mat_kind", "mat_texture", "mat_fuzz", "mat_ior",
    "tex_kind", "tex_color", "tex_inv_scale", "tex_children", "tex_rect",
    "atlas", "shade_table", "sph_packed", "tri_packed",
    "num_spheres", "num_triangles", "has_image_textures",
)
CLUSTER_TABLES = ("sph_super", "sph_cluster", "sph_slots", "tri_super", "tri_cluster",
                  "tri_slots", "shade_table", "n_sph_slots")
BVH_TABLES = ("node_min", "node_max", "hit_next", "miss_next", "leaf_start", "leaf_count",
              "prim_order")
PARITY_PAYLOAD = ("pages", "checker_table", "inline_ok", "chord_clusters")


def scene_tables(scene) -> dict:
    """The tables and sizes of a SceneData that the port renders from, its
    sky's fields, and those of its cluster tables and BVH (None where the
    scene has none)."""
    out = {k: getattr(scene, k) for k in SCENE_TABLES}
    out["sky"] = dict(vars(scene.sky))
    for part, names in (("clusters", CLUSTER_TABLES), ("bvh", BVH_TABLES)):
        sub = getattr(scene, part)
        out[part] = None if sub is None else {k: getattr(sub, k) for k in names}
    return out


def tiny_scene(cell: str):
    config = tiny_cell(cell)["config_spec"]
    drivers.ensure_inputs(config)
    scene, _, _ = drivers.build_scene(config, check.describe(config), {})
    return scene


@pytest.mark.parametrize("cell", sorted(DESCRIPTIONS))
def test_description_is_pinned(cell):
    assert digest(check.describe(harness.load_cell(cell)["config_spec"])) == DESCRIPTIONS[cell]


@pytest.mark.parametrize("cell", sorted(TINY_TABLES))
def test_program_scene_tables_are_pinned(cell):
    assert digest(scene_tables(tiny_scene(cell))) == TINY_TABLES[cell]


@pytest.mark.parametrize("table", ["sph_slots", "shade_table"])
def test_pin_sees_one_changed_cluster_value(table):
    scene = tiny_scene("car-preview")
    before = digest(scene_tables(scene))
    flat = getattr(scene.clusters, table).view(-1)
    flat[0] = 0.25 if flat[0] != 0.25 else 0.5
    assert digest(scene_tables(scene)) != before


@pytest.mark.parametrize("payload", PARITY_PAYLOAD + ("all",))
def test_pin_leaves_out_the_parity_payload(payload):
    scene = tiny_scene("car-preview")
    before = digest(scene_tables(scene))
    for name in PARITY_PAYLOAD if payload == "all" else (payload,):
        delattr(scene.clusters, name)
        assert not hasattr(scene.clusters, name)
    assert digest(scene_tables(scene)) == before


def test_unknown_generator_is_refused():
    config = dict(tiny_cell("cover-final")["config_spec"], scene={"generator": "no_such_scene"})
    for call in (lambda: check.describe(config), lambda: drivers.ensure_inputs(config),
                 lambda: drivers.build_scene(config, {}, {})):
        with pytest.raises(SystemExit, match=r"'no_such_scene'.*rtbench/inputs/no_such_scene\.py"
                                             r".*rtbench/scenes/no_such_scene\.py"):
            call()


def test_a_name_that_leaves_the_folder_is_refused():
    with pytest.raises(SystemExit, match="no scene generator"):
        harness.load_generator("../harness")


# A toy generator, as a later configuration would add it: an emissive quad
# standing behind a lambertian sphere on a checkered ground, under a dim
# Perez sky.  Files only; nothing of the benchmark is edited.

TOY_INPUTS = '''
"""A toy scene: an emissive quad, a lambertian sphere, a checkered ground."""

import numpy as np


def describe(config):
    sc = config["scene"]
    s, z = sc["ground"] / 2.0, 0.0
    textures = [{"kind": "solid", "color": (0.1, 0.1, 0.1)},
                {"kind": "solid", "color": (0.9, 0.9, 0.9)},
                {"kind": "checker", "scale": 0.5, "even": 0, "odd": 1},
                {"kind": "solid", "color": tuple(sc["ball"])},
                {"kind": "solid", "color": tuple(sc["light"])}]
    materials = [{"kind": "lambertian", "texture": 2}, {"kind": "lambertian", "texture": 3},
                 {"kind": "emissive", "texture": 4}]
    uv = [[0.0, 0.0], [1.0, 0.0], [0.5, 1.0]]
    qa, qb, qc, qd = (-s, -s, z), (s, -s, z), (s, s, z), (-s, s, z)
    la, lb, lc, ld = (-1.0, 1.5, 0.1), (1.0, 1.5, 0.1), (1.0, 1.5, 1.9), (-1.0, 1.5, 1.9)
    return {
        "textures": textures, "materials": materials,
        "spheres": {"center": np.array([[0.0, 0.0, 0.6]]), "radius": np.array([0.6]),
                    "front": np.array([[1.0, 0.0, 0.0]]), "material": np.array([1])},
        "triangles": {"a": np.array([qa, qa, la, la]), "b": np.array([qb, qc, lb, lc]),
                      "c": np.array([qc, qd, lc, ld]), "uv": np.array([uv] * 4),
                      "material": np.array([0, 0, 2, 2])},
        "sky": {"model": "perez", "sun": [0.0, 0.0, 1.0], "turbidity": 2.0, "exposure": 0.05},
    }
'''

TOY_SCENE = '''
"""The toy scene built by hand on the program's SceneBuilder."""

from rtbench.drivers import port_sky


def build(config, desc, build_dir):
    from rt_tpu_torch.scene import SceneBuilder

    sc = config["scene"]
    b = SceneBuilder()
    ground = b.lambertian(b.checker(0.5, b.solid_color((0.1, 0.1, 0.1)),
                                    b.solid_color((0.9, 0.9, 0.9))))
    ball = b.lambertian(b.solid_color(sc["ball"]))
    light = b.emissive(sc["light"])
    b.add_sphere((0.0, 0.0, 0.6), 0.6, ball)
    s = sc["ground"] / 2.0
    b.add_triangle((-s, -s, 0.0), (s, -s, 0.0), (s, s, 0.0), ground)
    b.add_triangle((-s, -s, 0.0), (s, s, 0.0), (-s, s, 0.0), ground)
    if LIGHT:
        b.add_triangle((-1.0, 1.5, 0.1), (1.0, 1.5, 0.1), (1.0, 1.5, 1.9), light)
        b.add_triangle((-1.0, 1.5, 0.1), (1.0, 1.5, 1.9), (-1.0, 1.5, 1.9), light)
    return b.build(sky=port_sky(desc["sky"]))
'''

TOY_CONFIG = {
    "name": "toy_room", "what": "a test's toy scene",
    "scene": {"generator": "toy", "ground": 20.0, "ball": [0.8, 0.3, 0.2],
              "light": [4.0, 4.0, 3.5]},
    "camera": {"center": [0.0, -4.0, 1.2], "lookat": [0.0, 0.0, 0.6], "up": [0.0, 0.0, 1.0],
               "vfov": 40.0, "focus_distance": 4.0},
    "width": 16, "height": 9, "render": {"max_depth": 8},
}


def _toy_checkout(tmp_path, program_side):
    """A copy of the benchmark with the toy's files added: a configuration,
    a traffic mix, a check, the generator's reference side and, unless
    ``program_side`` is None, its program side."""
    out = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "rtbench"), out / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append({"name": "toy_room", "source": "https://example.org/toy",
                             "file": "rtbench/configs/toy_room.json", "reduced": [],
                             "why": "a test's toy"})
    bench["workloads"].append({"name": "toy-frames", "config": "toy_room", "traffic": "toy2",
                               "chips": 1, "why": "a test's toy"})
    files = {
        "BENCHMARK.json": bench,
        "rtbench/configs/toy_room.json": TOY_CONFIG,
        "rtbench/workloads/toy2.json": {"entry": "frames", "spp": 2, "warmup_units": 1,
                                        "trace_units": 1},
        "rtbench/checks/toy-frames.json": {"answers": 1, "pixels": 144,
                                           "limits": {"px_err_max": 0.01, "px_err_mean": 1e-4}},
    }
    for rel, obj in files.items():
        (out / rel).write_text(json.dumps(obj))
    (out / "rtbench/inputs/toy.py").write_text(TOY_INPUTS)
    if program_side is not None:
        (out / "rtbench/scenes/toy.py").write_text(f"LIGHT = {program_side == 'lit'}\n" + TOY_SCENE)
    return str(out)


def _run_in(checkout: str) -> dict:
    """``harness.run_cell`` of the toy cell on the CPU, in a process that
    imports the benchmark from ``checkout`` and the program from here."""
    code = "\n".join([
        "import contextlib, json, sys, time",
        f"sys.path[:0] = [{checkout!r}, {ROOT!r}]",
        "from rtbench import harness",
        f"assert harness.ROOT == {checkout!r}",
        "cell = harness.load_cell('toy-frames')",
        "with contextlib.redirect_stdout(sys.stderr):",
        "    res = harness.run_cell(cell, 2**31 + 4099, 0.2, False, 'cpu', time.monotonic())",
        "print(json.dumps(res))"])
    res = subprocess.run([sys.executable, "-c", code], cwd=checkout, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-4000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("program_side", [None, "lit"], ids=["replayed", "built"])
def test_toy_generator_runs_as_new_files(tmp_path, program_side):
    res = _run_in(_toy_checkout(tmp_path, program_side))
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 0, res["check"]


def test_toy_without_its_light_is_not_correct(tmp_path):
    res = _run_in(_toy_checkout(tmp_path, "dark"))
    assert not res["correct"], res["check"]
    assert res["check"]["px_err_max"]["value"] > 10 * res["check"]["px_err_max"]["limit"]
