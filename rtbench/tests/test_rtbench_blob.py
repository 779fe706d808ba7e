"""The skull-class mesh's generator (configuration ``skull_area_light``,
cell ``blob-frames``): its description at the published size is pinned,
and its OBJ is written once."""

import os

import pytest

from rtbench import check, harness

from test_rtbench_generators import digest

CELL = "blob-frames"
# The description at the published size (res 224, seed 0: 99,904 mesh
# triangles); a numpy whose float64 ``sin`` rounds otherwise reads another.
DESCRIPTION = "77d49cf0f7f486871d1a943523d69feb58ec0e0a415568c7f7e38f91e6623ec8"


def test_description_is_pinned():
    desc = check.describe(harness.load_cell(CELL)["config_spec"])
    assert len(desc["triangles"]["material"]) == 2 + 99_904 + 2
    assert digest(desc) == DESCRIPTION


def test_write_inputs_writes_once(tmp_path, monkeypatch):
    config = harness.load_cell(CELL)["config_spec"]
    inputs = harness.load_generator(config["scene"]["generator"])
    config = dict(config, scene=inputs.tiny(config["scene"]))
    calls = []
    real = inputs.make_obj_mesh
    monkeypatch.setattr(inputs, "make_obj_mesh", lambda *a: calls.append(a) or real(*a))
    for _ in range(2):
        inputs.write_inputs(config, str(tmp_path))
    path = inputs.obj_path(config["scene"], str(tmp_path))
    assert len(calls) == 1 and os.path.basename(path) == "blob_r12_s0.obj"
    assert os.listdir(tmp_path) == [os.path.basename(path)]  # no temporary left
    with open(path) as f:
        assert sum(line.startswith("f ") for line in f) == 264
