"""The upstream's default scene's generator (configuration
``main_default_scene``, cell ``field-frames``): its description at the
published size is pinned, and its glb is written once."""

import os

from rtbench import check, harness

from test_rtbench_generators import digest

CELL = "field-frames"
# The description at the published size (a 300 x 300 lattice drawn in bulk
# from seed 0: 359,961 spheres with the three big ones; the model's 54,720
# triangles and the ground's 2); a numpy whose float64 ``sin`` or
# ``uniform`` rounds otherwise reads another.
DESCRIPTION = "970ffd135ef01bde3b3f0382be442a3bac89372ff640e5ec172c1be48e63fc59"


def test_description_is_pinned():
    desc = check.describe(harness.load_cell(CELL)["config_spec"])
    assert len(desc["spheres"]["radius"]) == 359_961
    assert len(desc["triangles"]["material"]) == 2 + 54_720
    assert digest(desc) == DESCRIPTION


def test_write_inputs_writes_once(tmp_path, monkeypatch):
    config = harness.load_cell(CELL)["config_spec"]
    inputs = harness.load_generator(config["scene"]["generator"])
    config = dict(config, scene=inputs.tiny(config["scene"]))
    calls = []
    real = inputs.car.write_glb
    monkeypatch.setattr(inputs.car, "write_glb", lambda *a: calls.append(a) or real(*a))
    for _ in range(2):
        inputs.write_inputs(config, str(tmp_path))
    path = inputs.glb_path(config["scene"], str(tmp_path))
    assert len(calls) == 1 and os.path.basename(path) == "car_r12_p3_s1.glb"
    assert os.listdir(tmp_path) == [os.path.basename(path)]  # no temporary left
    with open(path, "rb") as f:
        assert f.read(4) == b"glTF"
