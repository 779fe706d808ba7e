"""The Sponza atrium's generator (configuration ``sponza_atrium``, cell
``atrium-frames``): its description at the configuration's size is pinned,
meets the sizes the configuration states, faces out of its solids, and its
glb is written once."""

import os

import numpy as np
import pytest

from rtbench import check, harness

from test_rtbench_generators import digest

CELL = "atrium-frames"
# The description at the configuration's size (263,634 triangles, 25
# 1024x1024 textures); a numpy whose float64 ``sin`` or ``uniform`` rounds
# otherwise reads another.
DESCRIPTION = "47d78a6236379e7848b11d71af83406aac4e5d9acc35de93b777f076be55c9ab"


@pytest.fixture(scope="module")
def full():
    config = harness.load_cell(CELL)["config_spec"]
    inputs = harness.load_generator(config["scene"]["generator"])
    return config, inputs, check.describe(config), inputs.primitives(config["scene"])


def _normals(tri: np.ndarray) -> np.ndarray:
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]).astype(np.float64)
    return n / np.linalg.norm(n, axis=1, keepdims=True)


def test_description_is_pinned(full):
    assert digest(full[2]) == DESCRIPTION


def test_description_meets_the_stated_sizes(full):
    config, inputs, desc, prims = full
    tri = desc["triangles"]
    assert 250_000 <= len(tri["material"]) <= 275_000
    assert len(prims) >= 24 and len(desc["materials"]) == len(prims)
    images = [t["image"] for t in desc["textures"]]
    assert len(images) == len(desc["materials"]) >= 24
    assert all(im.shape == (1024, 1024, 3) for im in images)
    assert len({im.tobytes() for im in images}) == len(images)  # each its own texture
    assert sum(im.nbytes for im in images) >= 300e6
    metal = [m for m in desc["materials"] if m["kind"] == "metal"]
    assert 0 < len(metal) < len(desc["materials"]) / 2
    assert tri["uv"].min() >= 0.0 and tri["uv"].max() <= 1.0
    # Every triangle has an area: no degenerate faces.
    area = np.linalg.norm(np.cross(tri["b"] - tri["a"], tri["c"] - tri["a"]), axis=1)
    assert (area > 1e-6).all()
    # The camera stands in the courtyard, below the roof.
    x, y, z = config["camera"]["center"]
    assert abs(x) < inputs.HALF_X and abs(y) < inputs.ARC_FRONT
    assert 0.0 < z < inputs.STOREY + inputs.ARCH_TOP


def test_floor_and_a_wall_face_out_of_their_boxes(full):
    prims = {p["name"]: p for p in full[3]}
    for name in ("floor", "wall_north", "wall_east"):
        tri = prims[name]["tri"].astype(np.float64)
        mid = tri.reshape(-1, 3)
        center = (mid.min(0) + mid.max(0)) / 2
        out = (_normals(tri) * (tri.mean(1) - center)).sum(1)
        assert (out > 0).all(), name
    floor = prims["floor"]["tri"]
    top = floor.min(1)[:, 2] == 0.0
    assert (_normals(floor[top])[:, 2] > 0.999).all() and top.sum() > 1000


def test_a_column_faces_out_of_its_axis(full):
    """The first ground column (x = -13.5, y = 6.5): its sides face away
    from its axis, its cap up."""
    tri = {p["name"]: p for p in full[3]}["columns_ground"]["tri"].astype(np.float64)
    c = tri.mean(1)
    one = np.hypot(c[:, 0] + 13.5, c[:, 1] - 6.5) < 0.6
    n, c = _normals(tri[one]), c[one]
    radial = c[:, :2] - np.array([-13.5, 6.5])
    side = np.abs(n[:, 2]) < 0.999
    assert ((n[side, :2] * radial[side]).sum(1) > 0).all()
    assert (n[~side, 2] > 0).all() and (~side).sum() == 64


def test_no_two_faces_are_coplanar_and_overlapping(full):
    """Among the faces that lie in planes of constant x, y or z, no
    triangle's centroid lies inside another triangle of its plane."""
    tri = np.concatenate([p["tri"] for p in full[3]]).astype(np.float64)
    n = _normals(tri)
    for axis in range(3):
        flat = np.abs(n[:, axis]) > 1.0 - 1e-9
        t = tri[flat]
        at = np.round(t[:, 0, axis], 5)
        rest = [k for k in range(3) if k != axis]
        for plane in np.unique(at):
            p = t[at == plane][:, :, rest]
            if len(p) < 2:
                continue
            cen = p.mean(1)
            a, b, c = p[:, 0], p[:, 1], p[:, 2]
            for s in range(0, len(p), 512):
                q = cen[s:s + 512, None, :]
                d1 = _side(q, a, b)
                d2 = _side(q, b, c)
                d3 = _side(q, c, a)
                inside = ((d1 > 1e-9) & (d2 > 1e-9) & (d3 > 1e-9)) | (
                    (d1 < -1e-9) & (d2 < -1e-9) & (d3 < -1e-9))
                hits = inside.sum(1)
                assert (hits == 1).all(), (axis, plane, int(hits.max()))


def _side(q, a, b):
    return (b[None, :, 0] - a[None, :, 0]) * (q[..., 1] - a[None, :, 1]) - (
        b[None, :, 1] - a[None, :, 1]) * (q[..., 0] - a[None, :, 0])


def test_write_inputs_writes_once(tmp_path, monkeypatch):
    config = harness.load_cell(CELL)["config_spec"]
    inputs = harness.load_generator(config["scene"]["generator"])
    config = dict(config, scene=inputs.tiny(config["scene"]))
    calls = []
    real = inputs.write_glb
    monkeypatch.setattr(inputs, "write_glb", lambda *a: calls.append(a) or real(*a))
    for _ in range(2):
        inputs.write_inputs(config, str(tmp_path))
    path = inputs.glb_path(config["scene"], str(tmp_path))
    assert len(calls) == 1 and os.path.basename(path).startswith("sponza_")
    assert os.listdir(tmp_path) == [os.path.basename(path)]  # no temporary left
    with open(path, "rb") as f:
        assert f.read(4) == b"glTF"
    assert inputs.glb_path(inputs.tiny(config["scene"]), str(tmp_path)) == path
    assert inputs.glb_path(dict(config["scene"], seed=1), str(tmp_path)) != path
