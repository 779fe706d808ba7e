"""The night car's program side: the ground through ``scenes.add_ground_plane``
and the car's glb (``rtbench/inputs/car.py``'s ``write_inputs``) through the
program's glTF loader, as a user's scene loads one.  The program is imported
with this module, so that the timed build holds no import."""

from __future__ import annotations

from rt_tpu_torch import scenes
from rt_tpu_torch.io.gltf_loader import add_gltf_to_scene
from rt_tpu_torch.scene import SceneBuilder

from rtbench.drivers import port_sky
from rtbench.inputs import car


def build(config: dict, desc: dict, build_dir: str):
    sc = config["scene"]
    g = sc["ground"]
    sky = port_sky(sc["sky"])
    b = SceneBuilder()
    ground = b.lambertian(b.checker(g["scale"], b.solid_color(g["even"]), b.solid_color(g["odd"])))
    scenes.add_ground_plane(b, g["size"], g["size"], g["z"], ground, True)
    add_gltf_to_scene(b, car.glb_path(sc, build_dir), compat_all_metal=False)
    return b.build(sky=sky)
