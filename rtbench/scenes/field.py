"""The default scene's program side: ``scenes.default_scene``, the
composition of the upstream's main.rs, over the model's glb
(``rtbench/inputs/field.py``'s ``write_inputs``), placed by
``scenes.scale_rotate_mat``: the program's ground, lattice, glTF loader and
``SceneBuilder.build``, as a user's run builds them.  The program is
imported with this module, so that the timed build holds no import.

The scene function takes the camera, the glb, the grid, the seed, the
placement and the sky; the ground and the lattice's height are fixed in it.
The configuration states them for the reference side, so the build stops
where the two disagree."""

from __future__ import annotations

import numpy as np

from rt_tpu_torch import scenes
from rt_tpu_torch.camera import make_camera

from rtbench.drivers import port_sky
from rtbench.inputs import field


def _stated_scene_is_built(scene, sc: dict) -> None:
    """Raise where the configuration's ground or lattice height differ from
    the scene's tables (textures 0-2, the first two triangles, the big
    spheres' centres)."""
    f32 = lambda x: np.asarray(x, np.float32)
    g = sc["ground"]
    s, z = float(g["size"]) / 2.0, float(g["z"])
    tri = np.stack([scene.tri_a.numpy(), scene.tri_b.numpy(), scene.tri_c.numpy()], 1)
    color = scene.tex_color.numpy()
    pairs = {
        "ground.even": (color[0], f32(g["even"])),
        "ground.odd": (color[1], f32(g["odd"])),
        "ground.scale": (scene.tex_inv_scale.numpy()[2], f32(1.0 / float(g["scale"]))),
        "ground": (tri[:2], f32([[(-s, -s, z), (s, -s, z), (s, s, z)],
                                 [(-s, -s, z), (s, s, z), (-s, s, z)]])),
        "z": (scene.sph_center.numpy()[:3, 2], f32([0.7 + float(sc["z"])] * 3)),
    }
    wrong = [k for k, (built, stated) in pairs.items()
             if built.shape != stated.shape or not np.array_equal(built, stated)]
    if wrong:
        raise ValueError(f"the configuration states another scene than "
                         f"scenes.default_scene builds: {', '.join(wrong)}")


def build(config: dict, desc: dict, build_dir: str):
    sc = config["scene"]
    cam = config["camera"]
    camera = make_camera(cam["center"], cam["lookat"], cam["up"],
                         focus_distance=cam["focus_distance"], defocus_angle=0.0,
                         image_width=config["width"], image_height=config["height"],
                         vertical_fov=cam["vfov"])
    t = sc["mesh"]["transform"]
    scene = scenes.default_scene(camera, field.glb_path(sc, build_dir), grid=sc["grid"],
                                 seed=sc["seed"],
                                 transform=scenes.scale_rotate_mat(t["roll"], t["pitch"],
                                                                   t["yaw"], t["scale"]),
                                 sky=port_sky(sc["sky"]))
    _stated_scene_is_built(scene, sc)
    return scene
