"""The stand-in mesh's program side: the mesh's OBJ
(``rtbench/inputs/blob.py``'s ``write_inputs``) through the program's scene
function ``scenes.mesh_with_area_light``, as a user's scene loads one: the
program's OBJ loader, the ground, the plaster, the emissive panel, then
``SceneBuilder.build``'s cluster tables and BVH.  The program is imported
with this module, so that the timed build holds no import.

The scene function takes only the OBJ and the light's radiance; the ground,
the plaster, the panel and the sky are fixed in it.  The configuration
states them for the reference side, so the build stops where the two
disagree: a configuration that states another scene names one that this
program side does not build."""

from __future__ import annotations

import numpy as np

from rt_tpu_torch import scenes

from rtbench.inputs import blob


def _stated_scene_is_built(scene, sc: dict) -> None:
    """Raise where the configuration's ground, plaster, panel or sky differ
    from the scene's tables (textures 0-4 and the first two and last two
    triangles, in the scene function's order)."""
    f32 = lambda x: np.asarray(x, np.float32)
    g, light, sky = sc["ground"], sc["light"], sc["sky"]
    s, z = float(g["size"]) / 2.0, float(g["z"])
    panel = f32(light["triangles"])
    tri = np.stack([scene.tri_a.numpy(), scene.tri_b.numpy(), scene.tri_c.numpy()], 1)
    color = scene.tex_color.numpy()
    pairs = {
        "ground.even": (color[0], f32(g["even"])),
        "ground.odd": (color[1], f32(g["odd"])),
        "ground.scale": (scene.tex_inv_scale.numpy()[2], f32(1.0 / float(g["scale"]))),
        "ground": (tri[:2], f32([[(-s, -s, z), (s, -s, z), (s, s, z)],
                                 [(-s, -s, z), (s, s, z), (-s, s, z)]])),
        "plaster": (color[3], f32(sc["plaster"])),
        "light.radiance": (color[4], f32(light["radiance"])),
        "light.triangles": (tri[-len(panel):], panel),
        "sky": (f32([*scene.sky.sun_direction.tolist(), float(scene.sky.turbidity),
                     float(scene.sky.exposure)]),
                f32([*sky["sun"], sky["turbidity"], sky["exposure"]])),
    }
    wrong = [k for k, (built, stated) in pairs.items()
             if built.shape != stated.shape or not np.array_equal(built, stated)]
    if sky["model"] != "perez" or scene.sky.hw_params is not None:
        wrong.append("sky.model")
    if wrong:
        raise ValueError(f"the configuration states another scene than "
                         f"scenes.mesh_with_area_light builds: {', '.join(wrong)}")


def build(config: dict, desc: dict, build_dir: str):
    sc = config["scene"]
    scene = scenes.mesh_with_area_light(blob.obj_path(sc, build_dir),
                                        light_radiance=tuple(sc["light"]["radiance"]),
                                        mesh_style="plaster")
    _stated_scene_is_built(scene, sc)
    return scene
