"""The Sponza atrium's program side: ``scenes.sponza_scene``, the port's
composition of the upstream's ``sponza()``, over the atrium's glb
(``rtbench/inputs/sponza.py``'s ``write_inputs``), as a user's
``--scene sponza:PATH`` builds it: the program's glTF loader and
``SceneBuilder.build`` under the configuration's sky.  The program is
imported with this module, so that the timed build holds no import."""

from __future__ import annotations

from rt_tpu_torch import scenes

from rtbench.drivers import port_sky
from rtbench.inputs import sponza


def build(config: dict, desc: dict, build_dir: str):
    sc = config["scene"]
    return scenes.sponza_scene(sponza.glb_path(sc, build_dir), sky=port_sky(sc["sky"]))
