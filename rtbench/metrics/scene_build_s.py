"""Per-layer metric ``scene_build_s`` (s): host seconds, on the harness's own clock, of the
scene's build in set-up: the call to the generator's program side
(``rtbench/scenes/<generator>.py``; for the car ``io.gltf_loader.add_gltf_to_scene`` and
``scene.SceneBuilder.build``), or the description's replay on a ``scene.SceneBuilder`` where
the generator has none.

Read from the traced run; returns None where there is nothing to read."""

def read(ctx):
    return ctx["timings"].get("scene_build_s")
