"""Per-layer metric ``scene_build_s`` (s): host seconds of the scene's load and build in set-up
(``io.gltf_loader.add_gltf_to_scene`` and ``scene.SceneBuilder.build``).

Read from the traced run; returns None where there is nothing to read."""

def read(ctx):
    return ctx["timings"].get("scene_build_s")
