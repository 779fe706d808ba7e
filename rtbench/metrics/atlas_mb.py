"""Per-layer metric ``atlas_mb`` (MB, 10^6 bytes): the image atlas that the cell's kernels read
(``scene._pack_atlas``'s f32 RGB atlas of the scene's distinct images), from the program's
``scene.ATLAS`` after the cell's build.  It is a size of the configuration, the same in every
run: it changes only with the atlas's layout or precision.  On an H100 the atrium's 314.57 MB
atlas cost 0.3% of K5's frame against 64x64 textures, so a smaller atlas moves ``mray_s`` little.

Read from the traced run; returns None where there is nothing to read (a program without
``scene.ATLAS``, or no build)."""


def read(ctx):
    from rt_tpu_torch import scene

    atlas = getattr(scene, "ATLAS", None)
    if not atlas or not atlas.get("bytes"):
        return None
    return atlas["bytes"] / 1e6
