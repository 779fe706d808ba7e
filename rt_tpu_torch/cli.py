"""Command-line interface: render one frame, or run the progressive sweep
schedule, and write the image as PNG or PPM.

Examples:
    python -m rt_tpu_torch.cli --scene cover --size 400x225 --spp 10 --out out.png
    python -m rt_tpu_torch.cli --scene textured --camera cam2 --device cpu --out t.ppm
    python -m rt_tpu_torch.cli --scene obj:model.obj --size 200x112 --spp 2 --out m.png
    python -m rt_tpu_torch.cli --scene gltf:model.glb --camera widecam --spp 8 --out g.png
    python -m rt_tpu_torch.cli --scene default:model.glb --spp 64 --out d.png
    python -m rt_tpu_torch.cli --scene sponza:sponza.glb --spp 64 --out s.png
    python -m rt_tpu_torch.cli --scene cover --size 400x225 --progressive --passes 4 \
        --checkpoint cover.npz --out cover.png
    python -m rt_tpu_torch.cli --scene cover --progressive --serve 8000 --term-preview
    python -m rt_tpu_torch.cli --scene cover --probe 200,150
    python -m rt_tpu_torch.cli --scene cover --size 400x225 --spp 8 --trace t.json --out t.png
"""

from __future__ import annotations

import argparse
import json
import sys


def build_scene(spec: str, camera, seed: int, texture_dir: str | None):
    from rt_tpu_torch import scenes

    if spec == "cover":
        return scenes.cover_scene(11, 11, camera, z=-0.2, seed=seed, texture_dir=texture_dir)
    if spec == "cover-large":
        return scenes.cover_scene(300, 300, camera, z=-0.2, seed=seed, texture_dir=texture_dir)
    if spec == "earth":
        return scenes.earth_scene(texture_dir)
    if spec == "checkered":
        return scenes.gen_checkered()
    if spec == "textured":
        return scenes.textured_spheres_scene(texture_dir)
    if spec == "triangles":
        return scenes.triangle_scene(texture_dir)
    if spec.startswith("obj:"):
        from rt_tpu_torch.io.obj_loader import load_obj
        from rt_tpu_torch.scene import SceneBuilder

        b = SceneBuilder()
        mat = b.lambertian_rgb(0.8, 0.8, 0.8)
        for model in load_obj(spec[4:]):
            b.add_triangles(model["vertices"], model["uvs"], mat)
        even = b.solid_color((0.1, 0.1, 0.1))
        odd = b.solid_color((0.95, 0.95, 0.95))
        ground = b.lambertian(b.checker(0.75, even, odd))
        scenes.add_ground_plane(b, 1000.0, 1000.0, -0.2, ground)
        return b.build()
    if spec.startswith("gltf:"):
        from rt_tpu_torch.io.gltf_loader import add_gltf_to_scene
        from rt_tpu_torch.scene import SceneBuilder

        b = SceneBuilder()
        add_gltf_to_scene(b, spec[5:])
        return b.build()
    if spec.startswith("default:"):
        return scenes.default_scene(camera, spec[8:], seed=seed)
    if spec.startswith("sponza:"):
        return scenes.sponza_scene(spec[7:])
    raise SystemExit(f"unknown scene: {spec!r}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="rt_tpu_torch", description=__doc__)
    parser.add_argument("--scene", default="cover",
                        help="cover | cover-large | earth | checkered | textured | triangles | "
                        "obj:PATH | gltf:PATH | default:PATH (the upstream's main.rs scene: the "
                        "cover-large lattice, a checkered ground and the glTF at PATH) | "
                        "sponza:PATH (the upstream's sponza(): the atrium's glTF at PATH alone "
                        "under the live sky)")
    parser.add_argument("--camera", default="cam1", choices=["cam1", "cam2", "widecam", "topdown"])
    parser.add_argument("--size", default="800x600", help="WIDTHxHEIGHT")
    parser.add_argument("--spp", type=int, default=32)
    parser.add_argument("--max-depth", type=int, default=100)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--out", default="render.png", help=".png or .ppm")
    parser.add_argument("--texture-dir", default=None,
                        help="directory with earth/mars/moon/saul textures")
    parser.add_argument("--device", default="cuda", help="cuda | cuda:N | cpu")
    parser.add_argument("--progressive", action="store_true",
                        help="run the reference's 237-pass sweep schedule")
    parser.add_argument("--passes", type=int, default=None, help="limit progressive passes")
    parser.add_argument("--checkpoint", default=None,
                        help="progressive checkpoint .npz (resumed if it exists)")
    parser.add_argument("--engine", default="wavefront", choices=["wavefront", "mega"],
                        help="progressive sweep engine: the persistent wavefront (K3/K4) or "
                        "the megakernel (K1/K5)")
    parser.add_argument("--checkpoint-every", type=int, default=1,
                        help="sweeps between checkpoint writes")
    parser.add_argument("--metrics", default=None, help="JSONL metrics path")
    parser.add_argument("--serve", type=int, default=None,
                        help="HTTP preview port (progressive mode; 0 binds a free port)")
    parser.add_argument("--term-preview", action="store_true",
                        help="live in-terminal preview (ANSI half-blocks; kitty graphics when "
                        "TERM supports it)")
    parser.add_argument("--probe", default=None, metavar="X,Y",
                        help="print click-debug info for pixel X,Y and exit")
    parser.add_argument("--trace", default=None, metavar="PATH",
                        help="write a torch.profiler Chrome trace of the set-up and the render, "
                        "with the package's rt.* spans, to PATH")
    args = parser.parse_args(argv)
    if not args.trace:
        return _run(args)
    from rt_tpu_torch.profiling import device_trace

    with device_trace(args.trace):
        rc = _run(args)
    print(f"wrote {args.trace}", file=sys.stderr)
    return rc


def _run(args) -> int:
    from rt_tpu_torch import scenes
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.io import write_png, write_ppm
    from rt_tpu_torch.render import render_image

    width, height = (int(v) for v in args.size.split("x"))
    camera = getattr(scenes, {"topdown": "topdown_cam"}.get(args.camera, args.camera))(width, height)
    cfg = RenderConfig(
        width=width, height=height, samples_per_pixel=args.spp,
        max_depth=args.max_depth, seed=args.seed,
    )
    scene = build_scene(args.scene, camera, args.seed, args.texture_dir)
    print(f"Rendering a scene with {scene.num_prims} shapes", file=sys.stderr)

    if args.probe:
        from rt_tpu_torch.debug import debug_pixel

        x, y = (float(v) for v in args.probe.split(","))
        info = debug_pixel(scene, camera, x, y, cfg, device=args.device)
        print(json.dumps(info if info else {"miss": "hit the skybox"}, indent=2))
        return 0

    if args.progressive:
        from rt_tpu_torch.progressive import ProgressiveRenderer

        renderer = ProgressiveRenderer(
            scene, camera, cfg, checkpoint_path=args.checkpoint, metrics_path=args.metrics,
            progress=True, engine=args.engine, checkpoint_every=args.checkpoint_every,
            device=args.device,
        )
        server = term = None
        if args.serve is not None:
            from rt_tpu_torch.debug import debug_pixel
            from rt_tpu_torch.viewer import PreviewServer

            server = PreviewServer(
                args.serve,
                probe=lambda x, y: debug_pixel(scene, camera, x, y, cfg, device=args.device),
            ).start()
            print(f"preview at http://localhost:{server.port}", file=sys.stderr)
        if args.term_preview:
            from rt_tpu_torch.term_preview import TerminalPreview

            term = TerminalPreview()

        def on_sweep(image, metrics):
            if server is not None:
                server.update(image, metrics)
            if term is not None:
                term.update(image, {k: metrics[k] for k in ("pass", "total_spp", "mray_per_s")
                                    if k in metrics})

        try:
            image = renderer.run(max_passes=args.passes, on_sweep=on_sweep)
        finally:
            if server is not None:
                server.stop()
    else:
        image, metrics = render_image(scene, camera, cfg, device=args.device)
        print(json.dumps(metrics), file=sys.stderr)
    if args.out.endswith(".ppm"):
        write_ppm(args.out, image)
    else:
        write_png(args.out, image)
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
