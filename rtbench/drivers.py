"""The system under test: how the benchmark builds the program's scene from
the generated inputs and drives its entry points, one unit of work at a
time.  The only module of the benchmark that imports the program.

Entries (a traffic file's ``entry``):

- ``frames``: ``render.render_image`` of the whole frame at the traffic's
  spp, the frame's render seed drawn from the run's seed; a unit ends with
  the image on the host.
- ``sweeps``: ``progressive.ProgressiveRenderer.step`` on the traffic's
  engine ("mega" or "wavefront"), sweeps of ``sweep_spp`` samples with the
  reference's sample indices; a fresh image with the next seed starts
  every ``sweeps_per_image`` sweeps; no checkpoint.  A unit ends with the
  sweep added to the host's accumulator.
"""

from __future__ import annotations

import contextlib
import os
import time

import numpy as np
import torch

from rtbench.inputs import car as car_inputs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _port_sky(sky: dict):
    from rt_tpu_torch.sky import SkyParams

    if sky["model"] == "hosek":
        return SkyParams.hosek(turbidity=sky["turbidity"], albedo=sky["albedo"],
                               elevation=sky["elevation"], sun_direction=sky.get("sun"),
                               exposure=sky["exposure"])
    return SkyParams(sun_direction=torch.tensor(sky["sun"], dtype=torch.float32),
                     turbidity=torch.tensor(float(sky["turbidity"])),
                     exposure=torch.tensor(float(sky["exposure"])))


def _replay(b, desc: dict) -> None:
    """Create the description's textures, materials, spheres and triangles on
    a SceneBuilder in their order, so that every id is the description's."""
    for t in desc["textures"]:
        if t["kind"] == "solid":
            b.solid_color(t["color"])
        elif t["kind"] == "checker":
            b.checker(t["scale"], t["even"], t["odd"])
        else:
            b.image_texture(t["image"])
    for m in desc["materials"]:
        if m["kind"] == "lambertian":
            b.lambertian(m["texture"])
        elif m["kind"] == "metal":
            b.metal(m["texture"], m.get("fuzz", 0.0))
        elif m["kind"] == "dielectric":
            b.dielectric(m["ior"], m.get("fuzz", 0.0))
        else:
            raise ValueError(f"no replay for material {m['kind']!r}")
    sph, tri = desc["spheres"], desc["triangles"]
    for c, r, f, m in zip(sph["center"], sph["radius"], sph["front"], sph["material"]):
        b.add_sphere(c, r, int(m), front_direction=f)
    for a, bb, c, uv, m in zip(tri["a"], tri["b"], tri["c"], tri["uv"], tri["material"]):
        b.add_triangle(a, bb, c, int(m), uv[0], uv[1], uv[2])


def glb_path(scene_cfg: dict) -> str:
    """The car's glb under the checkout's ``build/rtbench/`` (a fixed
    name per generator parameters, written once)."""
    name = f"car_r{scene_cfg['res']}_p{scene_cfg['n_parts']}_s{scene_cfg['seed']}.glb"
    return os.path.join(ROOT, "build", "rtbench", name)


def ensure_inputs(config: dict) -> None:
    """Write the files the program loads (the car's glb) if missing."""
    sc = config["scene"]
    if sc["generator"] == "car":
        path = glb_path(sc)
        if not os.path.exists(path):
            car_inputs.write_glb(path, sc["res"], sc["n_parts"], sc["seed"])


def build_scene(config: dict, desc_fn, timings: dict):
    """(scene, camera, RenderConfig) of the program for ``config``, the scene
    built through ``scene.SceneBuilder`` (and the glTF loader, for a glTF
    scene); ``timings["scene_build_s"]`` gets the host seconds of the load
    and the build."""
    from rt_tpu_torch import scenes
    from rt_tpu_torch.camera import make_camera
    from rt_tpu_torch.config import RenderConfig
    from rt_tpu_torch.io.gltf_loader import add_gltf_to_scene
    from rt_tpu_torch.scene import SceneBuilder

    sc = config["scene"]
    if sc["generator"] == "car":
        sky = _port_sky(sc["sky"])
        g = sc["ground"]
        t0 = time.perf_counter()
        b = SceneBuilder()
        ground = b.lambertian(b.checker(g["scale"], b.solid_color(g["even"]),
                                        b.solid_color(g["odd"])))
        scenes.add_ground_plane(b, g["size"], g["size"], g["z"], ground, True)
        add_gltf_to_scene(b, glb_path(sc), compat_all_metal=False)
        scene = b.build(sky=sky)
        timings["scene_build_s"] = time.perf_counter() - t0
    else:
        desc = desc_fn()
        t0 = time.perf_counter()
        b = SceneBuilder()
        _replay(b, desc)
        scene = b.build(sky=_port_sky(desc["sky"]))
        timings["scene_build_s"] = time.perf_counter() - t0
    cam = config["camera"]
    camera = make_camera(cam["center"], cam["lookat"], cam["up"],
                         focus_distance=cam["focus_distance"], defocus_angle=0.0,
                         image_width=config["width"], image_height=config["height"],
                         vertical_fov=cam["vfov"])
    cfg = RenderConfig(width=config["width"], height=config["height"],
                       max_depth=config["render"]["max_depth"])
    return scene, camera, cfg


class Frames:
    """``render.render_image`` frames at ``traffic["spp"]``."""

    kind = "frames"

    def __init__(self, scene, camera, cfg, traffic: dict, device):
        self.scene, self.camera, self.cfg, self.device = scene, camera, cfg, device
        self.spp = int(traffic["spp"])
        self.samples = self.spp * camera.image_width * camera.image_height

    def unit(self, seed: int):
        """(camera samples, failed units, answer (seed, image f32[H, W, 3]))."""
        from rt_tpu_torch.render import render_image

        img, _ = render_image(self.scene, self.camera, self.cfg.replace(seed=seed),
                              device=self.device, spp=self.spp)
        return self.samples, int(not np.isfinite(img).all()), (seed, img)

    def close(self):
        return 0, None


class Sweeps:
    """``ProgressiveRenderer.step`` sweeps; a fresh image every
    ``sweeps_per_image`` sweeps, its seed the next of ``image_seed``."""

    kind = "sweeps"

    def __init__(self, scene, camera, cfg, traffic: dict, device, image_seed):
        from rt_tpu_torch.config import ProgressiveSchedule

        self.scene, self.camera, self.cfg, self.device = scene, camera, cfg, device
        self.engine = traffic["engine"]
        self.ns = int(traffic["sweep_spp"])
        self.per_image = int(traffic["sweeps_per_image"])
        self.schedule = ProgressiveSchedule(ramp=(self.ns,) * self.per_image, sustain_64=0,
                                            sustain_128=0, sustain_256=0)
        self.samples = self.ns * camera.image_width * camera.image_height
        self.image_seed = image_seed
        self.images = 0
        self.pr = None
        self.seed = None
        self._null = open(os.devnull, "w")

    def _finish_image(self) -> int:
        """Sweeps of the image that just ended whose accumulator is not
        finite (all of them, or none)."""
        if self.pr is None:
            return 0
        return 0 if np.isfinite(self.pr.state.accum).all() else self.pr.state.pass_index

    def unit(self, _seed: int):
        from rt_tpu_torch.progressive import ProgressiveRenderer

        bad = 0
        if self.pr is None or self.pr.state.pass_index >= self.per_image:
            bad = self._finish_image()
            self.seed = self.image_seed(self.images)
            self.images += 1
            self.pr = ProgressiveRenderer(self.scene, self.camera, self.cfg.replace(seed=self.seed),
                                          schedule=self.schedule, engine=self.engine,
                                          device=self.device)
            if self.pr.engine != self.engine:
                raise RuntimeError(f"the {self.engine} engine cannot take this scene")
        with contextlib.redirect_stdout(self._null):
            self.pr.step()
        return self.samples, bad, None

    def close(self):
        """(failed sweeps of the last image, the answer to check: (seed,
        sweeps, sweep spp, image f32[H, W, 3]))."""
        self._null.close()
        if self.pr is None:
            return 0, None
        st = self.pr.state
        return self._finish_image(), (self.seed, st.pass_index, self.ns, st.image)


def make_driver(config: dict, traffic: dict, scene, camera, cfg, device, image_seed):
    entry = traffic["entry"]
    if entry == "frames":
        return Frames(scene, camera, cfg, traffic, device)
    if entry == "sweeps":
        return Sweeps(scene, camera, cfg, traffic, device, image_seed)
    raise ValueError(f"unknown entry {entry!r}")
