"""Scene library: deterministic re-creations of the reference scenes.

Reference analog: scenes.rs — camera presets cam1/cam2/widecam/topdown
(scenes.rs:17-125) and scene factories (cover_scene, earth_scene,
gen_checkered, triangle_scene, generate_ground_plane).  The reference builds
scenes with unseeded ``thread_rng`` (scenes.rs:147); these take an explicit
seed and draw from numpy's ``default_rng`` in the JAX package's order, so
both packages build identical tables.

Asset textures: the reference embeds earth/mars/moon/saul images via
``include_bytes!`` (scenes.rs:150-153).  Procedural stand-ins are generated
by default (no binary assets in-repo); ``texture_dir`` loads real files.
"""

from __future__ import annotations

import os

import numpy as np

from rt_tpu_torch import profiling
from rt_tpu_torch.camera import Camera, make_camera
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.scene import SceneBuilder, SceneData
from rt_tpu_torch.sky import SkyParams

WIDTH = 800  # window.rs:29
HEIGHT = 600  # window.rs:30
MAX_DEPTH = 100  # scenes.rs:15

# The sizes of the last scene composed by ``cover_scene``, ``default_scene``
# or ``sponza_scene``: the lattice's grid cells, the spheres added (the
# three big ones and the lattice's kept) and the glTF's triangles.
COUNTS = {"lattice_cells": 0, "spheres": 0, "mesh_triangles": 0}


def cam1(width: int = WIDTH, height: int = HEIGHT) -> Camera:
    """scenes.rs:17-42: center (3,-5,0.6) looking at origin, z-up, vfov 20,
    focus at the lookat distance, no defocus."""
    center = np.array([3.0, -5.0, 0.6])
    lookat = np.zeros(3)
    return make_camera(
        center, lookat, (0.0, 0.0, 1.0),
        focus_distance=float(np.linalg.norm(center - lookat)),
        defocus_angle=0.0, image_width=width, image_height=height, vertical_fov=20.0,
    )


def cam2(width: int = WIDTH, height: int = HEIGHT) -> Camera:
    """scenes.rs:44-68: from (14,3,10), defocus 0.7deg, focus 16."""
    return make_camera(
        (14.0, 3.0, 10.0), (0.0, 0.0, 0.0), (0.0, 0.0, 1.0),
        focus_distance=16.0, defocus_angle=0.7,
        image_width=width, image_height=height, vertical_fov=20.0,
    )


def widecam(width: int = WIDTH, height: int = HEIGHT) -> Camera:
    """scenes.rs:70-95: from (-14,-10,7) at (0,0,5), vfov 40."""
    center = np.array([-14.0, -10.0, 7.0])
    lookat = np.array([0.0, 0.0, 5.0])
    return make_camera(
        center, lookat, (0.0, 0.0, 1.0),
        focus_distance=float(np.linalg.norm(center - lookat)),
        defocus_angle=0.0, image_width=width, image_height=height, vertical_fov=40.0,
    )


def topdown_cam(width: int = WIDTH, height: int = HEIGHT) -> Camera:
    """scenes.rs:97-125: from (0.1,0.1,20) looking down, defocus 0.7deg."""
    center = np.array([0.1, 0.1, 20.0])
    lookat = np.zeros(3)
    return make_camera(
        center, lookat, (0.0, 0.0, 1.0),
        focus_distance=float(np.linalg.norm(center - lookat)),
        defocus_angle=0.7, image_width=width, image_height=height, vertical_fov=20.0,
    )


def _procedural_texture(name: str, size: int = 64) -> np.ndarray:
    """Deterministic colorful stand-in for the reference's embedded planet
    textures (scenes.rs:150-158)."""
    y, x = np.mgrid[0:size, 0:size].astype(np.float32) / size
    if name == "earth":
        r = 0.2 + 0.3 * np.sin(6.28 * 3 * x) * np.cos(6.28 * 2 * y)
        g = 0.4 + 0.3 * np.cos(6.28 * 2 * x + 1.0)
        b = 0.6 + 0.3 * np.sin(6.28 * y * 2 + 0.5)
    elif name == "mars":
        r = 0.7 + 0.2 * np.sin(6.28 * 4 * x * y)
        g = 0.3 + 0.1 * np.cos(6.28 * 2 * y)
        b = 0.15 + 0.05 * np.sin(6.28 * x)
    elif name == "moon":
        v = 0.5 + 0.3 * np.sin(6.28 * 5 * x) * np.sin(6.28 * 5 * y)
        r = g = b = v
    else:  # "saul" stand-in: warm portrait-ish gradient
        r = 0.8 - 0.3 * y
        g = 0.6 - 0.2 * y + 0.1 * np.sin(6.28 * x)
        b = 0.4 + 0.2 * x * y
    return np.clip(np.stack([r, g, b], axis=-1), 0.0, 1.0).astype(np.float32)


def _load_or_procedural(name: str, texture_dir: str | None) -> np.ndarray:
    if texture_dir is not None:
        from rt_tpu_torch.io.png_io import load_image

        for ext in (".png", ".jpg", ".jpeg", ".webp"):
            path = os.path.join(texture_dir, name + ext)
            if os.path.exists(path):
                return load_image(path)
    return _procedural_texture(name)


def add_ground_plane(
    b: SceneBuilder, width: float, length: float, z: float, material: int, top_is_up: bool = True
) -> None:
    """Two triangles forming a ground quad (scenes.rs:310-342)."""
    hw, hl = width / 2.0, length / 2.0
    a = (-hw, -hl, z)
    bb = (hw, -hl, z)
    c = (hw, hl, z)
    d = (-hw, hl, z)
    if top_is_up:
        b.add_triangle(a, bb, c, material)
        b.add_triangle(a, c, d, material)
    else:  # reversed winding = opposite normal (hittable.rs:210-212)
        b.add_triangle(c, bb, a, material)
        b.add_triangle(d, c, a, material)


def cover_scene(
    grid_i: int = 11,
    grid_j: int = 11,
    camera: Camera | None = None,
    z: float = -0.2,
    seed: int = 0,
    with_ground: bool = True,
    texture_dir: str | None = None,
) -> SceneData:
    """The RTIOW cover scene (scenes.rs:146-238), deterministic: the big
    spheres and the lattice of ``add_cover_lattice`` over a checkered
    ground (main.rs:31-34)."""
    b = SceneBuilder()
    big = _cover_materials(b, texture_dir)
    if with_ground:
        _checkered_ground(b, z)
    spheres = add_cover_lattice(b, grid_i, grid_j, camera, z, seed, materials=big)
    COUNTS.update(lattice_cells=4 * grid_i * grid_j, spheres=spheres, mesh_triangles=0)
    return b.build(sky=SkyParams.default())


def _cover_materials(b: SceneBuilder, texture_dir: str | None = None) -> tuple[int, int, int]:
    """The big spheres' glass, metal and textured "saul" materials."""
    glass = b.dielectric(1.5)
    metal = b.metal_solid((0.7, 0.6, 0.5), None)
    saul = b.lambertian(b.image_texture(_load_or_procedural("saul", texture_dir)))
    return glass, metal, saul


def _checkered_ground(b: SceneBuilder, z: float) -> None:
    """The 10000 x 10000 ground quad at ``z`` under a 3.0-scale checker
    (main.rs:31-34)."""
    even = b.solid_color((0.1, 0.1, 0.1))
    odd = b.solid_color((0.95, 0.95, 0.95))
    add_ground_plane(b, 10000.0, 10000.0, z, b.lambertian(b.checker(3.0, even, odd)), True)


def add_cover_lattice(
    b: SceneBuilder,
    grid_i: int,
    grid_j: int,
    camera: Camera | None = None,
    z: float = -0.2,
    seed: int = 0,
    materials: tuple[int, int, int] | None = None,
) -> int:
    """Add the cover scene's spheres to ``b`` (scenes.rs:146-238); returns
    how many.

    Big spheres: glass at p1, metal at p3, textured "saul" sphere facing the
    camera at the top-left position (their ``materials``, created here when
    None).  Small spheres: a grid_i x grid_j lattice with random offsets,
    5%/15%/80% glass/metal/lambertian mix and collision avoidance around the
    big-sphere sites, drawn from ``default_rng(seed)``.  Above 2500 grid
    cells the spheres are drawn in bulk, as the JAX package draws them
    (another arrangement than the loop's for the same seed).  The span
    ``rt.scenes.lattice`` (args: the cells and the small spheres kept)
    holds the SceneBuilder's work after the draw.
    """
    glass, metal, saul = materials if materials is not None else _cover_materials(b)
    big_r = 0.7
    saul_loc = np.array([-1.0, 1.732, big_r + z])
    p1 = np.array([-1.0, -1.732, big_r + z])
    p2 = np.array([2.0, 0.0, big_r + z])
    p3 = np.array([-2.0, 0.0, big_r + z])
    p4 = np.array([1.0, 1.732, big_r + z])
    p5 = np.array([1.0, -1.732, big_r + z])
    big_sites = [p1, p2, p3, p4, saul_loc, p5]
    small = _draw_lattice(grid_i, grid_j, z, seed, big_sites, big_r)

    viewer = camera.center.numpy() if camera is not None else np.array([3.0, -5.0, 0.6])
    with profiling.span("scenes.lattice", f"cells={4 * grid_i * grid_j} spheres={len(small)}"):
        b.add_sphere(p1, big_r, glass)
        b.add_sphere(p3, big_r, metal)
        b.add_sphere(saul_loc, big_r, saul, front_direction=viewer)
        for center, choose, albedo, fuzz in small:
            if choose > 0.95:
                mat = b.dielectric(1.5)
            elif choose > 0.8:
                mat = b.metal_solid(albedo, fuzz)
            else:
                mat = b.lambertian_rgb(*albedo)
            b.add_sphere(center, 0.2, mat)
    return 3 + len(small)


def _draw_lattice(grid_i, grid_j, z, seed, big_sites, big_r) -> list[tuple]:
    """The lattice's kept spheres in order: (center, choose, albedo, fuzz),
    fuzz drawn only where the sphere is metal in the loop's order."""
    rng = np.random.default_rng(seed)
    radius = 0.2
    collide = radius + big_r + 1.0
    out = []
    if grid_i * grid_j <= 2500:
        # Sequential generation, as the reference does (scenes.rs:198-236).
        for i in range(-grid_i, grid_i):
            for j in range(-grid_j, grid_j):
                albedo = rng.uniform(0.0, 1.0, 3)
                offset = np.array([rng.uniform(0.0, 0.9), rng.uniform(0.0, 0.9), z])
                center = np.array([float(i), float(j), radius]) + offset
                if any(np.linalg.norm(center - s) < collide for s in big_sites):
                    continue
                choose = rng.uniform(0.0, 1.0)
                fuzz = rng.uniform(0.0, 0.5) if 0.8 < choose <= 0.95 else None
                out.append((center, choose, albedo, fuzz))
        return out
    # Bulk generation for cover-large (rt_tpu/scenes.py:202-232): the same
    # distributions in another draw order.
    ii, jj = np.meshgrid(np.arange(-grid_i, grid_i), np.arange(-grid_j, grid_j), indexing="ij")
    n = ii.size
    albedo = rng.uniform(0.0, 1.0, (n, 3))
    offsets = np.stack([rng.uniform(0.0, 0.9, n), rng.uniform(0.0, 0.9, n), np.full(n, z)], -1)
    centers = np.stack([ii.ravel(), jj.ravel(), np.full(n, radius)], -1) + offsets
    keep = np.ones(n, bool)
    for site in big_sites:
        keep &= np.linalg.norm(centers - site, axis=-1) >= collide
    choose = rng.uniform(0.0, 1.0, n)
    fuzz = rng.uniform(0.0, 0.5, n)
    return [(centers[k], choose[k], albedo[k], fuzz[k]) for k in np.nonzero(keep)[0]]


def default_scene(
    camera: Camera,
    gltf_path: str,
    grid: int = 300,
    seed: int = 0,
    transform: np.ndarray | None = None,
    sky: SkyParams | None = None,
) -> SceneData:
    """What the upstream's ``cargo run`` renders (main.rs:27-57): the
    checkered ground, the cover scene's big spheres and ``grid x grid``
    lattice (``add_cover_lattice``; bulk-drawn above 2500 cells), and a glTF
    model through ``io.gltf_loader.add_gltf_to_scene`` with the upstream's
    own material mapping (``Material::from_gltf``, material.rs:20-33: every
    part metal, fuzz = roughness), placed by ``transform``'s linear part
    (as ``scale_rotate_mat`` gives it).  ``sky`` defaults to the live
    Hosek-Wilkie sky at ``SkyParams.hosek()``'s defaults.  Span
    ``rt.scenes.default``; ``COUNTS`` gets the composition's sizes."""
    from rt_tpu_torch.io.gltf_loader import add_gltf_to_scene

    z = -0.2
    with profiling.span("scenes.default"):
        b = SceneBuilder()
        _checkered_ground(b, z)
        spheres = add_cover_lattice(b, grid, grid, camera, z, seed)
        triangles = add_gltf_to_scene(b, gltf_path, compat_all_metal=True, transform=transform)
        COUNTS.update(lattice_cells=4 * grid * grid, spheres=spheres, mesh_triangles=triangles)
        return b.build(sky=sky if sky is not None else SkyParams.hosek())


def sponza_scene(gltf_path: str, *, sky: SkyParams | None = None) -> SceneData:
    """The upstream's ``sponza()`` (scenes.rs:443-458): the Sponza atrium's
    glTF at ``gltf_path`` through ``io.gltf_loader.add_gltf_to_scene``, alone
    below ``sky`` (the default: the live Hosek-Wilkie sky at
    ``SkyParams.hosek()``'s defaults, its sun overhead, falling through the
    open roof).  Its materials take the corrected glTF mapping (metallic
    >= 0.5 is metal, else lambertian: Sponza's stone and fabric are not
    mirrors).  Span ``rt.scenes.sponza``;
    ``COUNTS["mesh_triangles"]`` gets the triangles."""
    from rt_tpu_torch.io.gltf_loader import add_gltf_to_scene

    with profiling.span("scenes.sponza"):
        b = SceneBuilder()
        triangles = add_gltf_to_scene(b, gltf_path, compat_all_metal=False)
        COUNTS.update(lattice_cells=0, spheres=0, mesh_triangles=triangles)
        return b.build(sky=sky if sky is not None else SkyParams.hosek())


def earth_scene(texture_dir: str | None = None) -> SceneData:
    """scenes.rs:127-138: one textured lambertian sphere."""
    b = SceneBuilder()
    mat = b.lambertian(b.image_texture(_load_or_procedural("earth", texture_dir)))
    b.add_sphere((0.0, 0.0, 0.0), 2.0, mat)
    return b.build()


def gen_checkered() -> SceneData:
    """scenes.rs:240-260: two giant checkered spheres."""
    b = SceneBuilder()
    even = b.solid_color((0.2, 0.3, 0.1))
    odd = b.solid_color((0.9, 0.9, 0.9))
    mat = b.lambertian(b.checker(0.31, even, odd))
    b.add_sphere((0.0, -10.0, 0.0), 10.0, mat)
    b.add_sphere((0.0, 10.0, 0.0), 10.0, mat)
    return b.build()


def triangle_scene(texture_dir: str | None = None) -> SceneData:
    """scenes.rs:262-308: two checkered triangles, an earth ball, and a
    textured triangle."""
    b = SceneBuilder()
    c1e = b.solid_color((1.0, 0.0, 0.0))
    c1o = b.solid_color((0.0, 0.0, 1.0))
    mat1 = b.lambertian(b.checker(0.31, c1e, c1o))
    c2e = b.solid_color((0.2, 0.3, 0.1))
    c2o = b.solid_color((0.9, 0.9, 0.9))
    mat2 = b.lambertian(b.checker(0.31, c2e, c2o))
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), mat1)
    b.add_triangle((1, 0, 0), (0, 0, 0), (0, 0, 1), mat2)
    earth_mat = b.lambertian(b.image_texture(_load_or_procedural("earth", texture_dir)))
    b.add_sphere((0.4, 0.4, 0.4), 0.3, earth_mat)
    saul_mat = b.lambertian(b.image_texture(_load_or_procedural("saul", texture_dir)))
    b.add_triangle((0, 0, 0), (0, 1, 0), (0, 0, 1), saul_mat)
    return b.build()


def textured_spheres_scene(texture_dir: str | None = None) -> SceneData:
    """Spheres exercising every texture/material kind — checkered ground
    sphere, an image-textured globe, clear and frosted glass, fuzzy metal
    (frosted dielectric: material.rs:138-143)."""
    b = SceneBuilder()
    even = b.solid_color((0.2, 0.3, 0.1))
    odd = b.solid_color((0.9, 0.9, 0.9))
    checker_mat = b.lambertian(b.checker(0.31, even, odd))
    b.add_sphere((0.0, 0.0, -1000.0), 999.8, checker_mat)

    earth_mat = b.lambertian(b.image_texture(_load_or_procedural("earth", texture_dir)))
    b.add_sphere((0.0, 0.0, 0.5), 0.7, earth_mat, front_direction=(3.0, -5.0, 0.6))

    glass = b.dielectric(1.5)
    b.add_sphere((-1.6, 0.3, 0.4), 0.6, glass)
    frosted = b.dielectric(1.5, 0.15)
    b.add_sphere((1.6, 0.3, 0.4), 0.6, frosted)
    fuzzy_metal = b.metal_solid((0.8, 0.7, 0.5), 0.25)
    b.add_sphere((0.0, 1.8, 0.4), 0.6, fuzzy_metal)
    return b.build()


def scale_rotate_mat(
    roll_degrees: float,
    pitch_degrees: float,
    yaw_degrees: float,
    scalefactor: float,
) -> np.ndarray:
    """The reference's mesh placement matrix (scenes.rs:460-475).

    nalgebra semantics replicated exactly, including the quirk that the
    "roll" argument also rotates about Z (``from_euler_angles(0, 0, roll)``
    is a Z rotation): rotation = Ry(pitch) @ Rz(yaw) @ Rz(roll), and the
    whole homogeneous matrix is scaled by ``scalefactor``.  Consumers apply
    only the linear 3x3 part (Triangle::transform -> transform_vector,
    hittable.rs:214-227), so the uniform scale survives and the (zero)
    translation column is ignored.
    """

    def rz(deg):
        r = np.deg2rad(deg)
        c, s = np.cos(r), np.sin(r)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float64)

    def ry(deg):
        r = np.deg2rad(deg)
        c, s = np.cos(r), np.sin(r)
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)

    rotation = ry(pitch_degrees) @ rz(yaw_degrees) @ rz(roll_degrees)
    m = np.eye(4, dtype=np.float64)
    m[:3, :3] = rotation
    return (m * scalefactor).astype(np.float32)


# The reference's five mesh slots: (obj filename stem, style, transform)
# in its exact order (scenes.rs:368-381).
MESH_SCENE_SLOTS = (
    ("bimba", "red_metal", (0.0, 90.0, 90.0, 12.0)),
    ("stanford-bunny", "plaster", (0.0, 90.0, 90.0, 12.0)),
    ("teapot", "metal", (0.0, -90.0, -90.0, 0.6)),
    ("Nefertiti", "frosted_glass", (90.0, 0.0, 0.0, 0.02)),
    ("armadillo", "metal", None),
)


def mesh_scene_reference(obj_dir: str, missing_ok: bool = True) -> SceneData:
    """Reference-parity ``mesh_scene`` (scenes.rs:344-393): the five classic
    meshes with their per-mesh materials and ``scale_rotate_mat`` placements
    (bimba/bunny upright at 12x, teapot at 0.6x, Nefertiti at 0.02x,
    armadillo untransformed) over the 0.75-scale checker ground.

    ``obj_dir`` holds ``<stem>.obj`` files; with ``missing_ok`` absent
    meshes are skipped (the reference would panic — TODO.md:69).
    """
    from rt_tpu_torch.io.obj_loader import load_obj

    b = SceneBuilder()
    even = b.solid_color((0.1, 0.1, 0.1))
    odd = b.solid_color((0.95, 0.95, 0.95))
    checker_mat = b.lambertian(b.checker(0.75, even, odd))
    add_ground_plane(b, 10000.0, 10000.0, -0.2, checker_mat, True)

    styles = {
        "plaster": lambda: b.lambertian_rgb(0.95, 0.70, 0.85),
        "frosted_glass": lambda: b.dielectric(1.5, 0.05),
        "metal": lambda: b.metal_solid((0.8, 0.8, 0.8), 0.4),
        "red_metal": lambda: b.metal_solid((0.0, 0.5, 0.8), 0.3),
    }
    for stem, style, srm in MESH_SCENE_SLOTS:
        path = os.path.join(obj_dir, stem + ".obj")
        if not os.path.exists(path):
            if missing_ok:
                continue
            raise FileNotFoundError(path)
        mat = styles[style]()
        transform = scale_rotate_mat(*srm) if srm is not None else None
        for model in load_obj(path):
            b.add_triangles(model["vertices"], model["uvs"], mat, transform=transform)
    return b.build()


def mesh_scene(
    obj_paths: dict[str, str],
    seed: int = 0,
) -> SceneData:
    """OBJ showcase (reference analog: mesh_scene, scenes.rs:344-393 — five
    classic meshes with plaster/metal/frosted-glass materials).

    ``obj_paths`` maps a material style ('plaster' | 'glass' |
    'frosted_glass' | 'metal' | 'mirror' | 'red_metal') to an OBJ path;
    unknown styles get the dull-gray metal.  A checkered ground plane is
    included (scenes.rs:353-356).
    """
    from rt_tpu_torch.io.obj_loader import load_obj

    b = SceneBuilder()
    even = b.solid_color((0.1, 0.1, 0.1))
    odd = b.solid_color((0.95, 0.95, 0.95))
    checker_mat = b.lambertian(b.checker(0.75, even, odd))
    add_ground_plane(b, 10000.0, 10000.0, -0.2, checker_mat, True)

    styles = {
        "plaster": lambda: b.lambertian_rgb(0.95, 0.70, 0.85),
        "glass": lambda: b.dielectric(1.5),
        "frosted_glass": lambda: b.dielectric(1.5, 0.05),
        "metal": lambda: b.metal_solid((0.8, 0.8, 0.8), 0.4),
        "mirror": lambda: b.metal_solid((0.95, 0.95, 0.95), None),
        "red_metal": lambda: b.metal_solid((0.0, 0.5, 0.8), 0.3),
    }
    for style, path in obj_paths.items():
        mat = styles.get(style, styles["metal"])()
        for model in load_obj(path):
            b.add_triangles(model["vertices"], model["uvs"], mat)
    return b.build()


def mesh_with_area_light(
    obj_path: str,
    light_radiance=(6.0, 6.0, 5.5),
    mesh_style: str = "plaster",
) -> SceneData:
    """Mesh lit by an emissive quad panel (BASELINE config 3 shape: "OBJ
    mesh via BVH traversal with emissive area light").  The emissive
    material is an rt_tpu extension — the reference's only light is its
    sky (SURVEY.md §2)."""
    from rt_tpu_torch.io.obj_loader import load_obj

    b = SceneBuilder()
    even = b.solid_color((0.1, 0.1, 0.1))
    odd = b.solid_color((0.95, 0.95, 0.95))
    checker_mat = b.lambertian(b.checker(0.75, even, odd))
    add_ground_plane(b, 10000.0, 10000.0, -0.2, checker_mat, True)

    mat = {
        "plaster": lambda: b.lambertian_rgb(0.95, 0.70, 0.85),
        "metal": lambda: b.metal_solid((0.8, 0.8, 0.8), 0.2),
        "glass": lambda: b.dielectric(1.5),
    }.get(mesh_style, lambda: b.lambertian_rgb(0.9, 0.9, 0.9))()
    for model in load_obj(obj_path):
        b.add_triangles(model["vertices"], model["uvs"], mat)

    light = b.emissive(light_radiance)
    # Overhead panel, normal facing down toward the scene.
    b.add_triangle((-1.5, -1.5, 4.0), (1.5, -1.5, 4.0), (0.0, 1.5, 4.0), light)
    b.add_triangle((0.0, 1.5, 4.0), (1.5, -1.5, 4.0), (-1.5, -1.5, 4.0), light)
    return b.build()


def bench_cover_config() -> tuple[SceneData, Camera, RenderConfig]:
    """The benchmark configuration: RTIOW cover scene, ~480 spheres and 2
    ground triangles, 400x225 @ 10 spp, max depth 50."""
    camera = cam1(400, 225)
    scene = cover_scene(11, 11, camera, z=-0.2, seed=0)
    cfg = RenderConfig(width=400, height=225, samples_per_pixel=10, max_depth=50)
    return scene, camera, cfg
