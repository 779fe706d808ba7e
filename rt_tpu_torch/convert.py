"""Carry scenes, cameras, skies and scene parameters across from the JAX
package.

The functions take the JAX package's objects with their arrays already on
the host, e.g. ``jax.tree.map(np.asarray, scene)``, and read them by
attribute name only: this module imports neither JAX nor ``rt_tpu``.  The
result renders from the very tables the JAX package renders from.
"""

from __future__ import annotations

import numpy as np
import torch

from rt_tpu_torch.camera import Camera
from rt_tpu_torch.grad import SceneParams
from rt_tpu_torch.scene import (
    BVH_TABLES, CLUSTER_TABLES, TABLES, BvhArrays, ClusterData, SceneData, slot_ids,
)
from rt_tpu_torch.sky import SkyParams


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, copy=True))


def sky_from_arrays(sky) -> SkyParams:
    return SkyParams(
        sun_direction=_tensor(sky.sun_direction).to(torch.float32),
        turbidity=_tensor(sky.turbidity).to(torch.float32),
        exposure=_tensor(sky.exposure).to(torch.float32),
        hw_params=None if sky.hw_params is None else _tensor(sky.hw_params).to(torch.float32),
        cos_gamma_as_angle=bool(sky.cos_gamma_as_angle),
    )


def camera_from_arrays(camera) -> Camera:
    vec = lambda name: _tensor(getattr(camera, name)).to(torch.float32)
    return Camera(
        center=vec("center"),
        pixel00_loc=vec("pixel00_loc"),
        pixel_du=vec("pixel_du"),
        pixel_dv=vec("pixel_dv"),
        defocus_disk_u=vec("defocus_disk_u"),
        defocus_disk_v=vec("defocus_disk_v"),
        defocus_angle=float(np.asarray(camera.defocus_angle)),
        image_width=int(camera.image_width),
        image_height=int(camera.image_height),
    )


def params_from_arrays(p) -> SceneParams:
    """The port's SceneParams from the JAX package's, leaf by name."""
    return SceneParams(**{name: _tensor(getattr(p, name)).to(torch.float32)
                          for name in SceneParams._fields})


def _tables(obj, names) -> dict:
    return {name: None if getattr(obj, name) is None else _tensor(getattr(obj, name))
            for name in names}


def clusters_from_arrays(cl) -> ClusterData:
    """The port's ClusterData holding the JAX ClusterData's whole tables,
    shade table and ``n_sph_slots``; its slots' primitive ids are their slot
    ids (``scene.slot_ids``), so the walks keep the JAX kernels' ties."""
    tables = _tables(cl, CLUSTER_TABLES)
    sph_prim, tri_prim = slot_ids(tables["sph_slots"].shape[1], tables["tri_slots"].shape[1])
    return ClusterData(n_sph_slots=int(cl.n_sph_slots), sph_prim=sph_prim, tri_prim=tri_prim,
                       **tables)


def scene_from_arrays(scene) -> SceneData:
    """The port's SceneData holding the same tables, cluster tables and
    BVH arrays included."""
    return SceneData(
        sky=sky_from_arrays(scene.sky),
        num_spheres=int(scene.num_spheres),
        num_triangles=int(scene.num_triangles),
        has_image_textures=bool(scene.has_image_textures),
        clusters=None if scene.clusters is None else clusters_from_arrays(scene.clusters),
        bvh=None if scene.bvh is None else BvhArrays(*_tables(scene.bvh, BVH_TABLES).values()),
        **_tables(scene, TABLES),
    )
