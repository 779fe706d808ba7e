"""Differentiable rendering: scene parameters, pixel losses, gradients.

Counterpart of rt_tpu/grad.py.  The forward renderer is a function of the
scene parameters, so reverse-mode pixel gradients flow to material fuzz
and IOR, texture colors, the texture atlas and the sky (sun direction,
turbidity, exposure).  ``SceneParams`` names exactly the leaves a gradient
step may touch; geometry is excluded, as in the JAX package (visibility
discontinuities bias bare AD gradients with respect to it).

``pixel_grad`` is torch autograd over ``render_chunk(differentiable=True)``:
each bounce's winner search runs on detached rays (on the card, K2 on a
scene with a shade table and no BVH, the BVH walk kernel on a mesh), and
every backward step is deterministic, so two calls give bit-identical
gradients.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rt_tpu_torch import nearest_ops
from rt_tpu_torch.bvh import traverse
from rt_tpu_torch.camera import Camera
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.render import render_chunk
from rt_tpu_torch.scene import TABLES, SceneData


class SceneParams(NamedTuple):
    """The differentiable subset of SceneData."""

    tex_color: torch.Tensor
    atlas: torch.Tensor
    mat_fuzz: torch.Tensor
    mat_ior: torch.Tensor
    sky_sun_direction: torch.Tensor
    sky_turbidity: torch.Tensor
    sky_exposure: torch.Tensor


def get_params(scene: SceneData) -> SceneParams:
    return SceneParams(
        tex_color=scene.tex_color,
        atlas=scene.atlas,
        mat_fuzz=scene.mat_fuzz,
        mat_ior=scene.mat_ior,
        sky_sun_direction=scene.sky.sun_direction,
        sky_turbidity=scene.sky.turbidity,
        sky_exposure=scene.sky.exposure,
    )


def set_params(scene: SceneData, p: SceneParams) -> SceneData:
    """A new SceneData holding ``p``'s tensors and sharing every other
    table with ``scene`` (the cluster tables and the BVH too), which is
    left as it was.  The sky keeps its static fields (``hw_params``,
    ``cos_gamma_as_angle``)."""
    tables = {name: getattr(scene, name) for name in TABLES}
    tables.update(tex_color=p.tex_color, atlas=p.atlas, mat_fuzz=p.mat_fuzz, mat_ior=p.mat_ior)
    sky = scene.sky.replace(
        sun_direction=p.sky_sun_direction,
        turbidity=p.sky_turbidity,
        exposure=p.sky_exposure,
    )
    return SceneData(
        sky=sky,
        num_spheres=scene.num_spheres,
        num_triangles=scene.num_triangles,
        has_image_textures=scene.has_image_textures,
        clusters=scene.clusters,
        bvh=scene.bvh,
        **tables,
    )


def pixel_loss(
    params: SceneParams,
    scene: SceneData,
    camera: Camera,
    cfg: RenderConfig,
    pixel_idx: torch.Tensor,
    target: torch.Tensor,
    key: np.ndarray,
    spp: int = 1,
    *,
    sphere_nearest=nearest_ops.sphere_nearest,
    bvh_walk=traverse.bvh_walk,
) -> torch.Tensor:
    """MSE between rendered pixels and ``target`` f32[P,3], differentiable
    with respect to ``params`` through the bounces.  ``key`` is an rng.key;
    ``sphere_nearest`` is K2 and ``bvh_walk`` the BVH walk (see
    geometry)."""
    s = set_params(scene, params)
    colors = render_chunk(s, camera, pixel_idx, cfg, spp, 0, key, differentiable=True,
                          sphere_nearest=sphere_nearest, bvh_walk=bvh_walk)
    return torch.mean((colors - target) ** 2)


def pixel_grad(
    scene: SceneData,
    camera: Camera,
    cfg: RenderConfig,
    pixel_idx: torch.Tensor,
    target: torch.Tensor,
    key: np.ndarray,
    spp: int = 1,
    *,
    sphere_nearest=nearest_ops.sphere_nearest,
    bvh_walk=traverse.bvh_walk,
) -> tuple[torch.Tensor, SceneParams]:
    """(loss, dloss/dparams) at the scene's parameters, as
    ``jax.value_and_grad`` of ``pixel_loss`` gives them.  A leaf the loss
    does not reach (the atlas of a scene without image textures, turbidity
    under a Hosek sky) gets zeros."""
    params = SceneParams(*(leaf.detach().requires_grad_() for leaf in get_params(scene)))
    loss = pixel_loss(params, scene, camera, cfg, pixel_idx, target, key, spp,
                      sphere_nearest=sphere_nearest, bvh_walk=bvh_walk)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
    return loss.detach(), SceneParams(*grads)


def finite_difference_grad(
    loss_fn, params: SceneParams, leaf: str, index: tuple, eps: float = 1e-3
) -> float:
    """Central finite difference of ``loss_fn`` with respect to one scalar
    entry of one leaf (the gradient-correctness harness)."""
    base = getattr(params, leaf)

    def bumped(sign):
        arr = base.detach().clone()
        arr[index] += sign * eps
        return params._replace(**{leaf: arr})

    with torch.no_grad():
        lo = loss_fn(bumped(-1.0))
        hi = loss_fn(bumped(+1.0))
    return float((hi - lo) / (2.0 * eps))
