"""Scale-out over ``torch.distributed``: pixel tiles and sample shards
(rt_tpu/parallel.py).

The reference's only parallelism is Rayon work-stealing over pixels and
samples on one machine (window.rs:270, camera.rs:317).  Here, as in the
JAX package, ranks form a 2-D ('tiles', 'spp') ``DeviceMesh``:

- **tiles**: pixel-tile data parallelism.  The forward sweep needs no
  communication until image assembly (an ``all_gather`` over the tiles).
- **spp**: sample parallelism.  The per-pixel sample mean becomes an
  ``all_reduce`` over the rank's spp group.

Every entry point is a pure per-shard function plus one collective step,
so one process can run every shard of a mesh and assemble them (the CPU
tests do), and a run on several ranks differs from that only in the
collectives:

- ``render_sharded``: ``render_shard`` (a rank's partial sample sums),
  then ``all_reduce`` over spp and ``all_gather`` over tiles;
- ``render_sharded_wavefront``: ``wavefront_shard`` (the persistent
  wavefront, K3 or K4 on the card, over the rank's pixels), then a gather;
- ``render_sharded_megakernel``: ``megakernel_shard`` (K1 or K5 over the
  rank's contiguous pixel range), then a gather;
- ``train_step_sharded``: ``train_shard`` (differentiable partial sums),
  a differentiable ``all_reduce`` over spp, the squared error of the
  rank's tile, its backward pass, then an ``all_reduce`` of the gradients
  and the SGD step ``p - lr * g``.  The parameters are replicated.

The layouts are the JAX package's, so a shard's rows draw what they draw
there.  ``render_sharded`` and ``train_step_sharded`` trace one batch whose
rows are the outer product of the padded pixel ids ``arange(n + (-n) % t)``
(the out-of-range ids are traced and dropped at the end) and the padded
samples ``arange(spp + (-spp) % s)``: row (p, s) is ``p * S_pad + s``, and
``render_chunk(work=...)`` keys every draw on that global row, so the rows
a shard traces draw as they do in the whole batch; the mean is taken over
``spp + pad`` samples (rt_tpu/parallel.py:120).  The wavefront and the
megakernels key on ``sample * W * H + pixel`` already.  A tile mesh
therefore renders the single shard's image bit for bit; a mesh with an spp
axis adds the partial sums in another order.

Backends: NCCL for one rank a card; gloo on the CPU, and for several ranks
on one card (NCCL refuses two ranks on one GPU), where gloo's collectives
take the CUDA tensors.  ``initialize_multihost`` joins a group;
``dryrun_multichip`` (graft_entry.py) spawns one.
"""

from __future__ import annotations

import os
import socket

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from rt_tpu_torch import grad as grad_mod
from rt_tpu_torch import megakernel, rng
from rt_tpu_torch.camera import Camera
from rt_tpu_torch.config import RenderConfig
from rt_tpu_torch.render import _device, render_chunk
from rt_tpu_torch.scene import SceneData
from rt_tpu_torch.wavefront import render_wavefront


def initialize_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    backend: str = "nccl",
) -> None:
    """Join the process group (``jax.distributed.initialize`` in the JAX
    package).  ``coordinator_address`` is "host:port" of rank 0
    (``init_method="tcp://..."``); without it the launcher's environment is
    read (``torchrun``: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE).
    ``backend`` "nccl" takes one card a rank (LOCAL_RANK, or the rank,
    modulo the cards); "gloo" is for the CPU and for several ranks on one
    card.  Call once per process, before ``make_mesh``."""
    init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    dist.init_process_group(
        backend, init_method=init,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
    )
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank()))
        torch.cuda.set_device(local % torch.cuda.device_count())


def free_port() -> int:
    """A free TCP port on localhost, for a group's coordinator address."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def make_mesh(n_devices: int | None = None, tiles: int | None = None) -> DeviceMesh:
    """('tiles', 'spp') mesh over ranks 0..n_devices-1 (all ranks by
    default), rank ``i * spp + j`` at (i, j).  With no ``tiles``, every
    rank is on the tiles axis (the common render layout).  Every rank of
    the group calls it; ranks outside the mesh get no coordinate."""
    world = dist.get_world_size()
    n = n_devices if n_devices is not None else world
    t = tiles if tiles is not None else n
    if t < 1 or n % t or n > world:
        raise ValueError(f"{n} of {world} ranks cannot form a ({t}, {n // max(t, 1)}) mesh")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.arange(n).reshape(t, n // t),
                      mesh_dim_names=("tiles", "spp"))


# -- per-shard functions (no process group) ------------------------------------------


def _padded(n: int, parts: int) -> int:
    return n + (-n) % parts


def _shard_sums(scene, camera, cfg, mesh_shape, coord, spp, key, differentiable,
                pixel_idx=None) -> torch.Tensor:
    """Partial sample sums f32[P_tile, 3] of mesh shard ``coord`` = (tile,
    spp shard): its pixel positions (a contiguous tile of the padded
    positions; ``pixel_idx`` maps positions to pixel ids, the identity by
    default) times its contiguous share of the padded samples, each row
    keyed on its global row ``position * S_pad + sample``."""
    t, s = mesh_shape
    n = camera.image_width * camera.image_height if pixel_idx is None else pixel_idx.shape[0]
    p_n, s_pad = _padded(n, t) // t, _padded(spp, s)
    s_n = s_pad // s
    device = scene.device
    pos = torch.arange(coord[0] * p_n, (coord[0] + 1) * p_n, device=device)
    s_lo = coord[1] * s_n
    pix = pos if pixel_idx is None else pixel_idx.to(device=device, dtype=torch.int64)[pos]
    work = (pos[:, None] * s_pad + torch.arange(s_lo, s_lo + s_n, device=device)[None, :])
    mean = render_chunk(scene, camera, pix, cfg, s_n, s_lo, key, differentiable,
                        work=work.reshape(-1))
    return mean * s_n


def render_shard(scene: SceneData, camera: Camera, cfg: RenderConfig, mesh_shape, coord,
                 spp: int, key) -> torch.Tensor:
    """A rank's share of ``render_sharded``: partial sample sums f32[P_tile,
    3] of its pixel tile over its samples, on the scene's device."""
    return _shard_sums(scene, camera, cfg, mesh_shape, coord, spp, key, False)


def assemble_render(tile_sums, camera: Camera, spp: int, mesh_shape) -> torch.Tensor:
    """The frame f32[H, W, 3] from every tile's sums over all its samples,
    in tile order: the mean over the padded sample count, the padded
    pixels dropped."""
    w, h = camera.image_width, camera.image_height
    colors = torch.cat(list(tile_sums)) / _padded(spp, mesh_shape[1])
    return colors[: w * h].reshape(h, w, 3)


def wavefront_shard(scene: SceneData, camera: Camera, cfg: RenderConfig, n_shards: int,
                    rank: int, spp: int, key) -> torch.Tensor:
    """Shard ``rank`` of ``render_sharded_wavefront``: the persistent
    wavefront over the rank's contiguous slice of the pixel ids, padded
    with pixel 0 to a multiple of ``n_shards`` (rt_tpu/parallel.py:182-188).
    Returns f32[slice, 3]."""
    n = camera.image_width * camera.image_height
    chunk = _padded(n, n_shards) // n_shards
    ids = torch.arange(rank * chunk, (rank + 1) * chunk, device=scene.device)
    ids = torch.where(ids < n, ids, 0).to(torch.int32)
    return render_wavefront(scene, camera, ids, cfg, spp, 0, key)


def megakernel_range(n_pixels: int, n_shards: int, rank: int) -> tuple[int, int]:
    """(first pixel, pixel count) of shard ``rank``: contiguous ranges whose
    sizes differ by at most one, for any frame size."""
    lo, hi = rank * n_pixels // n_shards, (rank + 1) * n_pixels // n_shards
    return lo, hi - lo


def megakernel_shard(scene: SceneData, camera: Camera, cfg: RenderConfig, n_shards: int,
                     rank: int, spp: int, key) -> torch.Tensor:
    """Shard ``rank`` of ``render_sharded_megakernel``: K1 or K5 (their plain
    versions on the CPU) over the rank's contiguous pixel range.  Returns
    f32[count, 3]."""
    base, count = megakernel_range(camera.image_width * camera.image_height, n_shards, rank)
    if count == 0:
        return torch.zeros((0, 3), device=scene.device)
    return megakernel.render_megakernel(scene, camera, cfg, spp, 0, rng.key_seed(key),
                                        pixel_base=base, n_pixels=count)


def train_shard(params: grad_mod.SceneParams, scene: SceneData, camera: Camera,
                cfg: RenderConfig, mesh_shape, coord, pixel_idx: torch.Tensor, spp: int,
                key) -> torch.Tensor:
    """A rank's share of ``train_step_sharded``: differentiable partial
    sample sums f32[P_tile, 3] (``cfg.diff_max_depth``) of its rows of
    ``pixel_idx`` under ``params``."""
    return _shard_sums(grad_mod.set_params(scene, params), camera, cfg, mesh_shape, coord, spp,
                       key, True, pixel_idx)


def tile_squared_error(sums: torch.Tensor, target: torch.Tensor, spp: int,
                       spp_shards: int) -> torch.Tensor:
    """Sum of (mean - target)^2 over a tile, the mean taken over the padded
    sample count."""
    return ((sums / _padded(spp, spp_shards) - target) ** 2).sum()


# -- the collective step ---------------------------------------------------------------


class _SumOverGroup(torch.autograd.Function):
    """``all_reduce`` (sum) over a group, with the identity as its backward
    pass.  Every rank of the group computes the same loss from the sum, so
    the gradient with respect to the sum is already the same on each rank
    and each passes it to its own partial sums; the gradients are summed
    over the mesh afterwards.  (``torch.distributed.nn.functional.
    all_reduce`` sums them in its backward pass too, which would count each
    tile's gradient once per rank of its spp group; it is also deprecated.)"""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad_out):
        return grad_out, None


def _member(mesh: DeviceMesh) -> tuple[tuple[int, int], tuple[int, int]]:
    """(mesh shape, this rank's coordinate)."""
    coord = mesh.get_coordinate()
    if coord is None:
        raise ValueError("this rank is not in the mesh")
    return tuple(mesh.shape), tuple(coord)


def _gather_mesh(x: torch.Tensor, mesh: DeviceMesh) -> list[torch.Tensor]:
    """Every rank's ``x`` (equal shapes), in rank order (tiles-major): a
    gather over the spp group, then over the tiles group."""
    t, s = mesh.shape
    parts = [torch.empty_like(x) for _ in range(s)]
    dist.all_gather(parts, x, group=mesh.get_group("spp"))
    row = torch.stack(parts)
    rows = [torch.empty_like(row) for _ in range(t)]
    dist.all_gather(rows, row, group=mesh.get_group("tiles"))
    return [part for r in rows for part in r]


def _sum_mesh(x: torch.Tensor, mesh: DeviceMesh) -> None:
    """In-place sum of ``x`` over every rank of the mesh."""
    dist.all_reduce(x, group=mesh.get_group("spp"))
    dist.all_reduce(x, group=mesh.get_group("tiles"))


def render_sharded(
    scene: SceneData,
    camera: Camera,
    cfg: RenderConfig,
    mesh: DeviceMesh,
    *,
    spp: int | None = None,
    key=None,
    device="cuda",
) -> torch.Tensor:
    """Full-frame render with pixels sharded over mesh axis 'tiles' and
    samples over 'spp' (``render_chunk``'s path: K2 on the card on a scene
    with a shade table and no BVH).  Returns f32[H, W, 3] on ``device``,
    the same on every rank."""
    spp = spp if spp is not None else cfg.samples_per_pixel
    key = key if key is not None else rng.key(cfg.seed)
    scene.to(_device(device))
    mesh_shape, coord = _member(mesh)
    sums = render_shard(scene, camera, cfg, mesh_shape, coord, spp, key)
    dist.all_reduce(sums, group=mesh.get_group("spp"))
    tiles = [torch.empty_like(sums) for _ in range(mesh_shape[0])]
    dist.all_gather(tiles, sums, group=mesh.get_group("tiles"))
    return assemble_render(tiles, camera, spp, mesh_shape)


def render_sharded_wavefront(
    scene: SceneData,
    camera: Camera,
    cfg: RenderConfig,
    mesh: DeviceMesh,
    *,
    spp: int | None = None,
    key=None,
    device="cuda",
) -> torch.Tensor:
    """The persistent wavefront over each rank's pixel slice (every rank of
    the mesh a slice), gathered: no collective until the image.  The draws
    key on the global (sample, pixel), so the image equals the single
    rank's bit for bit whatever the mesh.  Returns f32[H, W, 3]."""
    spp = spp if spp is not None else cfg.samples_per_pixel
    key = key if key is not None else rng.key(cfg.seed)
    scene.to(_device(device))
    (t, s), (i, j) = _member(mesh)
    colors = wavefront_shard(scene, camera, cfg, t * s, i * s + j, spp, key)
    w, h = camera.image_width, camera.image_height
    return torch.cat(_gather_mesh(colors, mesh))[: w * h].reshape(h, w, 3)


def render_sharded_megakernel(
    scene: SceneData,
    camera: Camera,
    cfg: RenderConfig,
    mesh: DeviceMesh,
    *,
    spp: int | None = None,
    key=None,
    device="cuda",
) -> torch.Tensor:
    """The production megakernel (K1, or K5 on a clustered scene) over each
    rank's contiguous pixel range, gathered.  Any frame splits into
    near-equal ranges (the JAX version asserts one 256-pixel tile a
    device, fault F4).  A pixel's result does not depend on the range it
    is in, so the image equals the single rank's bit for bit.  (The TPU
    knobs ``lanes`` and ``interpret`` have no counterpart.)  Returns
    f32[H, W, 3]."""
    spp = spp if spp is not None else cfg.samples_per_pixel
    key = key if key is not None else rng.key(cfg.seed)
    scene.to(_device(device))
    (t, s), (i, j) = _member(mesh)
    w, h = camera.image_width, camera.image_height
    n, n_shards = w * h, t * s
    colors = megakernel_shard(scene, camera, cfg, n_shards, i * s + j, spp, key)
    rows = -(-n // n_shards)
    padded = torch.zeros((rows, 3), device=colors.device)
    padded[: colors.shape[0]] = colors
    parts = _gather_mesh(padded, mesh)
    counts = [megakernel_range(n, n_shards, r)[1] for r in range(n_shards)]
    return torch.cat([p[:c] for p, c in zip(parts, counts)]).reshape(h, w, 3)


def train_step_sharded(
    scene: SceneData,
    camera: Camera,
    cfg: RenderConfig,
    mesh: DeviceMesh,
    pixel_idx: np.ndarray,
    target: np.ndarray,
    *,
    spp: int = 1,
    key=None,
    lr: float = 1e-2,
    device="cuda",
):
    """One inverse-rendering SGD step: the differentiable render of
    ``pixel_idx`` int[P] (P a multiple of the tiles) sharded over 'tiles'
    and its samples over 'spp', the MSE against ``target`` f32[P, 3], the
    gradients with respect to ``grad.SceneParams`` (replicated) summed over
    the mesh, and ``p - lr * g``.  Returns (loss, updated SceneData), the
    same on every rank."""
    key = key if key is not None else rng.key(cfg.seed)
    device = _device(device)
    scene.to(device)
    (t, s), coord = _member(mesh)
    n = len(pixel_idx)
    if n % t:
        raise ValueError(f"{n} pixels do not split into {t} tiles")
    pix = torch.as_tensor(np.asarray(pixel_idx), device=device)
    tile = slice(coord[0] * (n // t), (coord[0] + 1) * (n // t))
    target_tile = torch.as_tensor(np.asarray(target, np.float32)[tile], device=device)
    params = grad_mod.SceneParams(*(leaf.detach().requires_grad_()
                                    for leaf in grad_mod.get_params(scene)))
    sums = train_shard(params, scene, camera, cfg, (t, s), coord, pix, spp, key)
    sums = _SumOverGroup.apply(sums, mesh.get_group("spp"))
    sq = tile_squared_error(sums, target_tile, spp, s)
    grads = torch.autograd.grad(sq, params, allow_unused=True)
    # One buffer for the collective, on the rays' device (the sky's leaves
    # stay on the CPU: the renderer moves them to the rays' device).
    flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1).to(device)
                      for p, g in zip(params, grads)])
    _sum_mesh(flat, mesh)
    loss = sq.detach().clone()
    dist.all_reduce(loss, group=mesh.get_group("tiles"))
    n_elem = n * 3
    new, at = [], 0
    for p in params:
        g = flat[at : at + p.numel()].reshape(p.shape).to(p.device) / n_elem
        new.append((p - lr * g).detach())
        at += p.numel()
    return loss / n_elem, grad_mod.set_params(scene, grad_mod.SceneParams(*new))
