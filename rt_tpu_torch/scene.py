"""Scene representation: a host-side builder and a module of device tables.

The reference keeps an AoS ``Vec<Shape>`` of enum-dispatched Sphere/Triangle
structs holding ``Arc<Material>`` pointers (hittable.rs:24-29, 101-105;
material.rs:10-16; texture.rs:12-18).  Here, as in the JAX package, it is
flat SoA tables:

- spheres and triangles in separate arrays, addressed by a global
  primitive id (sphere ids first, then triangles);
- materials and textures as tables of integer type tags plus parameter
  columns, with all image textures shelf-packed into one f32 atlas;
- the kernel layouts ``sph_packed [S_pad, 4]``, ``tri_packed [T_pad, 12]``
  and the per-primitive ``shade_table [40, P_pad]`` (fast_shade.py);
- for scenes above 128 triangles or 2048 primitives, the two-level cluster
  tables (``ClusterData``, cluster.py) that the clustered kernels walk, and
  above 256 triangles or 4096 primitives a BVH (``BvhArrays``, bvh/).

``SceneBuilder.build()`` produces exactly the tables ``rt_tpu``'s builder
produces for the same calls, cluster tables and BVH included (both come
from the BVH builder; the native one must run for the JAX package's trees,
see bvh/native.py).
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch
from torch import nn

from rt_tpu_torch import profiling
from rt_tpu_torch.sky import SkyParams

# Material type tags (reference enum Material, material.rs:12-16).
MAT_LAMBERTIAN = 0
MAT_METAL = 1
MAT_DIELECTRIC = 2
# Extension beyond the reference (its only light is the sky): hits deposit
# throughput * emit and terminate.
MAT_EMISSIVE = 3

# Texture type tags (reference enum TextureEnum, texture.rs:14-18).
TEX_SOLID = 0
TEX_CHECKER = 1
TEX_IMAGE = 2

# Names of the table buffers, in the JAX SceneData's field order.
TABLES = (
    "sph_center", "sph_radius", "sph_front_dir", "sph_material",
    "tri_a", "tri_b", "tri_c", "tri_normal", "tri_uv", "tri_material",
    "mat_kind", "mat_texture", "mat_fuzz", "mat_ior",
    "tex_kind", "tex_color", "tex_inv_scale", "tex_children", "tex_rect",
    "atlas", "shade_table", "sph_packed", "tri_packed",
)


# The image atlas of the last build: the distinct images packed, its rows,
# its columns and its bytes (f32 RGB).
ATLAS = {"textures": 0, "height": 0, "width": 0, "bytes": 0}


def _buffers(module: nn.Module, names, values) -> None:
    for name in names:
        value = values[name]
        module.register_buffer(name, None if value is None else torch.as_tensor(value))


BVH_TABLES = ("node_min", "node_max", "hit_next", "miss_next", "leaf_start", "leaf_count",
              "prim_order")


class BvhArrays(nn.Module):
    """Flattened BVH in depth-first order with skip ("escape") indices for
    stackless traversal (built on the host; see bvh/builder.py): node_min,
    node_max f32[NN,3]; hit_next, miss_next i32[NN] (the next node on an
    AABB hit / miss, -1 ends); leaf_start i32[NN] (first index into
    prim_order, -1 for interior nodes), leaf_count i32[NN]; prim_order
    i32[NP], a permutation of global prim ids."""

    def __init__(self, *arrays):
        super().__init__()
        _buffers(self, BVH_TABLES, dict(zip(BVH_TABLES, arrays, strict=True)))


CLUSTER_TABLES = ("sph_cluster", "sph_slots", "tri_cluster", "tri_slots", "sph_super",
                  "tri_super", "shade_table")


class ClusterData(nn.Module):
    """Clustered primitive tables (rt_tpu/scene.py:97-125; cluster.py):
    fixed-stride clusters of 128 primitive slots in 64-cluster supers, the
    whole tables that K5 and the wavefront's K4 walk.  sph_cluster
    f32[Ms_pad, 8] and tri_cluster f32[Mt_pad, 8] are cluster AABBs (lo
    xyz, hi xyz, pad), sph_super and tri_super those of each 64-cluster
    group, sph_slots f32[8, Ms_pad*128] and tri_slots f32[16 or 24,
    Mt_pad*128] the slot tables (cluster.pack_*_slots).  ``shade_table``
    f32[40, slots_pad] is ordered by slot, so that the kernels' winner
    slot ids index it directly; ``n_sph_slots`` is the first triangle
    slot id.  ``sph_prim`` and ``tri_prim`` i32[slots] hold each slot's
    global primitive id (spheres first, 2**31 - 1 for a dead slot), by
    which the walks break ties of t as a brute-force search does
    (``slot_ids`` gives a scene that has none the lowest slot's rule)."""

    def __init__(self, *, n_sph_slots: int, sph_prim, tri_prim, **tables):
        super().__init__()
        _buffers(self, CLUSTER_TABLES, tables)
        _buffers(self, ("sph_prim", "tri_prim"), {"sph_prim": sph_prim, "tri_prim": tri_prim})
        self.n_sph_slots = int(n_sph_slots)


def slot_ids(n_sph_slots: int, n_tri_slots: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Primitive ids equal to the global slot ids, int32[n_sph_slots] and
    int32[n_tri_slots] (triangles from n_sph_slots on): under these the
    lowest slot keeps a tie of t, as the first slot visited does in the JAX
    package's kernels, which visit slots in ascending id."""
    ids = torch.arange(n_sph_slots + n_tri_slots, dtype=torch.int32)
    return ids[:n_sph_slots], ids[n_sph_slots:]


class SceneData(nn.Module):
    """Immutable scene (reference analog: World, hittable.rs:24-29).

    Every table in ``TABLES`` is a buffer, and ``clusters`` and ``bvh``
    (None for small scenes) are submodules of buffers, so
    ``scene.to(device)`` moves the whole scene.  ``shade_table`` is None
    when a texture configuration is not expressible in it (checker with
    non-solid children); such a scene is not renderable by the
    megakernels.
    """

    def __init__(
        self,
        *,
        sky: SkyParams,
        num_spheres: int,
        num_triangles: int,
        has_image_textures: bool,
        clusters: ClusterData | None = None,
        bvh: BvhArrays | None = None,
        **tables,
    ):
        super().__init__()
        missing = set(TABLES) - set(tables)
        if missing or len(tables) != len(TABLES):
            raise TypeError(f"SceneData tables mismatch: missing {sorted(missing)}")
        _buffers(self, TABLES, tables)
        self.add_module("clusters", clusters)
        self.add_module("bvh", bvh)
        self.sky = sky
        self.num_spheres = int(num_spheres)
        self.num_triangles = int(num_triangles)
        self.has_image_textures = bool(has_image_textures)

    @property
    def num_prims(self) -> int:
        return self.num_spheres + self.num_triangles

    @property
    def device(self) -> torch.device:
        return self.sph_packed.device

    def to(self, *args, **kwargs):
        """``nn.Module.to``; a move of the tables to another device is the
        span ``rt.scene.upload``."""
        device = torch._C._nn._parse_to(*args, **kwargs)[0]
        here = self.device
        if device is None or (device.type == here.type and device.index in (None, here.index)):
            return super().to(*args, **kwargs)
        with profiling.span("scene.upload"):
            return super().to(*args, **kwargs)


class _Texture:
    def __init__(self, kind, color=(0, 0, 0), inv_scale=0.0, children=(-1, -1), image=None):
        self.kind = kind
        self.color = color
        self.inv_scale = inv_scale
        self.children = children
        self.image = image  # np.f32[h,w,3] for TEX_IMAGE


class _Material:
    def __init__(self, kind, texture=-1, fuzz=0.0, ior=1.0):
        self.kind = kind
        self.texture = texture
        self.fuzz = fuzz
        self.ior = ior


def _cluster_capacity_split(ns: int, nt: int) -> tuple[int, int]:
    """Per-type cluster-count caps for the clustered megakernel's static
    worklist budget (sphere_cap, triangle_cap), split by prim share.

    Budgeted in SUPERS (64-cluster groups): build_clusters pads each
    type's cluster count up to a SUPER_SLOTS multiple and an empty type
    still emits one padded super, so a cluster-granular 256*64 split
    could overflow to 257 supers and silently drop the clustered path
    (round-4 advisor finding).  Invariants (tested): both caps are
    positive multiples of 64 and the worst-case padded super totals sum
    to exactly _WL_ROWS (256)."""
    sup_total = 256
    sup_s = min(max(round(sup_total * ns / max(ns + nt, 1)), 1), sup_total - 1)
    return sup_s * 64, (sup_total - sup_s) * 64


class SceneBuilder:
    """Host-side mutable scene assembly (reference analog: the
    ``Vec<Shape>`` push pattern in scenes.rs + ``World::build``)."""

    def __init__(self):
        self._textures: list[_Texture] = []
        self._materials: list[_Material] = []
        self._spheres: list[tuple] = []
        self._triangles: list[tuple] = []

    # -- textures ----------------------------------------------------------

    def solid_color(self, rgb) -> int:
        """SolidColor (texture.rs:21-41)."""
        self._textures.append(_Texture(TEX_SOLID, color=tuple(float(c) for c in rgb)))
        return len(self._textures) - 1

    def checker(self, scale: float, even_tex: int, odd_tex: int) -> int:
        """3-D checker on floor(point/scale) parity (texture.rs:44-74).
        Children must be leaf textures (solid/image)."""
        for child in (even_tex, odd_tex):
            if self._textures[child].kind == TEX_CHECKER:
                raise ValueError("nested checker textures are not supported")
        self._textures.append(
            _Texture(TEX_CHECKER, inv_scale=1.0 / scale, children=(even_tex, odd_tex))
        )
        return len(self._textures) - 1

    def image_texture(self, image: np.ndarray) -> int:
        """ImageTexture from an f32[h,w,3] array in [0,1] (texture.rs:76-97).
        Identical pixel buffers are deduplicated in the atlas at build()."""
        image = np.ascontiguousarray(np.asarray(image, np.float32))
        if image.ndim != 3 or image.shape[2] != 3:
            raise ValueError(f"image texture must be (h, w, 3), got {image.shape}")
        self._textures.append(_Texture(TEX_IMAGE, image=image))
        return len(self._textures) - 1

    # -- materials ---------------------------------------------------------

    def lambertian(self, texture: int) -> int:
        """Lambertian (material.rs:62-76)."""
        self._materials.append(_Material(MAT_LAMBERTIAN, texture=texture))
        return len(self._materials) - 1

    def lambertian_rgb(self, r: float, g: float, b: float) -> int:
        return self.lambertian(self.solid_color((r, g, b)))

    def metal(self, texture: int, fuzz: float | None = None) -> int:
        """Metal with optional fuzz (material.rs:78-92)."""
        self._materials.append(_Material(MAT_METAL, texture=texture, fuzz=float(fuzz or 0.0)))
        return len(self._materials) - 1

    def metal_solid(self, rgb, fuzz: float | None = None) -> int:
        return self.metal(self.solid_color(rgb), fuzz)

    def dielectric(self, refractive_index: float, fuzz: float | None = None) -> int:
        """Dielectric; fuzz > 0 gives the frosted variant
        (material.rs:122-148)."""
        self._materials.append(
            _Material(MAT_DIELECTRIC, fuzz=float(fuzz or 0.0), ior=float(refractive_index))
        )
        return len(self._materials) - 1

    def emissive(self, rgb) -> int:
        """Emissive area-light material (extension; see MAT_EMISSIVE).
        ``rgb`` is HDR radiance."""
        tex = self.solid_color(rgb)
        self._materials.append(_Material(MAT_EMISSIVE, texture=tex))
        return len(self._materials) - 1

    # -- primitives --------------------------------------------------------

    def add_sphere(self, center, radius: float, material: int, front_direction=(1.0, 0.0, 0.0)):
        """Sphere; ``front_direction`` orients the texture
        (hittable.rs:270-296; default +x)."""
        self._spheres.append(
            (
                tuple(float(c) for c in center),
                max(float(radius), 0.0),
                tuple(float(c) for c in front_direction),
                material,
            )
        )

    def add_triangle(self, a, b, c, material: int, uv_a=(0.0, 0.0), uv_b=(1.0, 0.0), uv_c=(0.5, 1.0)):
        """Triangle with per-vertex UVs; defaults match the reference
        (hittable.rs:166-208)."""
        self._triangles.append(
            (
                np.asarray(a, np.float32),
                np.asarray(b, np.float32),
                np.asarray(c, np.float32),
                np.asarray([uv_a, uv_b, uv_c], np.float32),
                material,
            )
        )

    def add_triangles(self, vertices, uvs, material: int, transform=None, shift=None):
        """Bulk triangle append: vertices f32[n,3,3], uvs f32[n,3,2]|None.
        ``transform`` applies a 4x4 matrix's linear part (hittable.rs:214-227);
        ``shift`` adds a translation (hittable.rs:229-239)."""
        vertices = np.asarray(vertices, np.float32)
        if transform is not None:
            t = np.asarray(transform, np.float32)
            vertices = (vertices.reshape(-1, 3) @ t[:3, :3].T).reshape(-1, 3, 3)
        if shift is not None:
            vertices = vertices + np.asarray(shift, np.float32)[None, None, :]
        if uvs is None:
            uvs = np.broadcast_to(
                np.array([[0.0, 0.0], [1.0, 0.0], [0.5, 1.0]], np.float32),
                (vertices.shape[0], 3, 2),
            )
        for v, uv in zip(vertices, np.asarray(uvs, np.float32)):
            self._triangles.append((v[0], v[1], v[2], uv, material))

    # -- freeze ------------------------------------------------------------

    def build(self, sky: SkyParams | None = None, use_bvh: bool | None = None) -> SceneData:
        """Freeze into tables (reference analog: World::build,
        hittable.rs:33-46), with cluster tables above 128 triangles or 2048
        primitives and a BVH above 256 triangles or 4096 primitives (or as
        ``use_bvh`` says), at the JAX package's thresholds."""
        with profiling.span("scene.build"):
            ns, nt = len(self._spheres), len(self._triangles)
            sky = sky if sky is not None else SkyParams.default()

            s = max(ns, 1)
            sph_center = np.zeros((s, 3), np.float32)
            sph_radius = np.zeros((s,), np.float32)  # r=0 spheres can never be hit
            sph_front = np.tile(np.array([1.0, 0, 0], np.float32), (s, 1))
            sph_mat = np.zeros((s,), np.int32)
            for i, (c, r, f, m) in enumerate(self._spheres):
                sph_center[i], sph_radius[i], sph_front[i], sph_mat[i] = c, r, f, m

            t = max(nt, 1)
            tri_a = np.zeros((t, 3), np.float32)
            tri_b = np.zeros((t, 3), np.float32)
            tri_c = np.zeros((t, 3), np.float32)
            tri_uv = np.zeros((t, 3, 2), np.float32)
            tri_mat = np.zeros((t,), np.int32)
            for i, (a, b, c, uv, m) in enumerate(self._triangles):
                tri_a[i], tri_b[i], tri_c[i], tri_uv[i], tri_mat[i] = a, b, c, uv, m
            # Flat normal precomputed like the reference: edges normalized
            # *before* the cross product (hittable.rs:169-178).
            e1 = _normalize_rows(tri_b - tri_a)
            e2 = _normalize_rows(tri_c - tri_a)
            tri_normal = _normalize_rows(np.cross(e1, e2))

            m = max(len(self._materials), 1)
            mat_kind = np.zeros((m,), np.int32)
            mat_tex = np.zeros((m,), np.int32)
            mat_fuzz = np.zeros((m,), np.float32)
            mat_ior = np.ones((m,), np.float32)
            for i, mt in enumerate(self._materials):
                mat_kind[i], mat_tex[i] = mt.kind, mt.texture
                mat_fuzz[i], mat_ior[i] = mt.fuzz, mt.ior

            x = max(len(self._textures), 1)
            tex_kind = np.zeros((x,), np.int32)
            tex_color = np.zeros((x, 3), np.float32)
            tex_inv_scale = np.zeros((x,), np.float32)
            tex_children = np.zeros((x, 2), np.int32)
            tex_rect = np.zeros((x, 4), np.int32)

            images = [(i, tx.image) for i, tx in enumerate(self._textures) if tx.kind == TEX_IMAGE]
            # Args: the image textures handed in and their bytes.
            with profiling.span("scene.atlas", f"textures={len(images)} "
                                f"bytes={sum(im.nbytes for _, im in images)}"):
                atlas, rects = _pack_atlas(images)
            ATLAS.update(textures=len(set(rects.values())), height=atlas.shape[0],
                         width=atlas.shape[1], bytes=atlas.nbytes)
            for i, tx in enumerate(self._textures):
                tex_kind[i] = tx.kind
                tex_color[i] = tx.color
                tex_inv_scale[i] = tx.inv_scale
                tex_children[i] = tx.children
                if tx.kind == TEX_IMAGE:
                    tex_rect[i] = rects[i]

            from rt_tpu_torch.fast_shade import build_shade_table

            shade_np = build_shade_table(
                sph_center, sph_radius, sph_front, sph_mat,
                tri_a, tri_b, tri_c, tri_normal, tri_uv, tri_mat,
                mat_kind, mat_tex, mat_fuzz, mat_ior,
                tex_kind, tex_color, tex_inv_scale, tex_children, tex_rect,
                ns, nt,
            )
            # Kernel-layout sphere table: center xyz, radius.
            s_pad = -(-s // 128) * 128
            sph_packed = np.zeros((s_pad, 4), np.float32)
            sph_packed[:s, 0:3] = sph_center
            sph_packed[:s, 3] = sph_radius

            # Kernel-layout triangle table: a.xyz, e1.xyz, e2.xyz, valid, pad.
            t_pad = -(-t // 64) * 64
            tri_packed = np.zeros((t_pad, 12), np.float32)
            tri_packed[:t, 0:3] = tri_a
            tri_packed[:t, 3:6] = tri_b - tri_a
            tri_packed[:t, 6:9] = tri_c - tri_a
            tri_packed[:nt, 9] = 1.0  # real (non-dummy) rows

            tables = dict(
                sph_center=sph_center, sph_radius=sph_radius, sph_front_dir=sph_front,
                sph_material=sph_mat, tri_a=tri_a, tri_b=tri_b, tri_c=tri_c,
                tri_normal=tri_normal, tri_uv=tri_uv, tri_material=tri_mat,
                mat_kind=mat_kind, mat_texture=mat_tex, mat_fuzz=mat_fuzz, mat_ior=mat_ior,
                tex_kind=tex_kind, tex_color=tex_color, tex_inv_scale=tex_inv_scale,
                tex_children=tex_children, tex_rect=tex_rect, atlas=atlas,
                shade_table=shade_np, sph_packed=sph_packed, tri_packed=tri_packed,
            )
            # Cluster tables for mid-sized and large scenes, a BVH for large ones
            # (rt_tpu/scene.py:528-553).
            clusters = None
            if shade_np is not None and (nt > 128 or ns + nt > 2048):
                with profiling.span("scene.clusters"):
                    clusters = self._build_cluster_data(shade_np, sph_center, sph_radius, tri_a,
                                                        tri_b, tri_c)
            if use_bvh is None:
                use_bvh = nt > 256 or ns + nt > 4096
            bvh = None
            if use_bvh and ns + nt > 0:
                from rt_tpu_torch.bvh import build_bvh

                with profiling.span("scene.bounds"):
                    bounds = self._prim_bounds()
                with profiling.span("scene.bvh"):
                    bvh = build_bvh(bounds)
            return SceneData(
                sky=sky,
                num_spheres=ns,
                num_triangles=nt,
                has_image_textures=any(tx.kind == TEX_IMAGE for tx in self._textures),
                clusters=clusters,
                bvh=bvh,
                **{k: torch.from_numpy(v) if v is not None else None for k, v in tables.items()},
            )

    def _build_cluster_data(self, shade_np, sph_center, sph_radius, tri_a, tri_b, tri_c
                            ) -> ClusterData:
        """Two-level cluster tables and the slot-ordered shade table
        (rt_tpu/scene.py:555-690)."""
        from rt_tpu_torch.cluster import (
            build_clusters, build_essentials, pack_sphere_slots, pack_triangle_slots,
        )
        from rt_tpu_torch.fast_shade import F_IS_SPHERE, F_ROWS, F_TEX_KIND, F_UVA

        ns, nt = len(self._spheres), len(self._triangles)
        s_min = sph_center[:ns] - sph_radius[:ns, None]
        s_max = sph_center[:ns] + sph_radius[:ns, None]
        # The JAX package's per-type super budget (its worklist bounds);
        # it decides how _pack_leaves merges leaves, so the tables need it.
        cap_s, cap_t = _cluster_capacity_split(ns, nt)
        _, s_slots, s_cl, s_sup = build_clusters(s_min, s_max, cap_s)
        t_min_ = np.minimum(np.minimum(tri_a[:nt], tri_b[:nt]), tri_c[:nt])
        t_max_ = np.maximum(np.maximum(tri_a[:nt], tri_b[:nt]), tri_c[:nt])
        _, t_slots, t_cl, t_sup = build_clusters(t_min_, t_max_, cap_t)

        ess, _, _ = build_essentials(shade_np)
        sph_slot_tab = pack_sphere_slots(s_slots, sph_center, sph_radius, ess[:, :ns])
        has_img_tris = bool(
            ((shade_np[F_IS_SPHERE, ns:] < 0.5) & (shade_np[F_TEX_KIND, ns:] > 1.5)).any()
        )
        tri_slot_tab = pack_triangle_slots(
            t_slots, tri_a, tri_b, tri_c, ess[:, ns:],
            uva=shade_np[F_UVA : F_UVA + 6, ns:] if has_img_tris else None,
        )

        # Slot-ordered shade table: kernel winner ids index it directly.
        n_sph_slots = s_slots.shape[0]
        total = n_sph_slots + t_slots.shape[0]
        total_pad = -(-total // 128) * 128
        shade_slots = np.zeros((F_ROWS, total_pad), np.float32)
        live_s = s_slots >= 0
        shade_slots[:, np.nonzero(live_s)[0]] = shade_np[:, s_slots[live_s]]
        live_t = t_slots >= 0
        shade_slots[:, n_sph_slots + np.nonzero(live_t)[0]] = shade_np[:, ns + t_slots[live_t]]

        dead = np.iinfo(np.int32).max
        sph_prim = np.where(live_s, s_slots, dead).astype(np.int32)
        tri_prim = np.where(live_t, ns + t_slots, dead).astype(np.int32)
        t = torch.from_numpy
        return ClusterData(
            sph_super=t(s_sup), sph_cluster=t(s_cl), sph_slots=t(sph_slot_tab),
            tri_super=t(t_sup), tri_cluster=t(t_cl), tri_slots=t(tri_slot_tab),
            shade_table=t(shade_slots), n_sph_slots=n_sph_slots, sph_prim=t(sph_prim),
            tri_prim=t(tri_prim),
        )

    def _prim_bounds(self) -> tuple[np.ndarray, np.ndarray]:
        """Per-primitive AABBs in global prim-id order (spheres then
        triangles), matching the reference's Bounded impls
        (hittable.rs:299-306, 242-248)."""
        mins, maxs = [], []
        for c, r, _, _ in self._spheres:
            c = np.asarray(c, np.float32)
            mins.append(c - r)
            maxs.append(c + r)
        for a, b, c, _, _ in self._triangles:
            mins.append(np.minimum(np.minimum(a, b), c))
            maxs.append(np.maximum(np.maximum(a, b), c))
        return np.asarray(mins, np.float32), np.asarray(maxs, np.float32)


def _pack_atlas(images) -> tuple[np.ndarray, dict[int, tuple]]:
    """Shelf-pack image textures into one atlas f32[AH, AW, 3], stacked
    top to bottom and deduplicated by full-buffer hash.  Returns the atlas
    and each texture id's (x0, y0, w, h) rect."""
    seen: dict[bytes, int] = {}
    unique: list[np.ndarray] = []
    slot_of: dict[int, int] = {}
    for tex_id, img in images:
        digest = hashlib.sha1(img.tobytes()).digest() + repr(img.shape).encode()
        if digest not in seen:
            seen[digest] = len(unique)
            unique.append(img)
        slot_of[tex_id] = seen[digest]
    atlas_w = max([im.shape[1] for im in unique], default=1)
    atlas_h = max(sum(im.shape[0] for im in unique), 1)
    atlas = np.zeros((atlas_h, atlas_w, 3), np.float32)
    offsets = []
    y = 0
    for im in unique:
        atlas[y : y + im.shape[0], : im.shape[1]] = im
        offsets.append((0, y, im.shape[1], im.shape[0]))
        y += im.shape[0]
    return atlas, {tex_id: offsets[slot] for tex_id, slot in slot_of.items()}


def _normalize_rows(v: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(v, axis=-1, keepdims=True)
    return v / np.maximum(n, 1.0e-20)
