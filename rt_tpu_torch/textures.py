"""Tag-dispatched texture evaluation on the scene's texture tables
(rt_tpu/textures.py).

Reference behavior (texture.rs):
- SolidColor (texture.rs:21-41): constant color.
- CheckerTexture (texture.rs:44-74): 3-D checker on floor(point / scale)
  parity; its children are leaves (solid or image), which covers every
  reference scene.
- ImageTexture (texture.rs:99-119): UV clamped to [0, 1], nearest texel by
  truncation (x = trunc(u * (w - 1))), no filtering, no wrap, no v-flip.

Every lane evaluates the cheap paths and a select on the type tag picks the
result.  The persistent wavefront's generic path and the chunked and
gradient paths' generic bounce use it; scenes with a shade table shade
through ``fast_shade`` there instead.  The colors and the atlas are read
with ``take_rows``, so their gradients are deterministic.
"""

from __future__ import annotations

import torch

from rt_tpu_torch.elementwise import take_rows
from rt_tpu_torch.scene import TEX_CHECKER, TEX_IMAGE


def texture_value(scene, tex_id: torch.Tensor, uv: torch.Tensor, point: torch.Tensor) -> torch.Tensor:
    """Linear color f32[N, 3] of texture ``tex_id`` int[N] at (uv f32[N, 2],
    point f32[N, 3])."""
    n_tex = scene.tex_kind.shape[0]
    tex_id = torch.clamp(tex_id.to(torch.int64), 0, n_tex - 1)
    kind = scene.tex_kind[tex_id]

    # Checker resolution (texture.rs:62-73): parity of the summed cells.
    inv_scale = scene.tex_inv_scale[tex_id]
    cells = torch.floor(inv_scale[:, None] * point).to(torch.int32)
    is_even = torch.remainder(cells.sum(dim=-1), 2) == 0
    children = scene.tex_children[tex_id].to(torch.int64)
    child = torch.where(is_even, children[:, 0], children[:, 1])
    leaf_id = torch.clamp(torch.where(kind == TEX_CHECKER, child, tex_id), 0, n_tex - 1)
    leaf_kind = scene.tex_kind[leaf_id]
    solid = take_rows(scene.tex_color, leaf_id)

    # Image fetch (texture.rs:107-118): clamp the UV, truncate to a texel.
    rect = scene.tex_rect[leaf_id].to(torch.int64)  # (x0, y0, w, h)
    u = torch.clamp(uv[:, 0], 0.0, 1.0)
    v = torch.clamp(uv[:, 1], 0.0, 1.0)
    w = torch.clamp(rect[:, 2], min=1)
    h = torch.clamp(rect[:, 3], min=1)
    x = (u * (w - 1).to(torch.float32)).to(torch.int64)
    y = (v * (h - 1).to(torch.float32)).to(torch.int64)
    atlas = scene.atlas
    ax = torch.clamp(rect[:, 0] + x, 0, atlas.shape[1] - 1)
    ay = torch.clamp(rect[:, 1] + y, 0, atlas.shape[0] - 1)
    image = take_rows(atlas.reshape(-1, 3), ay * atlas.shape[1] + ax)
    return torch.where((leaf_kind == TEX_IMAGE)[:, None], image, solid)
