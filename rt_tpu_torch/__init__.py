"""rt_tpu_torch — the PyTorch and CUDA port of rt_tpu for NVIDIA Hopper.

The same path tracer as the JAX package beside it (``rt_tpu``, the
reference): the same scenes, tables, counter-hash random streams and
quirk flags, rendered by a hand-written CUDA megakernel on the card and by
its plain PyTorch version on the CPU.  This package imports torch and
numpy, never JAX or ``rt_tpu``.

Ported so far: the flat forward renderer (scenes with up to 128 triangles
and 2048 primitives), its scenes, camera, sky, I/O and single-frame CLI;
the chunked renderer (``render_pixel_colors(wavefront=False)``,
``render_chunk``) and pixel gradients (``grad``: ``pixel_loss``,
``pixel_grad``); the persistent wavefront and progressive rendering;
clustered scenes (meshes from OBJ and glTF files, ``cover-large``) through
the clustered megakernel and the clustered wavefront; the live
Hosek-Wilkie sky (``SkyParams.hosek``); the click probe (``debug``), the
terminal and HTTP previews (``term_preview``, ``viewer``) and the CLI's
``--probe``, ``--serve`` and ``--term-preview``; and sharding over
``torch.distributed`` (``parallel``, ``graft_entry``).  With them the port
does everything the JAX package does.
"""

from rt_tpu_torch.config import RenderConfig, CompatConfig, ProgressiveSchedule
from rt_tpu_torch.camera import Camera, make_camera
from rt_tpu_torch.scene import SceneData, SceneBuilder
from rt_tpu_torch.sky import SkyParams
from rt_tpu_torch.render import render_chunk, render_image, render_pixel_colors
from rt_tpu_torch import grad
from rt_tpu_torch.grad import SceneParams, pixel_grad, pixel_loss

__version__ = "0.1.0"

__all__ = [
    "RenderConfig",
    "CompatConfig",
    "ProgressiveSchedule",
    "Camera",
    "make_camera",
    "SceneData",
    "SceneBuilder",
    "SkyParams",
    "render_chunk",
    "render_image",
    "render_pixel_colors",
    "grad",
    "SceneParams",
    "pixel_loss",
    "pixel_grad",
]
