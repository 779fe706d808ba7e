"""BVH support (rt_tpu/bvh): the host-side builder (``builder``, with the
C++ binned-SAH builder of ``native`` and a NumPy fallback) and the
per-primitive candidate t of ``traverse``, which the gradient path uses.
The BVH walk of the JAX package is a later slice of the port."""

from rt_tpu_torch.bvh.builder import build_bvh

__all__ = ["build_bvh"]
