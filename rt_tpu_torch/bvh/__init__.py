"""BVH support (rt_tpu/bvh).  So far only the per-primitive candidate t of
``traverse``, which the gradient path uses; the builder and the walk are a
later slice of the port."""
