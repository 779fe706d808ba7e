"""Host-side BVH construction -> flattened threaded node arrays
(rt_tpu/bvh/builder.py).

Replaces the Rust `bvh` crate's ``Bvh::build_par`` (reference:
hittable.rs:34).  Nodes in depth-first preorder, each carrying

- ``hit_next``: where to go when the ray hits the node's AABB — the first
  child for interior nodes (preorder: self+1), the escape for leaves
  (after intersecting the leaf's primitives);
- ``miss_next``: the "escape" index — the right sibling of the nearest
  ancestor that has one; -1 terminates traversal.

The NumPy builder here is the correctness baseline (median split on the
largest centroid axis).  The C++ binned-SAH builder (bvh/native.py) runs
whenever its library builds and loads, as in the JAX package; it produces
the same array contract but another tree.  The traversal is a later slice
of the port.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

LEAF_SIZE = 4


def which() -> str:
    """The builder that runs on this machine: "native" or "numpy"."""
    from rt_tpu_torch.bvh import native

    return "native" if native.available() else "numpy"


def build_arrays(mins: np.ndarray, maxs: np.ndarray, leaf_size: int):
    """The seven node arrays over per-primitive AABBs, from the builder
    ``which()`` names."""
    from rt_tpu_torch.bvh import native

    mins = np.ascontiguousarray(mins, np.float32)
    maxs = np.ascontiguousarray(maxs, np.float32)
    if native.available():
        return native.build(mins, maxs, leaf_size)
    return _build_python(mins, maxs, leaf_size)


def build_bvh(bounds: tuple[np.ndarray, np.ndarray], leaf_size: int = LEAF_SIZE):
    """Build a BVH over per-primitive AABBs (mins, maxs f32[P,3] in global
    prim-id order): a ``scene.BvhArrays`` module of buffers, with at most
    ``leaf_size`` primitives per leaf."""
    from rt_tpu_torch.scene import BvhArrays

    return BvhArrays(*build_arrays(bounds[0], bounds[1], leaf_size))


def _build_python(mins: np.ndarray, maxs: np.ndarray, leaf_size: int):
    """NumPy median-split builder emitting preorder threaded arrays."""
    n = mins.shape[0]
    centroids = (mins + maxs) * 0.5

    # Upper bound on node count for a binary tree with >=1 prim per leaf.
    max_nodes = max(2 * n, 1)
    node_min = np.empty((max_nodes, 3), np.float32)
    node_max = np.empty((max_nodes, 3), np.float32)
    hit_next = np.empty((max_nodes,), np.int32)
    miss_next = np.empty((max_nodes,), np.int32)
    leaf_start = np.full((max_nodes,), -1, np.int32)
    leaf_count = np.zeros((max_nodes,), np.int32)
    prim_order = np.empty((n,), np.int32)

    n_nodes = 0
    n_ordered = 0
    # Preorder with known escapes: the median split is count-deterministic,
    # so the left subtree's node count, and hence the right subtree's root
    # index, is known up front (``_subtree_size``).  An explicit stack
    # avoids Python's recursion limit.
    stack = [(np.arange(n, dtype=np.int64), -1)]
    while stack:
        ids, escape = stack.pop()
        idx = n_nodes
        n_nodes += 1
        node_min[idx] = mins[ids].min(axis=0)
        node_max[idx] = maxs[ids].max(axis=0)
        miss_next[idx] = escape
        if len(ids) <= leaf_size:
            leaf_start[idx] = n_ordered
            leaf_count[idx] = len(ids)
            prim_order[n_ordered : n_ordered + len(ids)] = ids
            n_ordered += len(ids)
            hit_next[idx] = escape
            continue
        # Median split on the largest centroid-extent axis.
        cent = centroids[ids]
        axis = int(np.argmax(cent.max(axis=0) - cent.min(axis=0)))
        order = np.argsort(cent[:, axis], kind="stable")
        half = len(ids) // 2
        left_ids = ids[order[:half]]
        right_ids = ids[order[half:]]
        hit_next[idx] = idx + 1  # left child (preorder)
        right_root = idx + 1 + _subtree_size(len(left_ids), leaf_size)
        stack.append((right_ids, escape))
        stack.append((left_ids, right_root))

    return (
        node_min[:n_nodes], node_max[:n_nodes], hit_next[:n_nodes], miss_next[:n_nodes],
        leaf_start[:n_nodes], leaf_count[:n_nodes], prim_order,
    )


@lru_cache(maxsize=None)
def _subtree_size(count: int, leaf_size: int) -> int:
    """Node count of the deterministic median-split subtree over ``count``
    prims — computable from the count alone because splits are always
    floor-half/ceil-half."""
    if count <= leaf_size:
        return 1
    half = count // 2
    return 1 + _subtree_size(half, leaf_size) + _subtree_size(count - half, leaf_size)
