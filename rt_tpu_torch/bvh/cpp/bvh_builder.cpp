// Binned-SAH BVH builder emitting flattened, threaded (hit/miss-link)
// node arrays for stackless TPU traversal.
//
// Native equivalent of the Rust `bvh` crate's parallel SAH build that the
// reference delegates to (reference: hittable.rs:34, Cargo.toml:14).  The
// output contract matches rt_tpu_torch/bvh/builder.py (the NumPy fallback):
// preorder nodes, hit_next = first child (self+1) for interior nodes or
// the escape for leaves, miss_next = escape, leaves referencing contiguous
// ranges of prim_order.  A copy of the JAX package's rt_tpu/bvh/cpp
// builder: the same source gives the same trees, so the port's cluster
// tables equal the JAX package's.
//
// Built with g++ at first use and loaded via ctypes
// (rt_tpu_torch/bvh/native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int kNumBins = 16;

struct Aabb {
  float mn[3] = {std::numeric_limits<float>::infinity(),
                 std::numeric_limits<float>::infinity(),
                 std::numeric_limits<float>::infinity()};
  float mx[3] = {-std::numeric_limits<float>::infinity(),
                 -std::numeric_limits<float>::infinity(),
                 -std::numeric_limits<float>::infinity()};

  void grow(const float* lo, const float* hi) {
    for (int k = 0; k < 3; ++k) {
      mn[k] = std::min(mn[k], lo[k]);
      mx[k] = std::max(mx[k], hi[k]);
    }
  }
  void grow(const Aabb& o) { grow(o.mn, o.mx); }
  float half_area() const {
    float dx = std::max(mx[0] - mn[0], 0.0f);
    float dy = std::max(mx[1] - mn[1], 0.0f);
    float dz = std::max(mx[2] - mn[2], 0.0f);
    return dx * dy + dy * dz + dz * dx;
  }
};

struct Builder {
  const float* mins;
  const float* maxs;
  std::vector<float> centroid;
  std::vector<int32_t> ids;  // permutation being partitioned in place
  int leaf_size;

  float* node_min;
  float* node_max;
  int32_t* hit_next;
  int32_t* miss_next;
  int32_t* leaf_start;
  int32_t* leaf_count;
  int32_t* prim_order;
  int n_nodes = 0;
  int n_ordered = 0;

  Aabb range_bounds(int lo, int hi) const {
    Aabb b;
    for (int i = lo; i < hi; ++i) {
      const int32_t p = ids[i];
      b.grow(&mins[3 * p], &maxs[3 * p]);
    }
    return b;
  }

  // Emits the subtree over ids[lo, hi) in preorder; returns its root index.
  int emit(int lo, int hi, int escape) {
    const int idx = n_nodes++;
    const Aabb bounds = range_bounds(lo, hi);
    std::memcpy(&node_min[3 * idx], bounds.mn, 12);
    std::memcpy(&node_max[3 * idx], bounds.mx, 12);
    miss_next[idx] = escape;

    const int count = hi - lo;
    int mid = -1;
    if (count > leaf_size) mid = partition_sah(lo, hi, bounds);
    if (mid < 0) {  // leaf (small range, or SAH says don't split)
      leaf_start[idx] = n_ordered;
      leaf_count[idx] = count;
      for (int i = lo; i < hi; ++i) prim_order[n_ordered++] = ids[i];
      hit_next[idx] = escape;
      return idx;
    }

    leaf_start[idx] = -1;
    leaf_count[idx] = 0;
    hit_next[idx] = idx + 1;  // left child in preorder
    // Left subtree escapes to the right subtree's root, which we only know
    // after emitting the left — emit left, then patch nothing: preorder
    // position of the right root is simply n_nodes after the left returns.
    // (Unlike the NumPy builder, SAH splits are data-dependent, so the
    // escape is threaded by emitting left first with a placeholder pass:
    // we compute it with a two-step emit.)
    const int left_root = n_nodes;
    (void)left_root;
    // Reserve: we can't know right_root before emitting left, so emit left
    // with a sentinel escape, remember which nodes need the fix, and patch.
    const int patch_from = n_nodes;
    emit(lo, mid, -2);  // -2 = placeholder escape
    const int right_root = n_nodes;
    // Patch every -2 escape produced by the left subtree (its rightmost
    // spine) to the right subtree root.
    for (int i = patch_from; i < right_root; ++i) {
      if (miss_next[i] == -2) miss_next[i] = right_root;
      if (hit_next[i] == -2) hit_next[i] = right_root;
    }
    emit(mid, hi, escape);
    return idx;
  }

  // Binned SAH split of ids[lo, hi); returns the partition midpoint or -1
  // to make a leaf.
  int partition_sah(int lo, int hi, const Aabb& bounds) {
    // Centroid bounds pick the split axis.
    float cmin[3] = {1e38f, 1e38f, 1e38f}, cmax[3] = {-1e38f, -1e38f, -1e38f};
    for (int i = lo; i < hi; ++i) {
      const float* c = &centroid[3 * ids[i]];
      for (int k = 0; k < 3; ++k) {
        cmin[k] = std::min(cmin[k], c[k]);
        cmax[k] = std::max(cmax[k], c[k]);
      }
    }
    int axis = 0;
    float extent = -1.0f;
    for (int k = 0; k < 3; ++k) {
      const float e = cmax[k] - cmin[k];
      if (e > extent) {
        extent = e;
        axis = k;
      }
    }
    if (extent <= 1e-12f) {  // all centroids coincide: median split
      const int mid = lo + (hi - lo) / 2;
      return mid;
    }

    const float scale = kNumBins / extent;
    Aabb bin_bounds[kNumBins];
    int bin_count[kNumBins] = {0};
    for (int i = lo; i < hi; ++i) {
      const int32_t p = ids[i];
      int b = static_cast<int>((centroid[3 * p + axis] - cmin[axis]) * scale);
      b = std::min(std::max(b, 0), kNumBins - 1);
      ++bin_count[b];
      bin_bounds[b].grow(&mins[3 * p], &maxs[3 * p]);
    }

    // Sweep: cost(i) = A_left * n_left + A_right * n_right.
    float right_area[kNumBins];
    Aabb acc;
    int total = hi - lo;
    for (int b = kNumBins - 1; b > 0; --b) {
      acc.grow(bin_bounds[b]);
      right_area[b] = acc.half_area();
    }
    Aabb left;
    int n_left = 0;
    float best_cost = std::numeric_limits<float>::infinity();
    int best_split = -1;
    for (int b = 0; b < kNumBins - 1; ++b) {
      left.grow(bin_bounds[b]);
      n_left += bin_count[b];
      if (n_left == 0 || n_left == total) continue;
      const float cost =
          left.half_area() * n_left + right_area[b + 1] * (total - n_left);
      if (cost < best_cost) {
        best_cost = cost;
        best_split = b;
      }
    }
    if (best_split < 0) {
      return lo + (hi - lo) / 2;  // degenerate; median
    }
    // "Don't split" heuristic: leaf cost ~ count * area vs split cost.
    const float leaf_cost = bounds.half_area() * total;
    if (total <= leaf_size * 2 && best_cost >= leaf_cost) return -1;

    const float threshold = cmin[axis] + (best_split + 1) / scale;
    auto* first = ids.data() + lo;
    auto* last = ids.data() + hi;
    auto* mid_ptr = std::partition(first, last, [&](int32_t p) {
      return centroid[3 * p + axis] < threshold;
    });
    int mid = static_cast<int>(mid_ptr - ids.data());
    if (mid == lo || mid == hi) mid = lo + (hi - lo) / 2;  // safety
    return mid;
  }
};

}  // namespace

extern "C" int bvh_build(const float* mins, const float* maxs, int n,
                         int leaf_size, float* node_min, float* node_max,
                         int32_t* hit_next, int32_t* miss_next,
                         int32_t* leaf_start, int32_t* leaf_count,
                         int32_t* prim_order) {
  if (n <= 0) return -1;
  Builder b;
  b.mins = mins;
  b.maxs = maxs;
  b.leaf_size = std::max(leaf_size, 1);
  b.centroid.resize(3 * n);
  for (int i = 0; i < 3 * n; ++i) b.centroid[i] = 0.5f * (mins[i] + maxs[i]);
  b.ids.resize(n);
  for (int i = 0; i < n; ++i) b.ids[i] = i;
  b.node_min = node_min;
  b.node_max = node_max;
  b.hit_next = hit_next;
  b.miss_next = miss_next;
  b.leaf_start = leaf_start;
  b.leaf_count = leaf_count;
  b.prim_order = prim_order;
  b.emit(0, n, -1);
  return b.n_nodes;
}
