// The nearest hit of each ray in a scene with a BVH, for Hopper (sm_90a).
//
// Not a TPU kernel.  The JAX package walks the BVH in
// rt_tpu/bvh/traverse.py:105-165 (`nearest_hit_bvh`) as one XLA
// `lax.while_loop` on the device: every iteration advances every ray by one
// node of the threaded (stackless) tree.  Run op by op from PyTorch, that
// loop would issue ~300 small kernels and a host sync per node step, for
// thousands of steps on a 100k-triangle mesh.  This kernel is the same walk
// with one thread per ray: the same node order, the same slab test pruned by
// the ray's best t, the same unrolled LEAF_SIZE = 4 leaf loop with a strict
// `<` against min(best t, t_max), and the same arithmetic, so it is bit-equal
// to the plain version (`bvh.traverse.bvh_walk_plain`, the loop vectorized
// over rays).  Built with -fmad=false and exact division and square root.
//
// What bounds it: the latency of the dependent loads of a pointer chase
// (node box -> next node), and the divergence of a warp whose rays take
// different paths through the tree (a warp runs until its longest walk
// ends).  Rays and nodes are read as [N, 3] rows through L1/L2.  Left for
// later: a wider tree (fewer, fuller steps), node data in 16-byte records,
// and sorting rays so that a warp's rays walk alike.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kLeafSize = 4;  // bvh/builder.py LEAF_SIZE
constexpr float kBig = 3.0e38f;
constexpr float kTriEps = 1.0e-7f;

struct Tree {
  const float* node_min;  // f32[n_nodes, 3]
  const float* node_max;
  const int* hit_next;  // i32[n_nodes]
  const int* miss_next;
  const int* leaf_start;
  const int* leaf_count;
  const int* prim_order;  // i32[n_order]
  int n_nodes, n_order;
};

struct Prims {
  const float* sph_center;  // f32[ns, 3]
  const float* sph_radius;  // f32[ns]
  const float* tri_a;       // f32[nt, 3] each
  const float* tri_b;
  const float* tri_c;
  int ns, nt;
};

// bvh/traverse.py _sphere_t_single.
__device__ float sphere_t(const float o[3], const float d[3], const float* c, float rad,
                          float t_min, float t_limit) {
  const float ocx = c[0] - o[0], ocy = c[1] - o[1], ocz = c[2] - o[2];
  const float a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
  const float h = d[0] * ocx + d[1] * ocy + d[2] * ocz;
  const float cc = (ocx * ocx + ocy * ocy + ocz * ocz) - rad * rad;
  const float disc = h * h - a * cc;
  const float sd = sqrtf(fmaxf(disc, 1.0e-30f));
  const float t0 = (h - sd) / a;
  const float t1 = (h + sd) / a;
  const float t = t0 >= t_min ? t0 : t1;
  const bool ok = disc >= 0.0f && rad > 0.0f && t >= t_min && t < t_limit;
  return ok ? t : kBig;
}

// bvh/traverse.py _triangle_t_single (Moller-Trumbore).
__device__ float triangle_t(const float o[3], const float d[3], const float* a, const float* b,
                            const float* c, float t_min, float t_limit, bool cull) {
  const float e1x = b[0] - a[0], e1y = b[1] - a[1], e1z = b[2] - a[2];
  const float e2x = c[0] - a[0], e2y = c[1] - a[1], e2z = c[2] - a[2];
  const float ux = d[1] * e2z - d[2] * e2y;
  const float uy = d[2] * e2x - d[0] * e2z;
  const float uz = d[0] * e2y - d[1] * e2x;
  const float det = e1x * ux + e1y * uy + e1z * uz;
  const bool det_ok = cull ? det > kTriEps : fabsf(det) > kTriEps;
  const float inv_det = 1.0f / (det_ok ? det : 1.0f);
  const float aox = o[0] - a[0], aoy = o[1] - a[1], aoz = o[2] - a[2];
  const float u = (aox * ux + aoy * uy + aoz * uz) * inv_det;
  const float vx = aoy * e1z - aoz * e1y;
  const float vy = aoz * e1x - aox * e1z;
  const float vz = aox * e1y - aoy * e1x;
  const float v = (d[0] * vx + d[1] * vy + d[2] * vz) * inv_det;
  const float t = (e2x * vx + e2y * vy + e2z * vz) * inv_det;
  const bool ok = det_ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t >= t_min &&
                  t < t_limit && t > kTriEps;
  return ok ? t : kBig;
}

// bvh/traverse.py _prim_t: sphere ids first, then triangles.
__device__ float prim_t(const Prims& p, int pid, const float o[3], const float d[3], float t_min,
                        float t_limit, bool cull) {
  if (pid < p.ns) {
    if (p.ns == 0) return kBig;
    const int s = min(max(pid, 0), p.ns - 1);
    return sphere_t(o, d, p.sph_center + 3 * s, p.sph_radius[s], t_min, t_limit);
  }
  if (p.nt == 0) return kBig;
  const long long k = 3LL * min(max(pid - p.ns, 0), p.nt - 1);
  return triangle_t(o, d, p.tri_a + k, p.tri_b + k, p.tri_c + k, t_min, t_limit, cull);
}

__global__ void __launch_bounds__(kThreads)
bvh_walk_kernel(const float* __restrict__ org, const float* __restrict__ dirn, int n, Tree tree,
                Prims prims, float t_min, float t_max, float t_init, int backface_cull,
                float* __restrict__ t_out, int* __restrict__ prim_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const bool cull = backface_cull != 0;
  float o[3], d[3], inv[3];
  for (int k = 0; k < 3; ++k) {
    o[k] = org[3LL * i + k];
    d[k] = dirn[3LL * i + k];
    const float safe = fabsf(d[k]) > 1.0e-20f ? d[k] : 1.0e-20f;
    inv[k] = 1.0f / safe;
  }
  float t_best = t_init;
  int prim_best = -1;
  int cur = 0;
  // The threaded links only move forward in depth-first order, so a walk
  // takes at most n_nodes steps; the bound guards against a malformed tree.
  for (int step = 0; cur >= 0 && step <= tree.n_nodes; ++step) {
    const int node = min(max(cur, 0), tree.n_nodes - 1);
    const float* lo = tree.node_min + 3LL * node;
    const float* hi = tree.node_max + 3LL * node;
    float t_near = -kBig, t_far = kBig;
    for (int k = 0; k < 3; ++k) {
      const float a = (lo[k] - o[k]) * inv[k];
      const float b = (hi[k] - o[k]) * inv[k];
      t_near = k == 0 ? fminf(a, b) : fmaxf(t_near, fminf(a, b));
      t_far = k == 0 ? fmaxf(a, b) : fminf(t_far, fmaxf(a, b));
    }
    t_near = fmaxf(t_near, 0.0f);  // rays may start inside the box
    const bool box_hit = t_near <= t_far && t_far >= 0.0f && t_near < t_best;
    const int start = tree.leaf_start[node];
    if (box_hit && start >= 0) {
      const int count = tree.leaf_count[node];
      float t_limit = fminf(t_best, t_max);
#pragma unroll
      for (int j = 0; j < kLeafSize; ++j) {
        if (j < count) {
          const int pid = tree.prim_order[min(max(start + j, 0), tree.n_order - 1)];
          const float t = prim_t(prims, pid, o, d, t_min, t_limit, cull);
          if (t < t_limit) {
            t_best = t;
            prim_best = pid;
          }
          t_limit = fminf(t_best, t_max);
        }
      }
    }
    cur = (box_hit && start < 0) ? tree.hit_next[node] : tree.miss_next[node];
  }
  t_out[i] = prim_best >= 0 ? t_best : kBig;
  prim_out[i] = prim_best;
}

}  // namespace

// C entry point (ctypes).  Every pointer is device memory: rays org, dirn
// f32[n, 3]; the tree's tables (scene.BvhArrays); the spheres' centers
// f32[ns, 3] and radii f32[ns]; the triangles' vertices f32[nt, 3].
// t_init is the walk's starting best t, min(3e38, t_max).  Writes t f32[n]
// (3e38 on a miss) and the global primitive id int32[n] (-1 on a miss).
// Launches on `stream` and returns the CUDA error of the launch (0 on
// success); it neither allocates nor synchronizes.
extern "C" int rt_bvh_walk(const float* org, const float* dirn, int n, const float* node_min,
                           const float* node_max, const int* hit_next, const int* miss_next,
                           const int* leaf_start, const int* leaf_count, const int* prim_order,
                           int n_nodes, int n_order, const float* sph_center,
                           const float* sph_radius, int ns, const float* tri_a,
                           const float* tri_b, const float* tri_c, int nt, float t_min,
                           float t_max, float t_init, int backface_cull, float* t_out,
                           int* prim_out, cudaStream_t stream) {
  if (n <= 0) return 0;
  const Tree tree{node_min, node_max, hit_next, miss_next, leaf_start, leaf_count,
                  prim_order, n_nodes, n_order};
  const Prims prims{sph_center, sph_radius, tri_a, tri_b, tri_c, ns, nt};
  bvh_walk_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      org, dirn, n, tree, prims, t_min, t_max, t_init, backface_cull, t_out, prim_out);
  return static_cast<int>(cudaGetLastError());
}
