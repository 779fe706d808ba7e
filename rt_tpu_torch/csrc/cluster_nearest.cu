// Nearest hit per ray over a clustered scene's tables for Hopper (sm_90a):
// K4 and K4b.
//
// Replaces the TPU kernels launched by rt_tpu/pallas_ops.py's
// `cluster_worklist_nearest` (K4, pallas_call at :1015, body
// `_worklist_kernel` :562), the clustered wavefront's intersect, launched
// once per cluster page per loop iteration, and `cluster_nearest` (K4b,
// :533, body `_cluster_kernel` :333), the same function with `pl.when`
// predication.  Both return, for every ray of the kernel layout f32[8, N],
// t (3e38 on a miss) and the global slot id of the winner (spheres from
// sph_base, triangles from tri_base; -1 on a miss), which indexes the
// scene's slot-ordered shade table.  One kernel serves both; the plain
// PyTorch version is `cluster_ops.cluster_nearest_plain`.
//
// Design.  One thread owns one ray and walks its own way through the
// two-level tables (cluster_walk.cuh), keeping (best_t, best_i) in
// registers; the ray's components come from the [8, N] rows, so
// neighbouring threads read neighbouring addresses.
//
// What bounds it on this card: the pair tests of the entered clusters (24
// FLOP a sphere pair, 46 a triangle pair) and the slab tests (~20 FLOP a
// box), and the divergence of a warp whose rays enter different clusters:
// a warp runs until its longest walk ends.  The tables come through L1/L2
// (a mesh of 100k triangles holds ~10 MB of slots).  Left for later:
// staging a coherent warp's shared clusters in shared memory, and sorting
// or binning the rays so that a warp's rays enter the same clusters.
#include <cuda_runtime.h>

#include "cluster_walk.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
cluster_nearest_kernel(const float* __restrict__ rays, int n, rt::ClusterSet sph,
                       rt::ClusterSet tri, float t_min, float t_max, int backface_cull,
                       float* __restrict__ t_out, int* __restrict__ idx_out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float dx = rays[3 * n + i], dy = rays[4 * n + i], dz = rays[5 * n + i];
  const float a = dx * dx + dy * dy + dz * dz;
  const rt::WalkRay r = rt::walk_ray(rays[i], rays[n + i], rays[2 * n + i], dx, dy, dz, a,
                                     1.0f / a);
  float best_t = 3.0e38f;
  int best_i = -1;
  rt::cluster_walk(sph, tri, r, t_min, t_max, backface_cull != 0, best_t, best_i);
  t_out[i] = best_t;
  idx_out[i] = best_i;
}

rt::ClusterSet make_set(const float* supers, int n_supers, const float* clusters,
                        int n_clusters, const float* slots, int id_base) {
  return rt::ClusterSet{supers, clusters, slots, n_supers, n_clusters,
                        (long long)n_clusters * rt::kClusterSlots, id_base};
}

}  // namespace

// C entry point (ctypes).  Every pointer is device memory: rays f32[8, n];
// per kind the super and cluster AABBs f32[., 8] and the slot table
// f32[rows, n_clusters * 128].  Launches on `stream` and returns the CUDA
// error of the launch (0 on success); it neither allocates nor
// synchronizes.
extern "C" int rt_cluster_nearest(const float* rays, int n, const float* sph_super,
                                  int n_sph_super, const float* sph_cluster, int n_sph_cluster,
                                  const float* sph_slots, int sph_base, const float* tri_super,
                                  int n_tri_super, const float* tri_cluster, int n_tri_cluster,
                                  const float* tri_slots, int tri_base, float t_min, float t_max,
                                  int backface_cull, float* t_out, int* idx_out,
                                  cudaStream_t stream) {
  if (n <= 0) return 0;
  const rt::ClusterSet sph =
      make_set(sph_super, n_sph_super, sph_cluster, n_sph_cluster, sph_slots, sph_base);
  const rt::ClusterSet tri =
      make_set(tri_super, n_tri_super, tri_cluster, n_tri_cluster, tri_slots, tri_base);
  cluster_nearest_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      rays, n, sph, tri, t_min, t_max, backface_cull, t_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
