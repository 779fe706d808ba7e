// Nearest hit per ray over a clustered scene's tables for Hopper (sm_90a):
// K4 and K4b.
//
// Replaces the TPU kernels launched by rt_tpu/pallas_ops.py's
// `cluster_worklist_nearest` (K4, pallas_call at :1015, body
// `_worklist_kernel` :562), the clustered wavefront's intersect, and
// `cluster_nearest` (K4b, :533, body `_cluster_kernel` :333), the same
// function with `pl.when` predication.  Both return, for every ray of the
// kernel layout f32[8, N], t (3e38 on a miss) and the global slot id of the
// winner (spheres from sph_base, triangles from tri_base; -1 on a miss),
// which indexes the scene's slot-ordered shade table.  One kernel serves
// both; the plain PyTorch version is `cluster_ops.cluster_nearest_plain`.
// The wavefront launches it once per intersect over the whole tables
// (bases 0); a call on one cluster page (its slot bases) stays possible.
//
// Design.  A persistent grid: each warp takes `per_warp` consecutive rays
// at a time, lane l < per_warp loading one ray from the [8, N] rows
// (neighbouring lanes, neighbouring addresses), and walks them one after
// another with all 32 lanes (cluster_walk.cuh warp_walk_rays).  The lane
// of each ray writes its (t, id).
//
// What bounds it on this card: the walk's chain of dependent steps for each
// ray (slab tests on boxes from L1, ballots, shuffles, the slot rows from
// L2, the warp minimum); the operations (20 FLOP a slab test, 24 a sphere
// pair, 46 a triangle pair) and the bytes are far below the card's rates
// (PERF.md).  A warp's rays run one after another, so the launch's time is
// that of its longest chain of rays unless enough warps are resident to
// overlap them: the launch gives each warp 32 rays only when there are
// enough rays to fill every resident warp that way, and fewer (down to
// one) otherwise, so that a wavefront of 65,536 rays still fills the card.
#include <algorithm>
#include <atomic>

#include <cuda_runtime.h>

#include "cluster_walk.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
cluster_nearest_kernel(const float* __restrict__ rays, int n, int per_warp, rt::ClusterSet sph,
                       rt::ClusterSet tri, float t_min, float t_max, int backface_cull,
                       float* __restrict__ t_out, int* __restrict__ idx_out) {
  const int lane = threadIdx.x & 31;
  const int warps = gridDim.x * (kThreads / 32);
  const bool cull = backface_cull != 0;
  for (int w = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5); w * per_warp < n; w += warps) {
    const int i = w * per_warp + lane;
    const bool mine = lane < per_warp && i < n;
    const int k = mine ? i : n - 1;
    const float ox = rays[k], oy = rays[n + k], oz = rays[2 * n + k];
    const float dx = rays[3 * n + k], dy = rays[4 * n + k], dz = rays[5 * n + k];
    float t = rt::BIG;
    int idx = -1;
    rt::warp_walk_rays(sph, tri, __ballot_sync(rt::kFullMask, mine), ox, oy, oz, dx, dy, dz,
                       t_min, t_max, cull, lane, t, idx);
    if (mine) {
      t_out[i] = t;
      idx_out[i] = idx;
    }
  }
}

rt::ClusterSet make_set(const float* supers, int n_supers, const float* clusters,
                        int n_clusters, const float* slots, const int* live, const int* prim,
                        float reach_lin, float reach_sq, int id_base) {
  return rt::ClusterSet{supers, clusters, slots, live, prim, n_supers, n_clusters,
                        (long long)n_clusters * rt::kClusterSlots, id_base, reach_lin,
                        reach_sq};
}

std::atomic<int> resident[rt::kMaxDevices];  // cluster_nearest_kernel's grid per device

cudaError_t launch(const float* rays, int n, const rt::ClusterSet& sph, const rt::ClusterSet& tri,
                   float t_min, float t_max, int backface_cull, float* t_out, int* idx_out,
                   cudaStream_t stream) {
  int fit = 0;
  const cudaError_t e = rt::resident_blocks(cluster_nearest_kernel, kThreads, resident, fit);
  if (e != cudaSuccess) return e;
  // Rays a warp: as many as it takes for the resident warps to hold them
  // all, at most 32; then only as many blocks as those rays need.
  const long long warps = (long long)fit * (kThreads / 32);
  const int per_warp = (int)std::min<long long>(32, std::max<long long>(1, (n + warps - 1) / warps));
  const long long want = ((long long)n + per_warp * kThreads / 32 - 1) / (per_warp * kThreads / 32);
  cluster_nearest_kernel<<<(int)std::min<long long>(want, fit), kThreads, 0, stream>>>(
      rays, n, per_warp, sph, tri, t_min, t_max, backface_cull, t_out, idx_out);
  return cudaGetLastError();
}

}  // namespace

// C entry point (ctypes).  Every pointer is device memory: rays f32[8, n];
// per kind the super and cluster AABBs f32[., 8] (16-byte aligned), the
// slot table f32[rows, n_clusters * 128], each cluster's live count
// i32[n_clusters] (its last live slot + 1), each slot's primitive id
// i32[n_clusters * 128] (ties of t go to the lowest) and the two widening
// factors of its boxes (cluster_ops.cluster_args: SPHERE_REACH and
// sphere_reach for spheres, 0 for triangles).  Launches on `stream` and
// returns the CUDA error of the launch (0 on success); it neither allocates
// nor synchronizes.
extern "C" int rt_cluster_nearest(const float* rays, int n, const float* sph_super,
                                  int n_sph_super, const float* sph_cluster, int n_sph_cluster,
                                  const float* sph_slots, const int* sph_live,
                                  const int* sph_prim, float sph_reach_lin,
                                  float sph_reach_sq, int sph_base,
                                  const float* tri_super, int n_tri_super,
                                  const float* tri_cluster, int n_tri_cluster,
                                  const float* tri_slots, const int* tri_live,
                                  const int* tri_prim, float tri_reach_lin,
                                  float tri_reach_sq, int tri_base,
                                  float t_min, float t_max, int backface_cull, float* t_out,
                                  int* idx_out, cudaStream_t stream) {
  if (n <= 0) return 0;
  const rt::ClusterSet sph = make_set(sph_super, n_sph_super, sph_cluster, n_sph_cluster,
                                      sph_slots, sph_live, sph_prim, sph_reach_lin, sph_reach_sq,
                                      sph_base);
  const rt::ClusterSet tri = make_set(tri_super, n_tri_super, tri_cluster, n_tri_cluster,
                                      tri_slots, tri_live, tri_prim, tri_reach_lin, tri_reach_sq,
                                      tri_base);
  return static_cast<int>(
      launch(rays, n, sph, tri, t_min, t_max, backface_cull, t_out, idx_out, stream));
}
