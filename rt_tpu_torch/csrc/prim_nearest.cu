// Nearest sphere or triangle per ray for Hopper (sm_90a): K3 and K3b.
//
// Replaces the TPU kernels launched by rt_tpu/pallas_ops.py's
// `prim_nearest_shaded` (K3, pallas_call at :936, body `_prim_shade_kernel`
// :876) and `prim_nearest_packed` (K3b, :270, body `_prim_kernel` :143).
// Both compute, for every ray of the persistent wavefront's pool, the
// nearest hit over the spheres and then the triangles of a flat scene: t
// (BIG = 3e38 on a miss) and the global primitive id (spheres first,
// triangles from n_spheres; -1 on a miss).  K3 also writes the winner's
// column of the shade table, params[f * N + i] = table[f * P + max(id, 0)]
// (zero for an id past the table's end), which the bounce's shading reads
// instead of fetching it.  One kernel serves both: a null table pointer is
// K3b.  The plain PyTorch versions are `prim_ops.prim_nearest_packed_plain`
// and `prim_ops.prim_nearest_shaded_plain`.
//
// What bounds it on this card: arithmetic, ~18 floating-point operations
// for a (ray, sphere) pair the discriminant rejects (brute_force.cuh) and
// ~46 for a (ray, triangle) pair; the rays are read once, the tables come
// from shared memory, and the only large transfer is K3's params write (160
// bytes a ray).  The first port gave a ray to one thread: 65,536 rays made
// 512 blocks of 128, a quarter of the card's thread slots, and each thread
// ran ~450 pair tests in series.
//
// Design.  A group of kGroup lanes takes one ray, so the pool's rays fill
// the card kGroup times over.  The block stages the sphere table (one
// float4 a row) and then the triangle table (three float4 a row: a xyz
// e1.x | e1.yz e2.xy | e2.z live pad pad) through shared memory, kThreads
// rows at a time; lane g of a group tests rows g, g + kGroup, ... of each
// tile (32 rows, one `sphere_batch` of the shared late-sqrt test), keeping
// its own best with a strict `<` scan from (BIG, -1).  The group's winner
// is the least packed key (order_key(t), id) of a shuffle reduction
// (brute_force.cuh `group_nearest`, shared with K2), which is the
// sequential scan's result; spheres have the lower ids, so a triangle wins
// only when strictly nearer.  Last, the block writes its
// kRays rays' t and id, and K3's 40 shade columns f-major, with coalesced
// stores: kRays consecutive floats of each column row.  The TPU's one-hot
// product, which exists to feed its matrix unit, and its (8, 128) tiling
// are not carried over.
#include <cstdint>

#include <cuda_runtime.h>

#include "brute_force.cuh"

namespace {

using rt::BIG;

constexpr int kThreads = 256;               // threads per block and table rows per tile
constexpr int kGroup = 8;                   // lanes per ray
constexpr int kRays = kThreads / kGroup;    // rays per block

template <bool kFetch>
__global__ void __launch_bounds__(kThreads)
prim_nearest_kernel(const float* __restrict__ rays, int n,
                    const float4* __restrict__ sph, int s_rows,
                    const float4* __restrict__ tri, int t_rows, int n_spheres,
                    float t_min, float t_max, int backface_cull,
                    const float* __restrict__ table, int f_rows, int p_cols,
                    float* __restrict__ t_out, int* __restrict__ idx_out,
                    float* __restrict__ params) {
  __shared__ float4 tile[3 * kThreads];
  __shared__ float win_t[kRays];
  __shared__ int win_i[kRays];
  const int g = threadIdx.x % kGroup;  // the lane's place in its ray's group
  const int slot = threadIdx.x / kGroup;
  const int first = blockIdx.x * kRays;
  const int i = first + slot;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 1.0f, dy = 1.0f, dz = 1.0f;
  if (i < n) {
    ox = rays[i];
    oy = rays[n + i];
    oz = rays[2 * n + i];
    dx = rays[3 * n + i];
    dy = rays[4 * n + i];
    dz = rays[5 * n + i];
  }
  const rt::PairRay r = rt::pair_ray(ox, oy, oz, dx, dy, dz);
  const bool cull = backface_cull != 0;
  float best_t = BIG;
  int best_i = -1;

  for (int base = 0; base < s_rows; base += kThreads) {
    const int j = base + threadIdx.x;
    tile[threadIdx.x] = j < s_rows ? sph[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();
    const int m = min(kThreads, s_rows - base);
    rt::sphere_batch([&](int b) { return tile[g + kGroup * b]; }, (m - g + kGroup - 1) / kGroup,
                     base + g, kGroup, r, t_min, t_max, best_t, best_i);
    __syncthreads();
  }
  for (int base = 0; base < t_rows; base += kThreads) {
    const int j = base + threadIdx.x;
#pragma unroll
    for (int q = 0; q < 3; ++q)
      tile[3 * threadIdx.x + q] =
          j < t_rows ? tri[3 * j + q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();
    const int m = min(kThreads, t_rows - base);
    for (int k = g; k < m; k += kGroup) {
      float t;
      if (rt::triangle_pair(tile[3 * k], tile[3 * k + 1], tile[3 * k + 2], r, cull, t_min, t_max,
                            t) &&
          t < best_t) {
        best_t = t;
        best_i = n_spheres + base + k;
      }
    }
    __syncthreads();
  }

  rt::group_nearest<kGroup>(best_t, best_i);
  if (g == 0) {
    win_t[slot] = best_t;
    win_i[slot] = best_i;
  }
  __syncthreads();

  const int nr = min(kRays, n - first);
  if (threadIdx.x < nr) {
    t_out[first + threadIdx.x] = win_t[threadIdx.x];
    idx_out[first + threadIdx.x] = win_i[threadIdx.x];
  }
  if (kFetch) {
    for (int e = threadIdx.x; e < f_rows * kRays; e += kThreads) {
      const int f = e / kRays, k = e % kRays;
      if (k >= nr) continue;
      const int col = max(win_i[k], 0);
      params[(long long)f * n + first + k] =
          col < p_cols ? table[(long long)f * p_cols + col] : 0.0f;
    }
  }
}

}  // namespace

// C entry point (ctypes).  `table` null launches K3b (no params).  Launches
// on `stream` and returns the CUDA error of the launch (0 on success); it
// neither allocates nor synchronizes.
extern "C" int rt_prim_nearest(const float* rays, int n, const float* sph, int s_rows,
                               const float* tri, int t_rows, int n_spheres, float t_min,
                               float t_max, int backface_cull, const float* table,
                               int f_rows, int p_cols, float* t_out, int* idx_out,
                               float* params, cudaStream_t stream) {
  if (n <= 0) return 0;
  const int blocks = (n + kRays - 1) / kRays;
  const float4* s4 = reinterpret_cast<const float4*>(sph);
  const float4* t4 = reinterpret_cast<const float4*>(tri);
  if (table != nullptr) {
    prim_nearest_kernel<true><<<blocks, kThreads, 0, stream>>>(
        rays, n, s4, s_rows, t4, t_rows, n_spheres, t_min, t_max, backface_cull, table,
        f_rows, p_cols, t_out, idx_out, params);
  } else {
    prim_nearest_kernel<false><<<blocks, kThreads, 0, stream>>>(
        rays, n, s4, s_rows, t4, t_rows, n_spheres, t_min, t_max, backface_cull, nullptr,
        0, 0, t_out, idx_out, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}
