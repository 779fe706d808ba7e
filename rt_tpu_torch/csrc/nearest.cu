// Nearest sphere per ray for Hopper (sm_90a): K2 and K2b.
//
// Replaces the TPU kernel body `_kernel` of rt_tpu/pallas_ops.py (:38),
// launched by `sphere_nearest` (K2, pallas_call at :123) and
// `sphere_nearest_packed` (K2b, :313).  Both compute, for every ray, the
// nearest sphere hit in [t_min, t_max): t (BIG = 3e38 on a miss) and the
// sphere id (-1 on a miss), the lowest id winning among equal t.  The two
// entry points differ only in the layout of the rays, so one kernel serves
// both: it reads ray i's component k at base[i * ray_step + k * comp_step]
// (origins [N,3]: steps (3, 1); packed rays [8,N] or their transposed views:
// steps (1, N)).  The plain PyTorch version is
// `nearest_ops.sphere_nearest_packed_plain`.
//
// What bounds it on this card: arithmetic, ~18 floating-point operations
// for a (ray, sphere) pair the discriminant rejects and 6 more for one it
// admits (brute_force.cuh); the rays are read once and t and id written
// once, and the table comes from shared memory.  Under -fmad=false no
// multiply fuses with an add, so the test runs at about half the card's
// 67 TFLOP/s FP32 peak.  The first port gave a ray to one thread: 90,000
// rays made 704 blocks of 128, a third of the card's thread slots; each
// thread took the square root and both roots of every pair in series, and
// each block restaged the table in 128-row tiles.
//
// Design.  A group of kGroup lanes takes one ray, as in K3
// (prim_nearest.cu): lane g of the group tests rows g, g + kGroup, ... of
// the table in batches of 32 (`sphere_batch`, the late-sqrt test), keeping
// its own best with a strict `<` scan from (BIG, -1), and `group_nearest`
// takes the least packed key (order_key(t), id) over the group, which is
// the sequential scan's result (brute_force.cuh).  The grid is persistent:
// as many blocks as fit on the card at once, each looping over batches of
// kRays rays.  A table of up to kTableRows rows (447 for the bench scene)
// is staged in shared memory once per block, so the loop over batches runs
// without a barrier; a larger table is staged kTableRows rows at a time
// for every batch.  Each lane reads its group's ray; the lane of the group
// that leads it writes t and id.  The TPU's one-hot product and its
// (8, 128) tiling are not carried over.
#include <atomic>

#include <cuda_runtime.h>

#include "brute_force.cuh"

namespace {

using rt::BIG;

constexpr int kThreads = 256;             // threads per block
constexpr int kGroup = 4;                 // lanes per ray
constexpr int kRays = kThreads / kGroup;  // rays per batch
constexpr int kTableRows = 1024;          // sphere rows staged in shared memory at once

__global__ void __launch_bounds__(kThreads)
sphere_nearest_kernel(const float* __restrict__ org, long long org_ray_step,
                      long long org_comp_step, const float* __restrict__ dir,
                      long long dir_ray_step, long long dir_comp_step, int n,
                      const float4* __restrict__ sph, int n_sph, float t_min,
                      float t_max, float* __restrict__ t_out,
                      int* __restrict__ idx_out) {
  __shared__ float4 table[kTableRows];
  const int g = threadIdx.x % kGroup;  // the lane's place in its ray's group
  const int slot = threadIdx.x / kGroup;
  const bool whole = n_sph <= kTableRows;
  if (whole) {
    for (int j = threadIdx.x; j < n_sph; j += kThreads) table[j] = sph[j];
    __syncthreads();
  }
  const int batches = (n + kRays - 1) / kRays;
  for (int batch = blockIdx.x; batch < batches; batch += gridDim.x) {
    const int i = batch * kRays + slot;
    // Lanes past the last ray keep direction (1,1,1), as the Pallas wrapper
    // pads them, so 1/a stays finite; they write nothing.
    float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 1.0f, dy = 1.0f, dz = 1.0f;
    if (i < n) {
      const float* o = org + i * org_ray_step;
      const float* d = dir + i * dir_ray_step;
      ox = o[0];
      oy = o[org_comp_step];
      oz = o[2 * org_comp_step];
      dx = d[0];
      dy = d[dir_comp_step];
      dz = d[2 * dir_comp_step];
    }
    const rt::PairRay r = rt::pair_ray(ox, oy, oz, dx, dy, dz);
    float best_t = BIG;
    int best_i = -1;
    // Lane g's strict `<` scan of rows g, g + kGroup, ... of the table's m
    // rows, whose ids start at id0.
    const auto scan = [&](int m, int id0) {
      for (int b0 = g; b0 < m; b0 += 32 * kGroup) {
        rt::sphere_batch([&](int b) { return table[b0 + kGroup * b]; },
                         min(32, (m - b0 + kGroup - 1) / kGroup), id0 + b0, kGroup, r, t_min,
                         t_max, best_t, best_i);
      }
    };
    if (whole) {
      scan(n_sph, 0);
    } else {
      for (int base = 0; base < n_sph; base += kTableRows) {
        const int m = min(kTableRows, n_sph - base);
        __syncthreads();  // the last tile's readers are done
        for (int j = threadIdx.x; j < m; j += kThreads) table[j] = sph[base + j];
        __syncthreads();
        scan(m, base);
      }
    }
    rt::group_nearest<kGroup>(best_t, best_i);
    if (g == 0 && i < n) {
      t_out[i] = best_t;
      idx_out[i] = best_i;
    }
  }
}

std::atomic<int> resident[rt::kMaxDevices];  // sphere_nearest_kernel's grid per device

}  // namespace

// C entry point (ctypes).  Launches on `stream` and returns the CUDA error
// of the launch (0 on success); it neither allocates nor synchronizes.
extern "C" int rt_sphere_nearest(const float* org, long long org_ray_step,
                                 long long org_comp_step, const float* dir,
                                 long long dir_ray_step, long long dir_comp_step,
                                 int n, const float* sph, int n_sph, float t_min,
                                 float t_max, float* t_out, int* idx_out,
                                 cudaStream_t stream) {
  if (n <= 0) return 0;
  int fit = 0;
  const cudaError_t e = rt::resident_blocks(sphere_nearest_kernel, kThreads, resident, fit);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int batches = (n + kRays - 1) / kRays;
  sphere_nearest_kernel<<<batches < fit ? batches : fit, kThreads, 0, stream>>>(
      org, org_ray_step, org_comp_step, dir, dir_ray_step, dir_comp_step, n,
      reinterpret_cast<const float4*>(sph), n_sph, t_min, t_max, t_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
