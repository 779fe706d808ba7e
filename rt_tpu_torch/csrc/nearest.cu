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
// Design.  One thread owns one ray and keeps (best_t, best_i) in registers.
// The block stages the sphere table through shared memory, kTile float4
// (center xyz, radius) at a time; every thread then reads the same sphere,
// a broadcast without bank conflicts.  Spheres past the table's end load as
// radius 0, which is never a hit, as the Pallas wrapper pads them.  A strict
// `<` scan in sphere order keeps the first of equal minima, which is what
// the Pallas kernel's per-chunk lowest-id select plus strictly-nearer merge
// gives.  The arithmetic is `_kernel`'s, operation for operation; with
// -fmad=false and IEEE division and sqrt it rounds exactly as the plain
// version does.
//
// What bounds it on this card: about 25 FLOPs per (ray, sphere) pair and
// nothing else: the rays are read once and the table comes from shared
// memory.  Left for later: several rays per thread to reuse each shared
// load, and a BVH in place of the brute force.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 128;  // threads per block and spheres per tile
constexpr float kBig = 3.0e38f;

__global__ void __launch_bounds__(kTile)
sphere_nearest_kernel(const float* __restrict__ org, long long org_ray_step,
                      long long org_comp_step, const float* __restrict__ dir,
                      long long dir_ray_step, long long dir_comp_step, int n,
                      const float4* __restrict__ sph, int n_sph, float t_min,
                      float t_max, float* __restrict__ t_out,
                      int* __restrict__ idx_out) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kTile + threadIdx.x;
  const bool live = i < n;
  // Lanes past the last ray keep direction (1,1,1), as the Pallas wrapper
  // pads them, so 1/a stays finite; they write nothing.
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 1.0f, dy = 1.0f, dz = 1.0f;
  if (live) {
    const float* o = org + i * org_ray_step;
    const float* d = dir + i * dir_ray_step;
    ox = o[0];
    oy = o[org_comp_step];
    oz = o[2 * org_comp_step];
    dx = d[0];
    dy = d[dir_comp_step];
    dz = d[2 * dir_comp_step];
  }
  const float a = dx * dx + dy * dy + dz * dz;
  const float inv_a = 1.0f / a;
  float best_t = kBig;
  int best_i = -1;
  for (int base = 0; base < n_sph; base += kTile) {
    const int j = base + threadIdx.x;
    tile[threadIdx.x] = j < n_sph ? sph[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();
    const int m = min(kTile, n_sph - base);
#pragma unroll 4
    for (int k = 0; k < m; ++k) {
      const float4 s = tile[k];
      const float ocx = s.x - ox, ocy = s.y - oy, ocz = s.z - oz;
      const float h = dx * ocx + dy * ocy + dz * ocz;
      const float c = ocx * ocx + ocy * ocy + ocz * ocz - s.w * s.w;
      const float disc = h * h - a * c;
      const float sd = sqrtf(fmaxf(disc, 0.0f));
      const float t0 = (h - sd) * inv_a;
      const float t1 = (h + sd) * inv_a;
      const float t = t0 >= t_min ? t0 : t1;
      if (disc >= 0.0f && s.w > 0.0f && t >= t_min && t < t_max && t < best_t) {
        best_t = t;
        best_i = base + k;
      }
    }
    __syncthreads();
  }
  if (live) {
    t_out[i] = best_t;
    idx_out[i] = best_i;
  }
}

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
  const int blocks = (n + kTile - 1) / kTile;
  sphere_nearest_kernel<<<blocks, kTile, 0, stream>>>(
      org, org_ray_step, org_comp_step, dir, dir_ray_step, dir_comp_step, n,
      reinterpret_cast<const float4*>(sph), n_sph, t_min, t_max, t_out, idx_out);
  return static_cast<int>(cudaGetLastError());
}
