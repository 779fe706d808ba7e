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
// Design.  One thread owns one ray and keeps (best_t, best_i) in registers;
// the ray's six components come from the [8, N] rows, so neighbouring
// threads read neighbouring addresses.  The block stages the sphere table
// (one float4 a row) and then the triangle table (three float4 a row: a xyz
// e1.x | e1.yz e2.xy | e2.z live pad pad) through shared memory, kThreads
// rows at a time; every thread then reads the same row, a broadcast.  A row
// that can never be hit (radius <= 0, live <= 0.5) is skipped by all threads
// alike, which leaves the result unchanged: those conditions are part of the
// hit test.  Scanning spheres then triangles with a strict `<` gives the
// Pallas kernel's result: the lowest id among equal t within each kind, and
// a triangle only when strictly nearer than every sphere.  The fetch is a
// direct load per row f of the table (which stays in L1 and L2), each row's
// stores coalesced.  The TPU's one-hot product, which exists to feed its
// matrix unit, and its (8, 128) tiling are not carried over.  The
// arithmetic is `_prim_kernel`'s, operation for operation; built with
// -fmad=false and IEEE division and sqrt it rounds exactly as the plain
// version does.
//
// What bounds it on this card: arithmetic.  24 floating-point operations
// per (ray, sphere) pair and 46 per (ray, triangle) pair; the rays are read
// once, the tables come from shared memory, and the only large transfer is
// K3's params write (160 bytes a ray).  At the bench pool (65,536 rays x 447
// spheres) that is ~0.7 GFLOP against ~13 MB.  Left for later: several rays
// per thread or several threads per ray (the pool fills only a quarter of
// the card's thread slots), and a BVH in place of the brute force.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // threads per block and table rows per tile
constexpr float kBig = 3.0e38f;
constexpr float kTriEps = 1.0e-7f;

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
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  float ox = 0.0f, oy = 0.0f, oz = 0.0f, dx = 1.0f, dy = 1.0f, dz = 1.0f;
  if (live) {
    ox = rays[i];
    oy = rays[n + i];
    oz = rays[2 * n + i];
    dx = rays[3 * n + i];
    dy = rays[4 * n + i];
    dz = rays[5 * n + i];
  }
  const float a = dx * dx + dy * dy + dz * dz;
  const float inv_a = 1.0f / a;
  float best_t = kBig;
  int best_i = -1;

  // Spheres (hittable.rs:318-338): the half-b quadratic, near root else far.
  for (int base = 0; base < s_rows; base += kThreads) {
    const int j = base + threadIdx.x;
    tile[threadIdx.x] = j < s_rows ? sph[j] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();
    const int m = min(kThreads, s_rows - base);
    for (int k = 0; k < m; ++k) {
      const float4 s = tile[k];
      if (!(s.w > 0.0f)) continue;  // pad row: never a hit
      const float ocx = s.x - ox, ocy = s.y - oy, ocz = s.z - oz;
      const float h = dx * ocx + dy * ocy + dz * ocz;
      const float c = ocx * ocx + ocy * ocy + ocz * ocz - s.w * s.w;
      const float disc = h * h - a * c;
      const float sd = sqrtf(fmaxf(disc, 0.0f));
      const float t0 = (h - sd) * inv_a;
      const float t1 = (h + sd) * inv_a;
      const float t = t0 >= t_min ? t0 : t1;
      if (disc >= 0.0f && t >= t_min && t < t_max && t < best_t) {
        best_t = t;
        best_i = base + k;
      }
    }
    __syncthreads();
  }

  // Triangles (hittable.rs:411-461): Möller–Trumbore with the det cull.
  for (int base = 0; base < t_rows; base += kThreads) {
    const int j = base + threadIdx.x;
#pragma unroll
    for (int q = 0; q < 3; ++q)
      tile[3 * threadIdx.x + q] =
          j < t_rows ? tri[3 * j + q] : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    __syncthreads();
    const int m = min(kThreads, t_rows - base);
    for (int k = 0; k < m; ++k) {
      const float4 r0 = tile[3 * k], r1 = tile[3 * k + 1], r2 = tile[3 * k + 2];
      if (!(r2.y > 0.5f)) continue;  // pad row: never a hit
      const float ax = r0.x, ay = r0.y, az = r0.z;
      const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
      const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
      const float uvx = dy * e2z - dz * e2y;
      const float uvy = dz * e2x - dx * e2z;
      const float uvz = dx * e2y - dy * e2x;
      const float det = e1x * uvx + e1y * uvy + e1z * uvz;
      const bool det_ok = backface_cull ? det > kTriEps : fabsf(det) > kTriEps;
      const float inv_det = 1.0f / (det_ok ? det : 1.0f);
      const float aox = ox - ax, aoy = oy - ay, aoz = oz - az;
      const float u = (aox * uvx + aoy * uvy + aoz * uvz) * inv_det;
      const float vvx = aoy * e1z - aoz * e1y;
      const float vvy = aoz * e1x - aox * e1z;
      const float vvz = aox * e1y - aoy * e1x;
      const float v = (dx * vvx + dy * vvy + dz * vvz) * inv_det;
      const float t = (e2x * vvx + e2y * vvy + e2z * vvz) * inv_det;
      if (det_ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f &&
          t >= t_min && t < t_max && t > kTriEps && t < best_t) {
        best_t = t;
        best_i = n_spheres + base + k;
      }
    }
    __syncthreads();
  }

  if (!live) return;
  t_out[i] = best_t;
  idx_out[i] = best_i;
  if (kFetch) {
    const int col = max(best_i, 0);
    const bool inside = col < p_cols;
    for (int f = 0; f < f_rows; ++f)
      params[(long long)f * n + i] = inside ? table[(long long)f * p_cols + col] : 0.0f;
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
  const int blocks = (n + kThreads - 1) / kThreads;
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
