// Shared code of the port's CUDA kernels: the per-frame parameter block,
// the counter-hash RNG, the Halton sequence, the order key of a distance,
// and the grid of a persistent launch.
//
// The hash and Halton functions reproduce the JAX package bit for bit
// (rng.py, sampling.py): their values feed branch decisions (Russian
// roulette, Fresnel, jitter), so an ulp of drift would fork whole paths.
// Build with -fmad=false and without --use_fast_math so that a*b+c stays
// two rounded operations, as in the plain PyTorch version.
#pragma once

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace rt {

constexpr float BIG = 3.0e38f;  // miss sentinel (fast_shade.BIG)
constexpr int F_ROWS = 40;      // shade-table columns per primitive
constexpr unsigned kFullMask = 0xffffffffu;

// Shade-table columns (fast_shade.py F_*).
enum : int {
  F_IS_SPHERE = 0, F_AX = 1, F_AY = 2, F_AZ = 3, F_RADIUS = 4,
  F_NX = 5, F_NY = 6, F_NZ = 7, F_MAT_KIND = 8, F_FUZZ = 9, F_IOR = 10,
  F_TEX_KIND = 11, F_INV_SCALE = 12, F_CE = 13, F_CO = 16, F_RECT = 19,
  F_BX = 23, F_BY = 24, F_BZ = 25, F_CX = 26, F_CY = 27, F_CZ = 28,
  F_UVA = 29, F_CYW = 35, F_SYW = 36, F_CP = 37, F_SP = 38,
};

// Static switches of a launch (megakernel.py FLAG_*).
enum : int {
  FLAG_BACKFACE_CULL = 1,
  FLAG_SHARED_JITTER = 2,
  FLAG_DEFOCUS = 4,
  FLAG_COS_GAMMA_AS_ANGLE = 8,
  FLAG_HOSEK = 16,
  FLAG_UV_BBOX_REMAP = 32,
  FLAG_IMAGES = 64,
};

// Per-frame float parameters: 80 floats, laid out as megakernel.py's
// _P_* offsets.  Passed by value, so they live in the constant bank.
struct Params {
  float pix00[3], du[3], dv[3], dku[3], dkv[3], center[3], sun[3];  // 0..20
  float coef_y[5], coef_x[5], coef_yc[5];                           // 21..35
  float zy, zx, zyc, pad0;                                          // 36..39
  float hw[30];  // Hosek (A..I, scale * exposure) per channel      // 40..69
  float t_min, t_max, origin_offset, rr_clamp;                      // 70..73
  float white_scale, inv_spp;                                       // 74..75
  float pad1[4];                                                    // 76..79
};
static_assert(sizeof(Params) == 80 * sizeof(float), "Params must match _P_* offsets");

// Per-launch integers.
struct Ints {
  int n_pixels, pixel_base, spp, sample_offset;
  uint32_t seed;
  int width, n_global, max_depth;
  int n_spheres, n_tris, atlas_h, atlas_w;
  int flags;
};

// murmur3 fmix32 finalizer (rng.mix).
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// rng.hash_u32: four 32-bit streams over a Weyl sequence.
__device__ __forceinline__ uint32_t hash_u32(uint32_t seed, uint32_t a, uint32_t b, uint32_t c) {
  const uint32_t w = 0x9E3779B9u;
  uint32_t h = mix32(seed + w * 1u);
  h = mix32(h ^ (a + w * 2u));
  h = mix32(h ^ (b + w * 3u));
  return mix32(h ^ (c + w * 4u));
}

// rng.uniform: f32 in [0, 1) with a full 24-bit mantissa.
__device__ __forceinline__ float uniform01(uint32_t seed, uint32_t a, uint32_t b, uint32_t c) {
  return __uint2float_rn(hash_u32(seed, a, b, c) >> 8) * 5.9604645e-8f;
}

// sampling.radical_inverse_base2: 32-bit reversal; one rounding u32 -> f32.
__device__ __forceinline__ float radical2(uint32_t pos) {
  return __uint2float_rn(__brev(pos)) * 2.3283064365386963e-10f;
}

// sampling.radical_inverse(3, .): 21 digits accumulated in the JAX order.
__device__ __forceinline__ float radical3(uint32_t pos) {
  const float inv3 = (float)(1.0 / 3.0);
  float result = 0.0f;
  float scale = inv3;
#pragma unroll 1
  for (int k = 0; k < 21; ++k) {
    result = result + __uint2float_rn(pos % 3u) * scale;
    scale = scale * inv3;
    pos /= 3u;
  }
  return result;
}

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// An unsigned that orders like t (-0 taken as +0): the usual flip of a
// signed float's bits.  A minimum over (order_key(t), id) is the first of
// the least t, as a strict-`<` scan in ascending id finds it.
__device__ __forceinline__ unsigned order_key(float t) {
  const unsigned b = t == 0.0f ? 0u : __float_as_uint(t);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// jnp.sign: -1, 0 or 1.
__device__ __forceinline__ float signf(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : 0.0f);
}

// Blocks of `kernel` (`threads` a block, no dynamic shared memory) that fit
// on the current device at once: the grid of a persistent launch.  Asked of
// the runtime once a device; `cache` (zero-initialised, one per kernel)
// keeps the answer, so a launch costs no query.
constexpr int kMaxDevices = 64;

template <class Kernel>
inline cudaError_t resident_blocks(Kernel kernel, int threads, std::atomic<int> (&cache)[kMaxDevices],
                                   int& blocks) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < kMaxDevices && (blocks = cache[dev].load(std::memory_order_relaxed)) > 0) {
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  blocks = per_sm * sms;
  if (dev < kMaxDevices) cache[dev].store(blocks, std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace rt
