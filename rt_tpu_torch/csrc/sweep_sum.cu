// The progressive renderer's sum of a sweep into its accumulator, for
// Hopper (sm_90a): accum[e] = accum[e] + colors[e] * ns over the sweep's
// 3 * H * W floats, in place on the card.
//
// Replaces no TPU kernel: the JAX package (rt_tpu/progressive.py) and the
// CPU path of the port sum each sweep on the host in numpy or torch, after
// copying the sweep's colours off the device.  On the card that host sum of
// a 1080p sweep (25 MB) took 7-11 ms on one CPU thread while the device
// waited; this kernel does it beside the colours, so the host receives only
// the finished sum.
//
// Arithmetic: two rounded operations, __fmul_rn then __fadd_rn, as numpy's
// `accum += colors * ns` rounds them (and -fmad=false besides), so the
// accumulator is bit-equal to the host's.  The intrinsics also keep the
// compiler from contracting the two into one fused multiply-add.
//
// What bounds it: bytes.  It reads colors and accum once and writes accum
// once, 12 bytes a float, 75 MB a 1080p sweep: ~22 us at 3.35 TB/s.  Its
// design is a grid-stride loop over float4s (16-byte loads and stores,
// neighbouring threads on neighbouring addresses), one grid of the blocks
// resident on the card, and a scalar tail for lengths not divisible by 4.
// The wrapper (progressive.accumulate_sweep) checks that both pointers are
// 16-byte aligned.
#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

#include "rt_common.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    sweep_sum_kernel(const float* __restrict__ colors, float* __restrict__ accum, long long n,
                     int ns) {
  const float s = static_cast<float>(ns);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long n4 = n / 4;
  const float4* c4 = reinterpret_cast<const float4*>(colors);
  float4* a4 = reinterpret_cast<float4*>(accum);
  for (long long i = first; i < n4; i += stride) {
    const float4 c = c4[i];
    float4 a = a4[i];
    a.x = __fadd_rn(a.x, __fmul_rn(c.x, s));
    a.y = __fadd_rn(a.y, __fmul_rn(c.y, s));
    a.z = __fadd_rn(a.z, __fmul_rn(c.z, s));
    a.w = __fadd_rn(a.w, __fmul_rn(c.w, s));
    a4[i] = a;
  }
  for (long long i = 4 * n4 + first; i < n; i += stride) {
    accum[i] = __fadd_rn(accum[i], __fmul_rn(colors[i], s));
  }
}

std::atomic<int> resident[rt::kMaxDevices];  // sweep_sum_kernel's grid per device

}  // namespace

// C entry point (ctypes).  Adds colors[0, n) * ns into accum[0, n) on
// `stream` and returns the CUDA error of the launch (0 on success); it
// neither allocates nor synchronizes.  Both pointers 16-byte aligned.
extern "C" int rt_sweep_accumulate(const float* colors, float* accum, long long n, int ns,
                                   cudaStream_t stream) {
  if (n <= 0) return 0;
  int fit = 0;
  const cudaError_t e = rt::resident_blocks(sweep_sum_kernel, kThreads, resident, fit);
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long need = (n / 4 + kThreads - 1) / kThreads;
  const int blocks = need < 1 ? 1 : (need < fit ? static_cast<int>(need) : fit);
  sweep_sum_kernel<<<blocks, kThreads, 0, stream>>>(colors, accum, n, ns);
  return static_cast<int>(cudaGetLastError());
}
