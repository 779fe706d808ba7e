// Microbenchmarks of the primitives of K5's expansion sweep, for Hopper
// (sm_90a): K6.
//
// Replaces the TPU kernels that tools/micro_probe.py launches through
// `run` (pallas_call at :167): the bodies `reduce_kernel` (:41), the
// item -> ray winner reduction; `gather_kernel` (:66), the per-visit gather
// of 8 rays and the 128-lane sphere intersect, in five modes; and
// `scatter_kernel` (:131), the byte-plane OR-scatter of per-chunk one-hot
// products.  Each kernel takes a rep count and loops its work inside the
// launch, so that the probe's slope between two rep counts is the cost of
// the work and not of the launch.  Each computes what the TPU body computes:
// the (8, 128) f32 plane filled with `acc`, and the state the body leaves
// in its scratch, whose initial value the caller supplies.  The plain
// PyTorch versions are in micro_probe.py.
//
// A rep's work would be loop-invariant, so each rep's loads depend on the
// previous rep's result through `x & zero`, where `zero` is a launch
// argument that is 0: the compiler cannot hoist them, and the reps run in
// order, as the TPU's do.
//
// What bounds them on this card: reduce, the shared-memory 64-bit atomics
// of one block (one per item); gather, the latency of the dependent loads
// item -> ray -> slot block and the warp's shuffle reduction; scatter, the
// latency of a rep's two steps and two barriers in each block: one scan of
// the chunk's 8 x K x 128 destinations, then each output's sum over the
// few lanes that name its column.  The first port gave each column a
// thread that compared all 8 x K x 128 destinations with it, the one-hot
// planes the TPU builds for its matrix unit, one by one: ~2,000 times its
// bound.
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kNI = 8192;   // items; visits are kNI / 8
constexpr int kR = 1024;    // rays: one (8, 128) plane
constexpr int kMaxRows = 8; // scatter's value rows per plane

enum Mode : int { FULL = 0, NOMATH = 1, NOGATHER = 2, NOSLOT = 3, UNALIGNED = 4 };

// reduce: one block, one thread per ray of the (8, 128) plane.  A ray's
// (best, bi) live in one 64-bit word, (key ^ 0x80000000) << 32 | (item + 1),
// so that one atomicMin keeps the smallest key and, among equal keys, the
// first item: the sequential loop's strict `<` winner.  The low word 0 is
// the initial value's, which therefore wins a tie with any item, as the
// strict `<` keeps it.
__global__ void __launch_bounds__(kR)
reduce_kernel(const int* rid, const int* key, int reps, int n, int unroll, int zero,
              const int* best_in, const int* bi_in, float* out, int* best_out, int* bi_out) {
  __shared__ unsigned long long packed[kR];
  __shared__ unsigned int acc;
  const int t = threadIdx.x;
  packed[t] = static_cast<unsigned long long>(static_cast<unsigned>(best_in[t]) ^ 0x80000000u)
              << 32;
  if (t == 0) acc = 0u;
  __syncthreads();
  int dep = 0;
  for (int rr = 0; rr < reps; ++rr) {
    // Each thread takes `unroll` consecutive items per step; n % unroll == 0.
    for (int base = t * unroll + dep; base < n; base += kR * unroll) {
      for (int u = 0; u < unroll; ++u) {
        const int i = base + u;
        const int r = rid[i];
        if (r >= 0 && r < kR) {
          const unsigned long long v =
              (static_cast<unsigned long long>(static_cast<unsigned>(key[i]) ^ 0x80000000u) << 32) |
              static_cast<unsigned>(i + 1);
          atomicMin(&packed[r], v);
        }
      }
    }
    __syncthreads();
    if (t == 0) {
      acc += static_cast<unsigned>(packed[((rr & 7) << 7) | (rr & 127)] >> 32) ^ 0x80000000u;
    }
    dep = static_cast<int>(packed[t] >> 32) & zero;
    __syncthreads();
  }
  const unsigned long long p = packed[t];
  best_out[t] = static_cast<int>(static_cast<unsigned>(p >> 32) ^ 0x80000000u);
  const unsigned low = static_cast<unsigned>(p);
  bi_out[t] = low == 0u ? bi_in[t] : static_cast<int>(low - 1u);
  out[t] = static_cast<float>(static_cast<int>(acc));
}

// gather: one block per visit, one warp per item of the visit, four slot
// lanes per thread, and a shuffle min over the warp.  Visit v writes rows
// start(v) + j of `res`; in the unaligned mode visit v + 1 overwrites the
// rows they share, so a warp writes only the rows no later visit writes:
// the result does not depend on the order the blocks run in.
__global__ void __launch_bounds__(256)
gather_kernel(const float* rays_t, const float* slots, int n_cl, const int* item, const int* vcl,
              int reps, int nvis, int mode, int zero, int* res) {
  const int v = blockIdx.x;
  const int j = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long stride = static_cast<long long>(n_cl) * 128;
  const int start = mode == UNALIGNED ? v * 8 - (v & 7) : v * 8;
  bool own = true;
  if (mode == UNALIGNED && v + 1 < nvis) own = start + j < (v + 1) * 8 - ((v + 1) & 7);
  int dep = 0;
  for (int rr = 0; rr < reps; ++rr) {
    const int ci = min(max(vcl[v] + dep, 0), n_cl - 1);
    const long long col = mode == NOSLOT ? 0 : static_cast<long long>(ci) * 128;
    float o[3], d[3];
    if (mode == NOGATHER) {
      const float* s = slots + j * stride + col;  // the slot block's [0:8, 0:8] * 0.5
      for (int k = 0; k < 3; ++k) {
        o[k] = s[k] * 0.5f;
        d[k] = s[3 + k] * 0.5f;
      }
    } else {
      const int rj = min(max(item[v * 8 + j] + dep, 0), kR - 1);
      const float* ray = rays_t + rj * 8;
      for (int k = 0; k < 3; ++k) {
        o[k] = ray[k];
        d[k] = ray[3 + k];
      }
    }
    int kmin;
    if (mode == NOMATH) {
      kmin = static_cast<int>(static_cast<unsigned>(__float_as_int(o[0] + d[0])) +
                              static_cast<unsigned>(__float_as_int(o[1] + d[1])));
    } else {
      const float a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
      const float inv_a = 1.0f / a;
      int best = INT_MAX;
      for (int q = 0; q < 4; ++q) {
        const int l = lane + 32 * q;
        const float cx = slots[col + l], cy = slots[stride + col + l];
        const float cz = slots[2 * stride + col + l], rad = slots[3 * stride + col + l];
        const float ocx = cx - o[0], ocy = cy - o[1], ocz = cz - o[2];
        const float h = d[0] * ocx + d[1] * ocy + d[2] * ocz;
        const float c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
        const float disc = h * h - a * c;
        const float sd = sqrtf(fmaxf(disc, 0.0f));
        const float t0 = (h - sd) * inv_a;
        const float t1 = (h + sd) * inv_a;
        float t = t0 >= 1e-3f ? t0 : t1;
        const bool valid = disc >= 0.0f && rad > 0.0f && t >= 1e-3f;
        t = valid ? t : 3e38f;
        best = min(best, (__float_as_int(t) & ~127) | l);
      }
      for (int off = 16; off > 0; off >>= 1) best = min(best, __shfl_xor_sync(0xffffffffu, best, off));
      kmin = best;
    }
    if (lane == 0 && own) res[start + j] = kmin;
    dep = kmin & zero;
  }
}

// gather's acc: res[rr & 7] summed over the reps in wrapping int32.
__global__ void gather_finish(const int* res, int reps, float* out) {
  __shared__ unsigned int acc;
  if (threadIdx.x == 0) {
    unsigned a = 0u;
    for (int rr = 0; rr < reps; ++rr) a += static_cast<unsigned>(res[rr & 7]);
    acc = a;
  }
  __syncthreads();
  out[threadIdx.x] = static_cast<float>(static_cast<int>(acc));
}

// scatter: a block owns kScatterCols columns of one chunk's block of scr
// (all of them when the chunk is narrower); grid.y runs over the column
// blocks of scr that some chunk writes.  Chunks past the last block all
// write it, the last chunk last, so block row cc takes chunk cc, and the
// last block row the last chunk.  The block stages vals in shared memory
// once.  A rep has two steps.  First the block scans the chunk's 8 x kk x
// 128 destinations once, and for each that lands in its columns sets the
// lane's bit in the 128-bit lane mask of (s, column) with a shared-memory
// atomicOr: the OR is idempotent, so a lane that names a column under two
// k counts once, as the TPU's OR of one-hot planes does, and the masks do
// not depend on the threads' order.  Then each thread sums its (row,
// column) outputs over the set bits, in ascending lane within each s and s
// in ascending order, and writes scr.  That is the order of f32 adds of a
// thread that tests every (s, k, lane) for its column, so scr comes out as
// that loop gives it.  The masks are double-buffered: the summing step
// clears the other buffer, which the next rep's scan fills.  The next
// rep's base depends on this rep's result through `dep`, read from shared
// memory after the rep's barrier.
constexpr int kScatterThreads = 256;
constexpr int kScatterCols = 16;  // columns per block

__global__ void __launch_bounds__(kScatterThreads)
scatter_kernel(const float* __restrict__ vals, const int* __restrict__ dst, int reps,
               int n_chunks, int nvrows, int kk, int ch, int zero, float* __restrict__ scr) {
  __shared__ float vals_s[kMaxRows * 8 * 128];
  __shared__ uint4 mask[2][8 * kScatterCols];  // [buffer][s * kScatterCols + column]: lane bits
  __shared__ int dep_s;
  const int cc = blockIdx.y;
  const int n_blocks = kNI / ch;
  const int c = cc < n_blocks - 1 ? cc : n_chunks - 1;
  const int col0 = blockIdx.x * kScatterCols;
  const int cols = min(kScatterCols, ch - col0);
  const int n_dst = 8 * kk * 128;
  for (int w = threadIdx.x; w < 8 * nvrows * 128; w += kScatterThreads) vals_s[w] = vals[w];
  for (int w = threadIdx.x; w < 2 * 8 * kScatterCols; w += kScatterThreads) {
    mask[w / (8 * kScatterCols)][w % (8 * kScatterCols)] = make_uint4(0u, 0u, 0u, 0u);
  }
  if (threadIdx.x == 0) dep_s = 0;
  __syncthreads();
  for (int rr = 0; rr < reps; ++rr) {
    const int cur = rr & 1;
    // The block's first column as a destination; the differences wrap, as
    // the TPU body's int32 compare of dst - base with the column does.
    const unsigned first = static_cast<unsigned>(c * ch + dep_s + col0);
    unsigned* cur_words = reinterpret_cast<unsigned*>(mask[cur]);
    for (int e = threadIdx.x; e < n_dst; e += kScatterThreads) {
      const unsigned j = static_cast<unsigned>(__ldg(dst + e)) - first;
      if (j < static_cast<unsigned>(cols)) {
        const int s = e / (kk * 128), lane = e & 127;
        atomicOr(&cur_words[(s * kScatterCols + j) * 4 + (lane >> 5)], 1u << (lane & 31));
      }
    }
    __syncthreads();
    for (int o = threadIdx.x; o < nvrows * cols; o += kScatterThreads) {
      const int r = o / cols, j = o - r * cols;
      float tot = 0.0f;
#pragma unroll
      for (int s = 0; s < 8; ++s) {
        const uint4 m = mask[cur][s * kScatterCols + j];
        const float* v = vals_s + (s * nvrows + r) * 128;
        float part = 0.0f;
        for (unsigned b = m.x; b; b &= b - 1u) part += v[__ffs(b) - 1];
        for (unsigned b = m.y; b; b &= b - 1u) part += v[32 + __ffs(b) - 1];
        for (unsigned b = m.z; b; b &= b - 1u) part += v[64 + __ffs(b) - 1];
        for (unsigned b = m.w; b; b &= b - 1u) part += v[96 + __ffs(b) - 1];
        tot = s == 0 ? part : tot + part;
      }
      scr[static_cast<long long>(r) * kNI + cc * ch + col0 + j] = tot;
      if (o == 0) dep_s = __float_as_int(tot) & zero;
    }
    uint4* other = mask[cur ^ 1];
    for (int w = threadIdx.x; w < 8 * kScatterCols; w += kScatterThreads) {
      other[w] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncthreads();
  }
}

// scatter's acc: the sum of scr[0, (rr & 7) * 128 : +128] added over the reps.
__global__ void scatter_finish(const float* scr, int reps, float* out) {
  __shared__ float sums[8];
  __shared__ float acc;
  if (threadIdx.x < 8) {
    float s = 0.0f;
    for (int l = 0; l < 128; ++l) s += scr[threadIdx.x * 128 + l];
    sums[threadIdx.x] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.0f;
    for (int rr = 0; rr < reps; ++rr) a += sums[rr & 7];
    acc = a;
  }
  __syncthreads();
  out[threadIdx.x] = acc;
}

}  // namespace

// C entry points (ctypes).  Every pointer is device memory; each launches
// on `stream` and returns the CUDA error of its launches (0 on success); none
// allocates or synchronizes.  `out` is f32[1024] (the (8, 128) plane).

// rid, key int32[>= n]; best_in, bi_in, best_out, bi_out int32[1024].
extern "C" int rt_micro_reduce(const int* rid, const int* key, int reps, int n, int unroll,
                               const int* best_in, const int* bi_in, float* out, int* best_out,
                               int* bi_out, cudaStream_t stream) {
  reduce_kernel<<<1, kR, 0, stream>>>(rid, key, reps, n, unroll, 0, best_in, bi_in, out, best_out,
                                      bi_out);
  return static_cast<int>(cudaGetLastError());
}

// rays_t f32[1024, 8]; slots f32[8, n_cl * 128]; item int32[8192]; vcl
// int32[1024]; res int32[8192], holding the initial rows, updated in place.
extern "C" int rt_micro_gather(const float* rays_t, const float* slots, int n_cl, const int* item,
                               const int* vcl, int reps, int nvis, int mode, int* res, float* out,
                               cudaStream_t stream) {
  if (reps > 0 && nvis > 0) {
    gather_kernel<<<nvis, 256, 0, stream>>>(rays_t, slots, n_cl, item, vcl, reps, nvis, mode, 0,
                                            res);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gather_finish<<<1, kR, 0, stream>>>(res, reps, out);
  return static_cast<int>(cudaGetLastError());
}

// vals f32[8 * nvrows, 128]; dst int32[8 * kk, 128]; scr f32[nvrows, 8192],
// holding the initial values, updated in place.
extern "C" int rt_micro_scatter(const float* vals, const int* dst, int reps, int n_chunks,
                                int nvrows, int kk, int ch, float* scr, float* out,
                                cudaStream_t stream) {
  const int written = min(n_chunks, kNI / ch);
  if (reps > 0 && written > 0) {
    const dim3 grid((ch + kScatterCols - 1) / kScatterCols, written);
    scatter_kernel<<<grid, kScatterThreads, 0, stream>>>(vals, dst, reps, n_chunks, nvrows, kk,
                                                         ch, 0, scr);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  scatter_finish<<<1, kR, 0, stream>>>(scr, reps, out);
  return static_cast<int>(cudaGetLastError());
}
