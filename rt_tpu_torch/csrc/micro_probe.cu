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
// What bounds them on this card.  Every rep depends on the one before, so a
// rep is a chain of latencies, not a stream.  Reduce: one block's rep is
// its shared-memory traffic: the coalesced loads of rid and key, one
// 32-bit shared atomicMin per item and a table read per item in phase 2,
// with bank conflicts at random rays, then two barriers.  The first port
// loaded each thread's consecutive items (8 times the sectors a warp load
// needs) and kept (key, item) in one 64-bit word, whose shared atomicMin
// is a compare-and-swap loop on this card.  Cutting the items over a
// cluster of blocks costs more in cluster barriers and remote reads than it
// saves at 8,192 items.  Gather: the pair tests' issue rate, ~18
// operations a pair for 8 x 128 pairs a visit, the roots of the admitted
// pairs and the per-item minima; a rep's load chain (vcl -> slot block,
// item -> ray) is a small share.  The first port gave each item a warp, so
// the visit's 8 warps loaded the same slot rows, and took a square root
// for every pair, through the slow path for the rejected pairs' sqrt(0).
// Scatter: the latency of a rep's two steps and two barriers in each
// block: one scan of the chunk's 8 x K x 128 destinations, then each
// output's sum over the few lanes that name its column.  The first port
// gave each column a thread that compared all 8 x K x 128 destinations with
// it, the one-hot planes the TPU builds for its matrix unit, one by one:
// ~2,000 times its bound.
#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kNI = 8192;   // items; visits are kNI / 8
constexpr int kR = 1024;    // rays: one (8, 128) plane
constexpr int kMaxRows = 8; // scatter's value rows per plane

constexpr unsigned kFull = 0xffffffffu;

enum Mode : int { FULL = 0, NOMATH = 1, NOGATHER = 2, NOSLOT = 3, UNALIGNED = 4 };

// reduce: the items are cut into kReduceCluster equal ranges, one a block of
// 1,024 threads; with more than one block, the blocks form a thread block
// cluster.  A rep has two steps.  First each block reduces its items into
// its own table of (key, item) per ray in shared memory, with native 32-bit
// shared atomics in two phases: the least key (atomicMin), then, after a
// barrier, the first item that holds it (atomicMin of the index over the
// items whose key equals the table's).  Item i = base + u * 1024 + t, so
// each warp's loads are coalesced; a thread holds kReduceItems items in
// registers for both phases.  Then, after a cluster barrier, block b merges
// the tables' entries of its 1024 / kReduceCluster rays: a group of
// kReduceCluster lanes takes a ray, each lane one block's table (through
// distributed shared memory), and the least (key, item) of the group
// replaces the ray's state only when its key is below the state's: the
// strict `<` of the sequential loop, so the initial value wins a tie with
// any item, and among equal keys the first item wins.  The state lives in
// the registers of the group's lanes.  The tables are double-buffered and
// each entry is reset by the one lane that merges it, so one cluster
// barrier a rep orders the reps.  Items whose ray lies outside [0, 1024)
// are skipped; items past n are not read.
constexpr int kReduceCluster = 1;  // blocks (a cluster when > 1): 1, 2, 4 or 8
constexpr int kReduceItems = 8;    // items a thread holds in registers per pass

template <int C>
__device__ __forceinline__ void reduce_barrier() {
  if constexpr (C > 1) {
    cg::this_cluster().sync();
  } else {
    __syncthreads();
  }
}

// Phase 1 for item (r, k).
__device__ __forceinline__ void reduce_key(int* tk, int r, int k) {
  if (static_cast<unsigned>(r) < static_cast<unsigned>(kR)) atomicMin(tk + r, k);
}

// Phase 2 for item i with ray r and key k, once every key of the block is in tk.
__device__ __forceinline__ void reduce_item(const int* tk, int* ti, int r, int k, int i) {
  if (static_cast<unsigned>(r) < static_cast<unsigned>(kR) && k == tk[r]) atomicMin(ti + r, i);
}

__global__ void __launch_bounds__(kR)
reduce_kernel(const int* __restrict__ rid, const int* __restrict__ key, int reps, int n, int zero,
              const int* best_in, const int* bi_in, float* out, int* best_out, int* bi_out) {
  constexpr int C = kReduceCluster, U = kReduceItems;
  static_assert(C == 1 || C == 2 || C == 4 || C == 8, "kReduceCluster: 1, 2, 4 or 8");
  __shared__ int tab_k[2][kR], tab_i[2][kR];
  __shared__ unsigned acc_s;
  const int t = threadIdx.x;
  int b = 0;
  if constexpr (C > 1) b = static_cast<int>(cg::this_cluster().block_rank());
  const int per = (n + C - 1) / C;
  const int lo = min(b * per, n), hi = min(lo + per, n);
  const int ray = b * (kR / C) + t / C, rank = t % C;  // the merge's ray and table
  int best = best_in[ray], bi = bi_in[ray];
  tab_k[0][t] = tab_k[1][t] = tab_i[0][t] = tab_i[1][t] = INT_MAX;
  if (t == 0) acc_s = 0u;
  unsigned acc = 0u;
  int rv[U], kv[U];
#pragma unroll
  for (int u = 0; u < U; ++u) rv[u] = kv[u] = -1;
  reduce_barrier<C>();
  int dep = 0;
  for (int rr = 0; rr < reps; ++rr) {
    int* tk = tab_k[rr & 1];
    int* ti = tab_i[rr & 1];
    const int first = lo + dep;
    for (int base = first; base < hi; base += kR * U) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = base + u * kR + t;
        rv[u] = i < hi ? __ldg(rid + i) : -1;
        kv[u] = i < hi ? __ldg(key + i) : 0;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) reduce_key(tk, rv[u], kv[u]);
    }
    __syncthreads();
    if (hi - first <= kR * U) {  // one pass: the items are still in registers
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = first + u * kR + t;
        reduce_item(tk, ti, i < hi ? rv[u] : -1, kv[u], i);
      }
    } else {
      for (int base = first; base < hi; base += kR * U) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int i = base + u * kR + t;
          reduce_item(tk, ti, i < hi ? __ldg(rid + i) : -1, i < hi ? __ldg(key + i) : 0, i);
        }
      }
    }
    reduce_barrier<C>();
    int* rk = tk;
    int* ri = ti;
    if constexpr (C > 1) {
      rk = cg::this_cluster().map_shared_rank(tk, rank);
      ri = cg::this_cluster().map_shared_rank(ti, rank);
    }
    int k = rk[ray], i = ri[ray];
    rk[ray] = INT_MAX;  // for rep rr + 2, which starts after the next barrier
    ri[ray] = INT_MAX;
#pragma unroll
    for (int off = C / 2; off > 0; off >>= 1) {
      const int ok = __shfl_xor_sync(kFull, k, off), oi = __shfl_xor_sync(kFull, i, off);
      if (ok < k || (ok == k && oi < i)) {
        k = ok;
        i = oi;
      }
    }
    if (k < best) {
      best = k;
      bi = i;
    }
    if (rank == 0 && ray == (((rr & 7) << 7) | (rr & 127))) acc += static_cast<unsigned>(best);
    dep = __shfl_sync(kFull, best, 0) & zero;
  }
  if (rank == 0) {
    best_out[ray] = best;
    bi_out[ray] = bi;
  }
  const unsigned warp_acc = __reduce_add_sync(kFull, acc);  // wrapping int32 sums
  if ((t & 31) == 0) atomicAdd(&acc_s, warp_acc);
  reduce_barrier<C>();
  if (b == 0) {
    unsigned tot = acc_s;
    if constexpr (C > 1) {
      for (int q = 1; q < C; ++q) tot += *cg::this_cluster().map_shared_rank(&acc_s, q);
    }
    out[t] = static_cast<float>(static_cast<int>(tot));
  }
  if constexpr (C > 1) cg::this_cluster().sync();  // block 0 has read every acc_s
}

// gather: a visit takes 128 / kGatherLanes threads, a thread kGatherLanes
// adjacent slot lanes, which it tests against all 8 items of the visit, so
// one slot load serves 8 pair tests; a block takes kGatherVisits visits.
// Lanes 0-7 of each warp load the 8 rays once (with |d|^2 and one IEEE
// division 1 / a each) into shared memory, which the warp's lanes read as
// broadcasts.  A pair takes its square root and its two roots only when
// disc >= 0 and rad > 0 (a branch per pair); every other pair's key is
// bits(3e38) & ~127 | lane whatever its root.  A warp runs a pair's root
// where any of its lanes admits its pair.  (A queue of the warp's admitted
// pairs, rooted 32 at a time, took longer: its prefix sum, shared-memory
// traffic and atomics cost more than the roots it saves.)  Per item, a
// thread's least key over its lanes, then the warp's (__reduce_min_sync),
// then the least over the visit's warps through shared memory; one thread
// an item writes `res`.  Visit v writes rows start(v) + j; in the
// unaligned mode visit v + 1 overwrites the rows they share, so a visit
// writes only the rows no later visit writes: the result does not depend
// on the order the blocks run in.  The warps' minima are double-buffered,
// so one barrier a rep orders the reps.
constexpr int kGatherLanes = 1;   // slot lanes a thread: 1, 2 or 4 (4, 2 or 1 warps a visit)
constexpr int kGatherVisits = 4;  // visits a block
constexpr int kGatherWarps = 4 / kGatherLanes;
constexpr int kGatherThreads = 32 * kGatherWarps * kGatherVisits;

// The slot lanes l .. l + L - 1 of one row, in one load.
template <int L>
__device__ __forceinline__ void load_lanes(const float* p, float* x) {
  if constexpr (L == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else if constexpr (L == 2) {
    const float2 v = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = v.x;
    x[1] = v.y;
  } else {
    x[0] = __ldg(p);
  }
}

// The key of ray (p, q) = ((ox, oy, oz, dx), (dy, dz, a, 1 / a)) and the
// sphere (cx, cy, cz, rad) in slot lane l: tools/micro_probe.py:103-115,
// operation for operation, with the root taken only where disc >= 0 and
// rad > 0, the conditions `valid` requires beside t >= 1e-3.
__device__ __forceinline__ int pair_key(const float4 p, const float4 q, float cx, float cy,
                                        float cz, float rad, int l, int none) {
  const float ocx = cx - p.x, ocy = cy - p.y, ocz = cz - p.z;
  const float h = p.w * ocx + q.x * ocy + q.y * ocz;
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  const float disc = h * h - q.z * c;
  int bits = none;
  if (disc >= 0.0f && rad > 0.0f) {
    const float sd = sqrtf(fmaxf(disc, 0.0f));
    const float t0 = (h - sd) * q.w;
    const float t1 = (h + sd) * q.w;
    const float t = t0 >= 1e-3f ? t0 : t1;
    if (t >= 1e-3f) bits = __float_as_int(t) & ~127;
  }
  return bits | l;
}

__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const float* __restrict__ rays_t, const float* __restrict__ slots, int n_cl,
              const int* __restrict__ item, const int* __restrict__ vcl, int reps, int nvis,
              int mode, int zero, int* res) {
  constexpr int L = kGatherLanes, W = kGatherWarps, V = kGatherVisits;
  static_assert(L == 1 || L == 2 || L == 4, "kGatherLanes: 1, 2 or 4");
  __shared__ float4 ray_s[V][W][8][2];
  __shared__ int part_s[2][V][W][8];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int vb = warp / W, w = warp % W;  // visit of the block, warp of the visit
  const bool live = blockIdx.x * V + vb < nvis;
  const int v = min(blockIdx.x * V + vb, nvis - 1);
  const long long stride = static_cast<long long>(n_cl) * 128;
  const int start = mode == UNALIGNED ? v * 8 - (v & 7) : v * 8;
  bool own = live && w == 0 && lane < 8;
  if (mode == UNALIGNED && v + 1 < nvis) own = own && start + lane < (v + 1) * 8 - ((v + 1) & 7);
  const int l0 = (w * 32 + lane) * L;  // the thread's first slot lane
  const int none = __float_as_int(3e38f) & ~127;
  int dep = 0;
  for (int rr = 0; rr < reps; ++rr) {
    const int ci = min(max(vcl[v] + dep, 0), n_cl - 1);
    const long long col = mode == NOSLOT ? 0 : static_cast<long long>(ci) * 128;
    int kmin = INT_MAX;
    if (lane < 8) {  // item `lane`'s ray
      float o[3], d[3];
      if (mode == NOGATHER) {
        const float* s = slots + lane * stride + col;  // the slot block's [0:8, 0:8] * 0.5
        for (int k = 0; k < 3; ++k) {
          o[k] = s[k] * 0.5f;
          d[k] = s[3 + k] * 0.5f;
        }
      } else {
        const float* s = rays_t + min(max(item[v * 8 + lane] + dep, 0), kR - 1) * 8;
        const float4 a4 = __ldg(reinterpret_cast<const float4*>(s));
        const float2 b2 = __ldg(reinterpret_cast<const float2*>(s + 4));
        o[0] = a4.x, o[1] = a4.y, o[2] = a4.z, d[0] = a4.w, d[1] = b2.x, d[2] = b2.y;
      }
      if (mode == NOMATH) {
        kmin = static_cast<int>(static_cast<unsigned>(__float_as_int(o[0] + d[0])) +
                                static_cast<unsigned>(__float_as_int(o[1] + d[1])));
      } else {
        const float a = d[0] * d[0] + d[1] * d[1] + d[2] * d[2];
        ray_s[vb][w][lane][0] = make_float4(o[0], o[1], o[2], d[0]);
        ray_s[vb][w][lane][1] = make_float4(d[1], d[2], a, 1.0f / a);
      }
    }
    if (mode != NOMATH) {
      float cx[L], cy[L], cz[L], rad[L];
      const float* s = slots + col + l0;
      load_lanes<L>(s, cx);
      load_lanes<L>(s + stride, cy);
      load_lanes<L>(s + 2 * stride, cz);
      load_lanes<L>(s + 3 * stride, rad);
      __syncwarp();
      int mine = INT_MAX;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 p = ray_s[vb][w][j][0], q = ray_s[vb][w][j][1];
        int kb = INT_MAX;
#pragma unroll
        for (int u = 0; u < L; ++u) kb = min(kb, pair_key(p, q, cx[u], cy[u], cz[u], rad[u], l0 + u, none));
        kb = __reduce_min_sync(kFull, kb);
        if (lane == j) mine = kb;
      }
      int* part = part_s[rr & 1][vb][0];
      if (lane < 8) part[w * 8 + lane] = mine;
      if constexpr (W > 1) {
        __syncthreads();
      } else {
        __syncwarp();
      }
      kmin = mine;
      if (w == 0 && lane < 8) {
#pragma unroll
        for (int u = 1; u < W; ++u) kmin = min(kmin, part[u * 8 + lane]);
      }
    }
    if (own) res[start + lane] = kmin;
    dep = __shfl_sync(kFull, kmin, 0) & zero;
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

// rid, key int32[>= n]; best_in, bi_in, best_out, bi_out int32[1024].  n
// must be a multiple of `unroll`, the TPU body's items a step (its loop has
// no per-item guard); the kernel itself takes any n.
extern "C" int rt_micro_reduce(const int* rid, const int* key, int reps, int n, int unroll,
                               const int* best_in, const int* bi_in, float* out, int* best_out,
                               int* bi_out, cudaStream_t stream) {
  if (unroll < 1 || n % unroll != 0) return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (kReduceCluster > 1) {
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kReduceCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kReduceCluster);
    cfg.blockDim = dim3(kR);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, reduce_kernel, rid, key, reps, n, 0, best_in,
                                               bi_in, out, best_out, bi_out);
    if (err != cudaSuccess) return static_cast<int>(err);
  } else {
    reduce_kernel<<<1, kR, 0, stream>>>(rid, key, reps, n, 0, best_in, bi_in, out, best_out,
                                        bi_out);
  }
  return static_cast<int>(cudaGetLastError());
}

// rays_t f32[1024, 8]; slots f32[8, n_cl * 128]; item int32[8192]; vcl
// int32[1024]; res int32[8192], holding the initial rows, updated in place.
extern "C" int rt_micro_gather(const float* rays_t, const float* slots, int n_cl, const int* item,
                               const int* vcl, int reps, int nvis, int mode, int* res, float* out,
                               cudaStream_t stream) {
  if (reps > 0 && nvis > 0) {
    gather_kernel<<<(nvis + kGatherVisits - 1) / kGatherVisits, kGatherThreads, 0, stream>>>(
        rays_t, slots, n_cl, item, vcl, reps, nvis, mode, 0, res);
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
