// The warp-cooperative two-level cluster walk: the nearest hit of a ray over
// a clustered scene's tables (cluster.py, scene.ClusterData),
// walked by a whole warp, 32 lanes wide, one ray at a time.
//
// Shared by K4/K4b (cluster_nearest.cu) and K5 (megakernel.cu).  It
// computes what rt_tpu/pallas_ops.py's `_worklist_kernel` (K4) and
// `_cluster_kernel` (K4b) compute for a tile of rays, and what
// rt_tpu/megakernel.py's clustered `_mega_kernel` computes for its pool:
// per primitive kind (spheres, then triangles), the supers (AABBs of 64
// clusters) the ray enters, then each entered super's clusters, then each
// entered cluster's 128 slots.  A super or cluster is entered when the
// padded slab test admits it with an entry distance below the ray's
// current best t; pair tests run on the entered clusters' slots only.
// What the TPU kernels add to share work across a tile (worklist
// compaction by prefix-sum matmuls, SMEM worklists, row sweeps, DMA rings,
// lane binning) is not carried over.
//
// What bounds it on this card.  The first port walked one ray a thread:
// every lane of a warp stepped through the same super, cluster and slot
// indices, one dependent slot at a time with most lanes masked, and every
// box and slot read was a scattered load.  It ran at 0.1-0.3% of its
// operation bound, limited by load latency at ~16 warps an SM (PERF.md).
// This walk gives each step 32 independent pieces of work instead:
//   - supers: lane l slab-tests supers l and l + 32 of each group of 64
//     (groups in index order), ignoring the best; the admitted ones are
//     visited near to far, each step taking the least entry distance left
//     by one warp minimum over the lanes' keys (next_box), and the visit
//     stops at the first one past the best t;
//   - clusters: the 64 clusters of an entered super, two a lane, likewise;
//   - slots: lane l tests slots 4l..4l+3 of an entered cluster, so a field
//     row of the cluster (128 consecutive floats, 512 B) is one coalesced
//     16-byte load a lane and a cluster's 4 or 10 rows are in flight at
//     once; a warp minimum picks the winner.  Only the lanes that hold a
//     live slot load and test (4l < the cluster's live count, the index of
//     its last live slot plus one): cluster.build_clusters packs each
//     cluster's primitives at its front and leaves about a third of the
//     slots dead, so a cluster of 80 live slots moves 20 lanes' rows, not 32.
// The super and cluster boxes are read through the read-only cache
// (__ldg): the blob's ~40 KB of boxes stay in L1/L2, and staging them in
// shared memory once a block (a bulk asynchronous copy on an mbarrier) was
// measured no faster on this card (PERF.md).  What remains is the latency
// of the slot rows (L2) and the walk's chain of ballots and shuffles: the
// callers keep enough warps resident to hide them.
//
// Exactness: the walk returns the t and id of a sequential scan in
// ascending order (cluster_ops.cluster_nearest_plain), bit for bit, though
// it visits fewer boxes (a lane that loads nothing holds only slots past
// the last live one, which are never valid):
//   - a box is admitted ignoring the best t, then entered only if its entry
//     distance tn <= best_t when it is reached: that is the padded slab test
//     with the current best, since nothing else in it depends on best;
//   - a cluster's winner is the smallest key (order(t), id, slot) over its
//     valid slots, taken over a lane's 4 slots then 32 lanes, and replaces the
//     best when t < best_t, or t == best_t and its (id, slot) is lower (ids
//     are the slots' primitive ids, s.prim, read only when t ties; a scene
//     that has none gives each slot its global slot id).  So the walk
//     returns the least (t, id, slot) over the valid slots of the clusters
//     it enters, whatever the order in which it enters them;
//   - the box that holds that least (t*, id*, slot*) is entered in any
//     order: its tn is at most t*, and t* is at most best_t at every moment
//     (best_t is a t of the clusters entered).  A super holds its clusters'
//     boxes, so its tn is no larger.  The slab test pads tn inward by the
//     pad of its exit distance (admits), so that rounding does not put tn
//     past t* for a hit on the box's entry face: were it there, a walk that
//     had found a hit of equal t in another cluster first would stop short
//     of the winner's box (tests/test_torch_walk_order.py builds that
//     case).  Boxes are reached spheres first, then triangles; within a
//     kind, near to far (the next_box order), where the sequential scan goes
//     in ascending index: the two enter different boxes and return the same
//     winner.  A scan in ascending slot order with the rule above returns
//     the least t and, among equal t, the least id: what a brute-force
//     search over the primitives in id order returns.  order() maps a
//     float's bits to an unsigned that orders like the float (the usual flip
//     for signed values), with -0 taken as +0 so that the two tie as they do
//     under `<`; the winning t itself comes from the lane that tested it.
// The slab test pads its exit distance outward (rt_tpu/megakernel.py:918-922),
// so rounding never culls a true hit on a flat box, and its entry distance
// inward by as much, so that rounding never enters the box that holds the
// winner too late; sphere boxes are also
// widened by the reach of the sphere test's rounding (admits), so the
// walk finds what a brute-force search over every sphere finds.  Inverted
// (dummy) boxes and dead slots (radius 0, live flag 0) are never admitted or
// valid.  The
// plain PyTorch version is cluster_ops.cluster_nearest_plain, which walks
// in ascending order; with -fmad=false and IEEE division and sqrt the two
// agree bit for bit.
//
// Layout: the slot tables stay field-row-major as the scene holds them
// ([rows, n_slots], a field's values for consecutive slots adjacent): the
// tables the kernels read are the very tensors the plain version and the
// JAX package read.
#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "rt_common.cuh"

namespace rt {

constexpr int kSuperClusters = 64;   // clusters per super (cluster.SUPER_SLOTS)
constexpr int kClusterSlots = 128;   // slots per cluster (cluster.CLUSTER_SLOTS)
constexpr unsigned kNoKey = 0xffffffffu;  // no valid slot (the key of no float but a NaN)
constexpr int kVisitGroup = 64;      // boxes of one near-to-far visit: two a lane

// One primitive kind's two-level tables.  Winner ids are id_base + slot.
struct ClusterSet {
  const float* supers;    // [n_supers, 8]: lo xyz, hi xyz, pad
  const float* clusters;  // [n_clusters, 8]
  const float* slots;     // [rows, stride] field-row-major, global memory
  const int* live;        // [n_clusters]: last live slot + 1 (cluster_ops.live_counts)
  const int* prim;        // [stride]: each slot's primitive id (ties of t go to the lowest)
  int n_supers, n_clusters;
  long long stride;       // n_clusters * 128
  int id_base;
  float reach_lin;        // spheres: sqrt(K) (cluster_ops.SPHERE_REACH); see admits
  float reach_sq;         // spheres: K / (2 * least radius) (cluster_ops.sphere_reach)
};

// A ray with the reciprocals the slab test needs.
struct WalkRay {
  float ox, oy, oz, dx, dy, dz, a, inv_a, idx, idy, idz;
};

__device__ __forceinline__ WalkRay walk_ray(float ox, float oy, float oz, float dx, float dy,
                                            float dz) {
  const float tiny = (float)1e-20;
  const float a = dx * dx + dy * dy + dz * dz;
  return WalkRay{ox, oy, oz, dx, dy, dz, a, 1.0f / a,
                 1.0f / (fabsf(dx) > tiny ? dx : tiny),
                 1.0f / (fabsf(dy) > tiny ? dy : tiny),
                 1.0f / (fabsf(dz) > tiny ? dz : tiny)};
}

// The padded slab test of rt_tpu/megakernel.py:903-923 without its best-t
// condition: is box b live and does the ray's line meet it ahead of the
// origin?  Sets tn, the entry distance, padded inward as the exit distance
// is padded outward (see "Exactness" above); the ray enters b when also
// tn <= its best t.
// With kWiden (sphere boxes) the box is first widened by how far the sphere
// pair test's rounding reaches past a sphere.  For a ray whose closest
// approach to a sphere's centre (at distance D from its origin) is p, the
// float32 discriminant h*h - a*c may cancel to >= 0 up to p^2 - r^2 ~
// 4.3e-7 D^2, so a brute-force search (K1, the reference) takes a hit
// there, up to sqrt(r^2 + 2 * 4.3e-7 D^2) - r outside the sphere's box.
// With K = 2e-6 over that 2 * 4.3e-7, that reach is below both sqrt(K) D
// and K D^2 / (2 r); the box is widened by the lesser of the two
// (s.reach_lin = sqrt(K), s.reach_sq = K / (2 r_min)), with D bounded by
// the L1 distance from the origin to its farthest corner and r by the set's
// least radius r_min, so that the walk enters every box that holds such a
// hit.  The bound holds where it was checked: radii 0.005 to 1000 and
// distances D 3 to 4000 (random grazing rays on the CPU, the largest reach
// under half the widening); outside that range it is not shown.  The
// scenes that walk spheres lie inside it: main_default_scene's lattice
// (radius 0.2, D up to ~850) is tested at its extremes
// (tests/test_torch_walk_order.py).
template <bool kWiden>
__device__ __forceinline__ bool admits(const float* __restrict__ b, const WalkRay& r,
                                       const ClusterSet& s, float& tn) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(b));      // lx ly lz hx
  const float2 hi = __ldg(reinterpret_cast<const float2*>(b + 4));  // hy hz
  float lx = lo.x, ly = lo.y, lz = lo.z, hx = lo.w, hy = hi.x, hz = hi.y;
  if (kWiden) {
    const float ex = fmaxf(fabsf(lx - r.ox), fabsf(hx - r.ox));
    const float ey = fmaxf(fabsf(ly - r.oy), fabsf(hy - r.oy));
    const float ez = fmaxf(fabsf(lz - r.oz), fabsf(hz - r.oz));
    const float l1 = ex + ey + ez;
    const float pad = fminf(l1 * s.reach_lin, l1 * l1 * s.reach_sq);
    lx = lx - pad, ly = ly - pad, lz = lz - pad;
    hx = hx + pad, hy = hy + pad, hz = hz + pad;
  }
  const float t0x = (lx - r.ox) * r.idx, t1x = (hx - r.ox) * r.idx;
  const float t0y = (ly - r.oy) * r.idy, t1y = (hy - r.oy) * r.idy;
  const float t0z = (lz - r.oz) * r.idz, t1z = (hz - r.oz) * r.idz;
  tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fmaxf(fminf(t0z, t1z), 0.0f));
  tn = tn * (float)(1.0 - 6e-7) - (float)1e-6;
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  tf = tf * (float)(1.0 + 6e-7) + (float)1e-6;
  return lo.x <= lo.w && tn <= tf && tf >= 0.0f;  // lx > hx: an inverted dummy box
}

// Component q (0..3, known when compiled) of v.
__device__ __forceinline__ float component(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}
__device__ __forceinline__ int component(const int4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

// The pair test of one slot, its fields in v (center xyz, radius; or a,
// e1, e2, the live flag): whether the ray hits it in [t_min, t_max), and
// at t (pallas_ops.py sphere pair test :412-430, triangle pair test
// :442-480).
template <bool kSpheres>
__device__ __forceinline__ bool pair_test(const float* v, const WalkRay& r, float t_min,
                                          float t_max, bool cull, float& t) {
  if (kSpheres) {
    const float rad = v[3];
    const float ocx = v[0] - r.ox;
    const float ocy = v[1] - r.oy;
    const float ocz = v[2] - r.oz;
    const float h = r.dx * ocx + r.dy * ocy + r.dz * ocz;
    const float c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
    const float disc = h * h - r.a * c;
    const float sd = sqrtf(fmaxf(disc, 0.0f));
    const float t0 = (h - sd) * r.inv_a;
    const float t1 = (h + sd) * r.inv_a;
    t = t0 >= t_min ? t0 : t1;
    return rad > 0.0f && disc >= 0.0f && t >= t_min && t < t_max;
  }
  const float ax = v[0], ay = v[1], az = v[2];
  const float e1x = v[3], e1y = v[4], e1z = v[5];
  const float e2x = v[6], e2y = v[7], e2z = v[8];
  const float uvx = r.dy * e2z - r.dz * e2y;
  const float uvy = r.dz * e2x - r.dx * e2z;
  const float uvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * uvx + e1y * uvy + e1z * uvz;
  const bool det_ok = cull ? det > (float)1e-7 : fabsf(det) > (float)1e-7;
  const float inv_det = 1.0f / (det_ok ? det : 1.0f);
  const float aox = r.ox - ax, aoy = r.oy - ay, aoz = r.oz - az;
  const float u = (aox * uvx + aoy * uvy + aoz * uvz) * inv_det;
  const float vvx = aoy * e1z - aoz * e1y;
  const float vvy = aoz * e1x - aox * e1z;
  const float vvz = aox * e1y - aoy * e1x;
  const float w = (r.dx * vvx + r.dy * vvy + r.dz * vvz) * inv_det;
  t = (e2x * vvx + e2y * vvy + e2z * vvz) * inv_det;
  return v[9] > 0.5f && det_ok && u >= 0.0f && u <= 1.0f && w >= 0.0f && u + w <= 1.0f &&
         t >= t_min && t < t_max && t > (float)1e-7;
}

// The key of one slot (its column in the slot table), order(t) of its
// pair test or kNoKey, its fields loaded one by one.
template <bool kSpheres>
__device__ __forceinline__ unsigned slot_key(const ClusterSet& s, long long col, const WalkRay& r,
                                             float t_min, float t_max, bool cull) {
  constexpr int kRows = kSpheres ? 4 : 10;
  float v[kRows];
#pragma unroll
  for (int k = 0; k < kRows; ++k) v[k] = __ldg(s.slots + k * s.stride + col);
  float t;
  return pair_test<kSpheres>(v, r, t_min, t_max, cull, t) ? order_key(t) : kNoKey;
}

// The pair tests of entered cluster ci, lane l taking slots 4l..4l+3 (one
// 16-byte load a field row: all of a cluster's rows are in flight at once)
// when 4l < live, ci's live count, and the warp's winner; best_t/best_i
// (the same in every lane) are updated.  Among equal t the lowest primitive
// id wins, as in a brute-force search over the primitives in id order (K1,
// the reference): within the cluster and against the best so far, which
// another cluster can hold at the same t (two triangles that share an
// edge); among equal t and id, the lowest slot, so that the winner does not
// depend on the order in which clusters are entered.  The ids (s.prim) are
// read only on such a tie.
template <bool kSpheres>
__device__ __forceinline__ void walk_cluster(const ClusterSet& s, int ci, int live,
                                             const WalkRay& r, float t_min, float t_max,
                                             bool cull, int lane, float& best_t, int& best_i) {
  constexpr int kRows = kSpheres ? 4 : 10;
  unsigned lane_key = kNoKey;
  int lane_slot = 0;
  int lane_last = 0;  // the last of the lane's slots q whose key is lane_key
  float lane_t = 0.0f;
  if (4 * lane < live) {
    const float4* __restrict__ f =
        reinterpret_cast<const float4*>(s.slots + (long long)ci * kClusterSlots) + lane;
    const long long st = s.stride / 4;  // a field row, in float4
    float4 row[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) row[k] = __ldg(f + k * st);
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float v[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) v[k] = component(row[k], q);
      float t;
      const bool ok = pair_test<kSpheres>(v, r, t_min, t_max, cull, t);
      const unsigned key = ok ? order_key(t) : kNoKey;
      if (key < lane_key) {  // ascending slots, strict: the lane's lowest slot wins its ties
        lane_key = key;
        lane_slot = 4 * lane + q;
        lane_t = t;
      }
      lane_last = key == lane_key ? q : lane_last;
    }
  }
  const unsigned least = __reduce_min_sync(kFullMask, lane_key);
  if (least == kNoKey) return;
  const bool at = lane_key == least;
  unsigned slot = __reduce_min_sync(kFullMask, at ? (unsigned)lane_slot : kNoKey);
  const float t = __shfl_sync(kFullMask, lane_t, (int)(slot >> 2));
  if (t > best_t) return;
  if (t == best_t || (__ballot_sync(kFullMask, at) & ~(1u << (slot >> 2))) != 0 ||
      __shfl_sync(kFullMask, lane_last, (int)(slot >> 2)) != (int)(slot & 3)) {
    // A tie within the cluster (another lane, or a later slot of the
    // winner's lane, at the least key) or with the best so far.  Each lane
    // at the least key tests its slots again (the rows are in L1) to find
    // which hold it, and takes the lowest id among them.
    unsigned lane_rank = kNoKey;
    int lane_rslot = 0;
    if (at) {
      const long long col = (long long)ci * kClusterSlots + 4 * lane;
      const int4 ids = __ldg(reinterpret_cast<const int4*>(s.prim + col));
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const unsigned id = (unsigned)component(ids, q);
        if (id < lane_rank && slot_key<kSpheres>(s, col + q, r, t_min, t_max, cull) == least) {
          lane_rank = id;
          lane_rslot = 4 * lane + q;
        }
      }
    }
    const unsigned rank = __reduce_min_sync(kFullMask, lane_rank);
    slot = __reduce_min_sync(kFullMask, at && lane_rank == rank ? (unsigned)lane_rslot : kNoKey);
    if (t == best_t) {
      // The best's id, where it is a slot of this set (else it is a sphere,
      // of a lower id than any triangle and a lower slot).
      const long long bi = (long long)best_i - s.id_base;
      const unsigned best_rank = bi >= 0 && bi < s.stride ? (unsigned)__ldg(s.prim + bi) : 0u;
      if (!(rank < best_rank ||
            (rank == best_rank && s.id_base + ci * kClusterSlots + (int)slot < best_i))) {
        return;
      }
    }
  }
  best_t = t;
  best_i = s.id_base + ci * kClusterSlots + (int)slot;
}

// The key of box b of a table of n boxes for the near-to-far visit:
// order(tn) if the padded slab test admits it (ignoring the best), else
// kNoKey.
template <bool kWiden>
__device__ __forceinline__ unsigned box_key(const float* __restrict__ boxes, int b, int n,
                                            const WalkRay& r, const ClusterSet& s) {
  float tn;
  return b < n && admits<kWiden>(boxes + 8 * b, r, s, tn) ? order_key(tn) : kNoKey;
}

// One step of the near-to-far visit of a group of 64 boxes, lane l holding
// boxes l and l + 32 (keys key_lo / key_hi).  Returns false when no box is
// left whose tn <= best_t: the keys left are no smaller than the least, and
// best_t only falls, so no later box would be entered.  Else sets b to the
// place in the group of the box of the least key (of the lowest lane that
// holds it; its first box before its second) and clears that key.  One
// warp minimum and two ballots a step.
__device__ __forceinline__ bool next_box(unsigned& key_lo, unsigned& key_hi, float best_t,
                                         int lane, int& b) {
  const unsigned least = __reduce_min_sync(kFullMask, key_hi < key_lo ? key_hi : key_lo);
  if (least == kNoKey || least > order_key(best_t)) return false;
  const unsigned at_lo = __ballot_sync(kFullMask, key_lo == least);
  const unsigned at_hi = __ballot_sync(kFullMask, key_hi == least);
  const int owner = __ffs(at_lo | at_hi) - 1;
  const bool hi = ((at_lo >> owner) & 1u) == 0u;
  b = owner + (hi ? 32 : 0);
  if (lane == owner) {
    if (hi) {
      key_hi = kNoKey;
    } else {
      key_lo = kNoKey;
    }
  }
  return true;
}

// One kind's walk of one ray by the whole warp (every lane passes the same
// ray and best; all 32 lanes must take part): the supers of each group of
// 64, near to far, and each entered super's clusters, near to far.
template <bool kSpheres>
__device__ __forceinline__ void walk_set(const ClusterSet& s, const WalkRay& r, float t_min,
                                         float t_max, bool cull, int lane, float& best_t,
                                         int& best_i) {
  for (int s0 = 0; s0 < s.n_supers; s0 += kVisitGroup) {
    unsigned skey_lo = box_key<kSpheres>(s.supers, s0 + lane, s.n_supers, r, s);
    unsigned skey_hi = box_key<kSpheres>(s.supers, s0 + 32 + lane, s.n_supers, r, s);
    int sb;
    while (next_box(skey_lo, skey_hi, best_t, lane, sb)) {
      const int c0 = (s0 + sb) * kSuperClusters;
      unsigned key_lo = box_key<kSpheres>(s.clusters, c0 + lane, s.n_clusters, r, s);
      unsigned key_hi = box_key<kSpheres>(s.clusters, c0 + 32 + lane, s.n_clusters, r, s);
      int cb;
      while (next_box(key_lo, key_hi, best_t, lane, cb)) {
        walk_cluster<kSpheres>(s, c0 + cb, __ldg(s.live + c0 + cb), r, t_min, t_max, cull, lane,
                               best_t, best_i);
      }
    }
  }
}

// The rays of the lanes in `active`, walked one after another by the whole
// warp: spheres, then triangles.  Lane l's ray is (ox..dz) as lane l
// passes it; lane l's (t_out, i_out) are set to its ray's nearest hit
// (BIG and -1 on a miss) and left alone when l is not in `active`.
// Every lane of the warp must call it, with the same `active`.
__device__ __forceinline__ void warp_walk_rays(const ClusterSet& sph, const ClusterSet& tri,
                                               unsigned active, float ox, float oy, float oz,
                                               float dx, float dy, float dz, float t_min,
                                               float t_max, bool cull, int lane, float& t_out,
                                               int& i_out) {
  for (unsigned m = active; m; m &= m - 1) {
    const int src = __ffs(m) - 1;
    const WalkRay r = walk_ray(__shfl_sync(kFullMask, ox, src), __shfl_sync(kFullMask, oy, src),
                               __shfl_sync(kFullMask, oz, src), __shfl_sync(kFullMask, dx, src),
                               __shfl_sync(kFullMask, dy, src), __shfl_sync(kFullMask, dz, src));
    float best_t = BIG;
    int best_i = -1;
    walk_set<true>(sph, r, t_min, t_max, cull, lane, best_t, best_i);
    walk_set<false>(tri, r, t_min, t_max, cull, lane, best_t, best_i);
    if (lane == src) {
      t_out = best_t;
      i_out = best_i;
    }
  }
}

}  // namespace rt
