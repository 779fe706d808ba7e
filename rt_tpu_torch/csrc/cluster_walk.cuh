// The per-ray two-level cluster walk: the nearest hit of one ray over a
// clustered scene's tables (cluster.py, scene.ClusterData / ClusterPage).
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
// lane binning) is not carried over: a thread walks its own ray.
//
// Exactness: slots are scanned in ascending order with a strict `<`,
// spheres first, so the lowest slot wins within a cluster and an earlier
// cluster (or page, in the caller's merge) on equal t, as in the Pallas
// kernels.  The slab test pads its exit distance outward
// (rt_tpu/megakernel.py:918-922), so rounding never culls a true hit on a
// flat box.  Inverted (dummy) boxes and dead slots (radius 0, live flag 0)
// are skipped: they can never hold a hit, so skipping them changes no
// result.  The plain PyTorch version is cluster_ops.cluster_nearest_plain,
// which repeats this walk operation for operation; with -fmad=false and
// IEEE division and sqrt the two agree bit for bit.
//
// Layout: the slot tables stay field-row-major as the scene holds them
// ([rows, n_slots], a field's values for consecutive slots adjacent), and
// the walk reads them through the row stride.  No slot-major copy is made:
// the tables the kernel reads are the very tensors the plain version and
// the JAX package read, and no second copy of a mesh scene's tables has to
// be built, moved or kept in step.  Threads that walk the same cluster
// (coherent camera rays) read the same address, a broadcast; a slot's
// fields come from 4 (sphere) or 10 (triangle) rows that stay in L1/L2.
#pragma once

#include <cstdint>

namespace rt {

constexpr int kSuperClusters = 64;   // clusters per super (cluster.SUPER_SLOTS)
constexpr int kClusterSlots = 128;   // slots per cluster (cluster.CLUSTER_SLOTS)

// One primitive kind's two-level tables.  Winner ids are id_base + slot.
struct ClusterSet {
  const float* supers;    // [n_supers, 8]: lo xyz, hi xyz, pad
  const float* clusters;  // [n_clusters, 8]
  const float* slots;     // [rows, stride] field-row-major
  int n_supers, n_clusters;
  long long stride;       // n_clusters * 128
  int id_base;
};

// A ray with the reciprocals the slab test needs.
struct WalkRay {
  float ox, oy, oz, dx, dy, dz, a, inv_a, idx, idy, idz;
};

__device__ __forceinline__ WalkRay walk_ray(float ox, float oy, float oz, float dx, float dy,
                                            float dz, float a, float inv_a) {
  const float tiny = (float)1e-20;
  return WalkRay{ox, oy, oz, dx, dy, dz, a, inv_a,
                 1.0f / (fabsf(dx) > tiny ? dx : tiny),
                 1.0f / (fabsf(dy) > tiny ? dy : tiny),
                 1.0f / (fabsf(dz) > tiny ? dz : tiny)};
}

// The padded slab test of rt_tpu/megakernel.py:903-923: does the ray enter
// box b with an entry distance below best?
__device__ __forceinline__ bool enters(const float* __restrict__ b, const WalkRay& r,
                                       float best) {
  const float lx = __ldg(b + 0), ly = __ldg(b + 1), lz = __ldg(b + 2);
  const float hx = __ldg(b + 3), hy = __ldg(b + 4), hz = __ldg(b + 5);
  if (!(lx <= hx)) return false;  // inverted dummy box: holds no primitive
  const float t0x = (lx - r.ox) * r.idx, t1x = (hx - r.ox) * r.idx;
  const float t0y = (ly - r.oy) * r.idy, t1y = (hy - r.oy) * r.idy;
  const float t0z = (lz - r.oz) * r.idz, t1z = (hz - r.oz) * r.idz;
  const float tn = fmaxf(fmaxf(fminf(t0x, t1x), fminf(t0y, t1y)), fmaxf(fminf(t0z, t1z), 0.0f));
  float tf = fminf(fminf(fmaxf(t0x, t1x), fmaxf(t0y, t1y)), fmaxf(t0z, t1z));
  tf = tf * (float)(1.0 + 6e-7) + (float)1e-6;
  return tn <= tf && tf >= 0.0f && tn < best;
}

// One kind's walk: supers, entered clusters, their slots (pallas_ops.py
// sphere pair test :412-430, triangle pair test :442-480).
template <bool kSpheres>
__device__ __forceinline__ void walk_set(const ClusterSet& s, const WalkRay& r, float t_min,
                                         float t_max, bool cull, float& best_t, int& best_i) {
  const float* __restrict__ f = s.slots;
  const long long st = s.stride;
  for (int si = 0; si < s.n_supers; ++si) {
    if (!enters(s.supers + 8 * si, r, best_t)) continue;
    const int c_end = min(s.n_clusters, (si + 1) * kSuperClusters);
    for (int ci = si * kSuperClusters; ci < c_end; ++ci) {
      if (!enters(s.clusters + 8 * ci, r, best_t)) continue;
      const int base = ci * kClusterSlots;
      for (int k = 0; k < kClusterSlots; ++k) {
        const int j = base + k;
        if (kSpheres) {
          const float rad = __ldg(f + 3 * st + j);
          if (!(rad > 0.0f)) continue;  // dead slot: never a hit
          const float ocx = __ldg(f + j) - r.ox;
          const float ocy = __ldg(f + st + j) - r.oy;
          const float ocz = __ldg(f + 2 * st + j) - r.oz;
          const float h = r.dx * ocx + r.dy * ocy + r.dz * ocz;
          const float c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
          const float disc = h * h - r.a * c;
          const float sd = sqrtf(fmaxf(disc, 0.0f));
          const float t0 = (h - sd) * r.inv_a;
          const float t1 = (h + sd) * r.inv_a;
          const float t = t0 >= t_min ? t0 : t1;
          if (disc >= 0.0f && t >= t_min && t < t_max && t < best_t) {
            best_t = t;
            best_i = s.id_base + j;
          }
        } else {
          if (!(__ldg(f + 9 * st + j) > 0.5f)) continue;  // dead slot: never a hit
          const float ax = __ldg(f + j), ay = __ldg(f + st + j), az = __ldg(f + 2 * st + j);
          const float e1x = __ldg(f + 3 * st + j), e1y = __ldg(f + 4 * st + j);
          const float e1z = __ldg(f + 5 * st + j);
          const float e2x = __ldg(f + 6 * st + j), e2y = __ldg(f + 7 * st + j);
          const float e2z = __ldg(f + 8 * st + j);
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
          const float v = (r.dx * vvx + r.dy * vvy + r.dz * vvz) * inv_det;
          const float t = (e2x * vvx + e2y * vvy + e2z * vvz) * inv_det;
          if (det_ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t >= t_min &&
              t < t_max && t > (float)1e-7 && t < best_t) {
            best_t = t;
            best_i = s.id_base + j;
          }
        }
      }
    }
  }
}

// Nearest hit of one ray: spheres, then triangles.  best_t starts at the
// miss value 3e38 and best_i at -1; both are updated in place.
__device__ __forceinline__ void cluster_walk(const ClusterSet& sph, const ClusterSet& tri,
                                             const WalkRay& r, float t_min, float t_max,
                                             bool cull, float& best_t, int& best_i) {
  walk_set<true>(sph, r, t_min, t_max, cull, best_t, best_i);
  walk_set<false>(tri, r, t_min, t_max, cull, best_t, best_i);
}

}  // namespace rt
