// The pair tests of the brute-force searches, one ray against one sphere or
// one triangle of the packed tables, and the minimum of a group of lanes
// that share a ray.  Shared by K1's search (megakernel.cu), K2/K2b
// (nearest.cu) and K3/K3b (prim_nearest.cu).
//
// The arithmetic is rt_tpu/pallas_ops.py `_prim_kernel`'s (hittable.rs:318-338
// for the sphere, :411-461 for the triangle), operation for operation, as
// the plain PyTorch versions compute it (nearest_ops.sphere_nearest_packed_plain,
// prim_ops._triangle_nearest_plain).  Built with -fmad=false and IEEE
// division and sqrt, a test gives the plain version's t bit for bit.
//
// The sphere test takes its square root late, in two passes over a batch
// of up to 32 rows (`sphere_batch`).  The first pass computes every row's
// discriminant alone and marks the rows with disc >= 0 and a positive
// radius in a bit mask; the second visits the marked rows in ascending
// order and computes the root, both candidate distances and the choice
// between them.  Those conditions were always part of the hit test, so no
// unmarked row is a hit, and a marked row runs the same operations as
// before: with the strict `<` scan kept in ascending order, results are
// unchanged.  A rejected pair, nearly every pair of a scene, costs ~18
// operations instead of ~24 and no IEEE square root (a sequence of several
// instructions).  Deferring the root out of the first loop matters on this
// card: a branch inside it would run on a warp whenever any of its 32
// lanes admits its pair, most iterations for incoherent rays, while the
// second pass costs a warp only the largest number of marked rows among
// its lanes.
//
// Neither test compares against a best t: the caller keeps the nearest hit
// (a strict `<` scan, or a minimum over packed keys).
//
// K2 and K3 give a ray to a group of lanes, each lane scanning a stride of
// the rows with a strict `<` scan from (BIG, -1); `group_nearest` then
// takes the least packed key (order_key(t), id) over the group, the
// winning t travelling with its key.  That is the sequential scan's
// result: a lane's scan returns the first of its least t, and the key's
// minimum the first of all lanes' least t.  A lane that found nothing
// holds the key ~0, which ranks above every hit, so a miss stays (BIG,
// -1), and a hit needs t < BIG whatever t_max is, as the scan from BIG
// requires.
#pragma once

#include "rt_common.cuh"

namespace rt {

constexpr float kTriEps = 1.0e-7f;  // det and t floor of the triangle test (hittable.rs:428, 461)

// A ray with |d|^2 and its reciprocal, which every sphere test needs.
struct PairRay {
  float ox, oy, oz, dx, dy, dz, a, inv_a;
};

__device__ __forceinline__ PairRay pair_ray(float ox, float oy, float oz, float dx, float dy,
                                            float dz) {
  const float a = dx * dx + dy * dy + dz * dz;
  return PairRay{ox, oy, oz, dx, dy, dz, a, 1.0f / a};
}

// The discriminant test of sphere s = (center xyz, radius): does the ray's
// line meet it (disc >= 0), and is it not a pad row (radius 0)?  Sets the
// half-b h and disc.
__device__ __forceinline__ bool sphere_admits(const float4 s, const PairRay& r, float& h,
                                              float& disc) {
  const float ocx = s.x - r.ox, ocy = s.y - r.oy, ocz = s.z - r.oz;
  h = r.dx * ocx + r.dy * ocy + r.dz * ocz;
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - s.w * s.w;
  disc = h * h - r.a * c;
  return disc >= 0.0f && s.w > 0.0f;
}

// Sphere s: the half-b quadratic, the near root if it is at least t_min,
// else the far one.  True, with t, on a hit in [t_min, t_max).
__device__ __forceinline__ bool sphere_pair(const float4 s, const PairRay& r, float t_min,
                                            float t_max, float& t) {
  float h, disc;
  if (!sphere_admits(s, r, h, disc)) return false;
  const float sd = sqrtf(fmaxf(disc, 0.0f));
  const float t0 = (h - sd) * r.inv_a;
  const float t1 = (h + sd) * r.inv_a;
  t = t0 >= t_min ? t0 : t1;
  return t >= t_min && t < t_max;
}

// A strict `<` scan of m <= 32 sphere rows, row(b) for b = 0..m-1 in
// ascending order, with ids id0 + id_step * b, into (best_t, best_i): the
// discriminants first, then the roots of the rows they admit.
template <class Row>
__device__ __forceinline__ void sphere_batch(Row row, int m, int id0, int id_step,
                                             const PairRay& r, float t_min, float t_max,
                                             float& best_t, int& best_i) {
  unsigned marked = 0u;
  for (int b = 0; b < m; ++b) {
    float h, disc;
    if (sphere_admits(row(b), r, h, disc)) marked |= 1u << b;
  }
  for (; marked; marked &= marked - 1u) {
    const int b = __ffs(marked) - 1;
    float t;
    if (sphere_pair(row(b), r, t_min, t_max, t) && t < best_t) {
      best_t = t;
      best_i = id0 + id_step * b;
    }
  }
}

// The nearest hit of a group of G adjacent lanes (G a power of two, at most
// 32) that share a ray: every lane's (best_t, best_i) becomes the group's
// least (order_key(t), id), or (BIG, -1) when no lane has a hit.  Every
// lane of the warp must call it.
template <int G>
__device__ __forceinline__ void group_nearest(float& best_t, int& best_i) {
  constexpr unsigned long long kMiss = ~0ull;
  unsigned long long key =
      best_i < 0 ? kMiss : ((unsigned long long)order_key(best_t) << 32) | (unsigned)best_i;
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) {
    const unsigned long long other = __shfl_xor_sync(kFullMask, key, off);
    const float other_t = __shfl_xor_sync(kFullMask, best_t, off);
    if (other < key) {
      key = other;
      best_t = other_t;
    }
  }
  best_t = key == kMiss ? BIG : best_t;
  best_i = key == kMiss ? -1 : (int)(unsigned)key;
}

// Triangle row (r0, r1, r2) = (a xyz, e1.x | e1.yz, e2.xy | e2.z, live,
// pad, pad): Möller–Trumbore with the determinant cull.  True, with t, on a
// hit in [t_min, t_max) above kTriEps.  A pad row (live 0) never hits.
__device__ __forceinline__ bool triangle_pair(const float4 r0, const float4 r1, const float4 r2,
                                              const PairRay& r, bool cull, float t_min,
                                              float t_max, float& t) {
  if (!(r2.y > 0.5f)) return false;
  const float ax = r0.x, ay = r0.y, az = r0.z;
  const float e1x = r0.w, e1y = r1.x, e1z = r1.y;
  const float e2x = r1.z, e2y = r1.w, e2z = r2.x;
  const float uvx = r.dy * e2z - r.dz * e2y;
  const float uvy = r.dz * e2x - r.dx * e2z;
  const float uvz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * uvx + e1y * uvy + e1z * uvz;
  const bool det_ok = cull ? det > kTriEps : fabsf(det) > kTriEps;
  const float inv_det = 1.0f / (det_ok ? det : 1.0f);
  const float aox = r.ox - ax, aoy = r.oy - ay, aoz = r.oz - az;
  const float u = (aox * uvx + aoy * uvy + aoz * uvz) * inv_det;
  const float vvx = aoy * e1z - aoz * e1y;
  const float vvy = aoz * e1x - aox * e1z;
  const float vvz = aox * e1y - aoy * e1x;
  const float v = (r.dx * vvx + r.dy * vvy + r.dz * vvz) * inv_det;
  t = (e2x * vvx + e2y * vvy + e2z * vvz) * inv_det;
  return det_ok && u >= 0.0f && u <= 1.0f && v >= 0.0f && u + v <= 1.0f && t >= t_min &&
         t < t_max && t > kTriEps;
}

}  // namespace rt
