// Path-tracing megakernels for Hopper (sm_90a): K1 (flat) and K5
// (clustered).
//
// Replace the TPU kernel rt_tpu/megakernel.py `_mega_kernel` in flat mode
// (K1, launched by `_mega_exec`, rt_tpu/megakernel.py:3479) and in clustered
// mode (K5, launched by `_mega_exec_clustered`, :3768).  Both compute the
// same thing: for each pixel of a contiguous range, `spp` camera samples,
// each traced through the whole bounce loop (Halton camera ray + thin-lens
// defocus, nearest sphere/triangle, shade-table fetch, solid/checker/image
// texture, lambertian/metal/dielectric(+frost)/emissive scatter, Russian
// roulette, Perez or Hosek sky through Uncharted2), and write the mean
// radiance of the pixel.  They differ in the search and in the shade table
// it indexes: K1 brute-forces every primitive and reads the per-primitive
// table; K5 walks the cluster tables (cluster_walk.cuh) and reads the
// slot-ordered table by the winner's slot id, the full table and not the
// TPU kernel's inline essentials (which quantize fuzz to 12 bits).  The
// plain PyTorch version of both is `render_megakernel_plain` in
// rt_tpu_torch/megakernel.py.
//
// Common to both.  The RNG keys on the global work id gwork = sample * W *
// H + pixel, so which thread renders which sample cannot change the image,
// and a pixel's samples are summed in sample order, whichever lanes traced
// them: no float atomics, so two launches give bit-identical images.  The
// TPU mechanisms go: no one-hot matmul fetch, bf16 hi/lo split, rank-1
// deposit matmul or packed-mantissa argmin.  The winner's shade row and the
// texel are direct loads, the argmin is exact with the lowest id winning
// ties (spheres first), and sqrt/sin/cos/acos/atan2/exp are the native
// functions.  One bounce after the search (`bounce`: shading, scatter,
// Russian roulette, the next segment) is one device function that both
// kernels call, and both claim their work with one atomicAdd a warp
// (`warp_claim`; K1's 64-bit counter `warp_claim_items`).
//
// K1 is a persistent grid of converged warps over (pixel, sample) work
// items, one launch a call.  Items are numbered pixel-major, k = i * spp +
// s, by a 64-bit counter, so a warp's claim is mostly neighbouring samples
// of one pixel, whose camera rays lie close together.  Each step, the lanes
// without an item claim the next ones, then every live lane searches its
// own ray, brute force over every primitive with the shared late-sqrt pair
// tests (brute_force.cuh; the lanes of a warp test the same sphere at
// once, a broadcast load), and shades its hit.  A finished path writes its
// radiance to a ring of P pixel slots, scratch f32[P, spp, 3] within the
// wrapper's SCRATCH_CAP (megakernel.ring_slots).  The slots go round a
// queue in pixel order: pixel i takes the slot at place i, which the
// (i - P)-th pixel summed put there, whichever pixel that was, so a pixel
// whose last path runs long holds one slot and no later pixel waits on it
// in particular.  A lane whose path ended before its pixel has a slot
// keeps the radiance and stores it on a later step; it never spins while
// its warp has live paths.  The queue cannot stall: the lowest pixel
// without a slot has every earlier item claimed, and every earlier pixel
// holds a slot, so all of them are summed and hand theirs on, and a slot
// handed on waits only for an earlier place to be taken.  The lane that
// counts a pixel's last sample sums the slot in sample order, acc = acc +
// c_s from 0, writes out = acc * inv_spp, as the plain version computes
// it, and hands the slot on.  What bounds it on this
// card: ~18 operations for each (ray segment, sphere) pair the
// discriminant rejects, ~24 for one it admits, ~46 for a triangle, from the
// issue slots of 132 SMs.  The first port gave a pixel to one thread, which
// filled the card only from ~1600x900 (the bench frame's 90,000 pixels
// half-filled it, and each thread ran its pixel's paths in series), and
// each warp waited for its longest path; here the resident lanes stay busy
// as long as items are left, and the primitive loop, the same for every
// lane, does not diverge.  One launch a call leaves one drain, at the
// end, where the last long paths hold few warps; a launch a chunk of
// samples drained once a chunk (~1.4 ms each on the 640-spp cover).
//
// K5 drops the TPU's clustered machinery (row sweep, streamed DMA ring,
// expansion sweep, lane binning, winner fetch) and keeps its persistent
// pool.  A persistent grid of warps runs a converged step loop: at each
// step every lane with work starts its pixel's next sample or continues its
// path; the warp then walks its lanes' rays one after another, all 32 lanes
// on each (cluster_walk.cuh); then each lane shades its own hit.  A lane
// that has summed its pixel's `spp` samples writes the pixel and claims the
// next.  What bounded the first port (one thread a pixel, walking alone:
// 0.27% of its operation bound) was the walk's load latency and a warp
// waiting for its longest path; here the walk's cost follows the number of
// live paths, not the longest one, each of its steps has 32 pieces of work,
// and its loads are coalesced rows.  What is left is the walk's chain of
// dependent steps per ray and the divergent shading, which the resident
// warps overlap.
#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

#include "brute_force.cuh"
#include "cluster_walk.cuh"
#include "rt_common.cuh"

namespace rt {
namespace {

constexpr int kFlatBlock = 256;       // K1: eight warps a block
constexpr int kClusteredBlock = 256;  // K5: eight warps a block
// K5's blocks an SM, asked of ptxas: three hold it at 80 registers a thread,
// 24 warps an SM.  Left to itself ptxas gives the near-to-far walk 111
// registers and 16 warps, which the car preview runs ~7% slower (PERF.md).
constexpr int kClusteredMinBlocks = 3;

struct Hit {
  float t;
  int prim;  // global id: spheres first, then triangles; -1 on a miss
};

// Nearest hit of the ray over all spheres, then all triangles, a strict
// `<` scan (megakernel.py:751-852).
__device__ __forceinline__ Hit nearest(const Params& p, const Ints& q,
                                       const float4* __restrict__ sph,
                                       const float4* __restrict__ tri, const PairRay& r) {
  const bool cull = q.flags & FLAG_BACKFACE_CULL;
  Hit best{BIG, -1};
  for (int i0 = 0; i0 < q.n_spheres; i0 += 32) {
    sphere_batch([&](int b) { return __ldg(&sph[i0 + b]); }, min(32, q.n_spheres - i0), i0, 1, r,
                 p.t_min, p.t_max, best.t, best.prim);
  }
  for (int j = 0; j < q.n_tris; ++j) {
    float t;
    if (triangle_pair(__ldg(&tri[3 * j]), __ldg(&tri[3 * j + 1]), __ldg(&tri[3 * j + 2]), r, cull,
                      p.t_min, p.t_max, t) &&
        t < best.t) {
      best.t = t;
      best.prim = q.n_spheres + j;
    }
  }
  return best;
}

__device__ __forceinline__ float uncharted2(float x) {
  // (x(Ax + CB) + DE) / (x(Ax + B) + DF) - E/F, constants folded in double
  // and rounded once, as the JAX package folds its python floats.
  const float A = 0.15f, B = 0.5f;
  const float CB = (float)(0.10 * 0.50), DE = (float)(0.20 * 0.02);
  const float DF = (float)(0.20 * 0.30), EF = (float)(0.02 / 0.30);
  return (x * (A * x + CB) + DE) / (x * (A * x + B) + DF) - EF;
}

__device__ __forceinline__ float tonemap(const Params& p, float v) {
  return fmaxf(p.white_scale * uncharted2(1.1f * v), 0.0f);
}

__device__ __forceinline__ float perez(const float* c, float cos_theta, float gamma,
                                       float cos_gamma) {
  return (1.0f + c[0] * expf(c[1] / fmaxf(cos_theta, 0.01f))) *
         (1.0f + c[2] * expf(c[3] * gamma) + c[4] * cos_gamma * cos_gamma);
}

// Tonemapped sky radiance toward unit direction u (megakernel.py:3094-3153).
__device__ float3 sky(const Params& p, int flags, float ux, float uy, float uz) {
  const float cos_theta = clampf(uz, 0.01f, 1.0f);
  float cos_gamma = clampf(ux * p.sun[0] + uy * p.sun[1] + uz * p.sun[2], -1.0f, 1.0f);
  float gamma;
  if (flags & FLAG_COS_GAMMA_AS_ANGLE) {  // hittable.rs:86 quirk
    gamma = cos_gamma;
    cos_gamma = cosf(gamma);
  } else {
    gamma = acosf(clampf(cos_gamma, (float)(-1.0 + 1e-6), (float)(1.0 - 1e-6)));
  }
  if (flags & FLAG_HOSEK) {
    const float sq = sqrtf(fmaxf(cos_theta, 0.0f));
    float rgb[3];
    for (int ch = 0; ch < 3; ++ch) {
      const float* w = p.hw + 10 * ch;
      const float den = fmaxf(1.0f + w[7] * w[7] - 2.0f * w[7] * cos_gamma, 1e-6f);
      const float chi = (1.0f + cos_gamma * cos_gamma) / (den * sqrtf(den));
      const float val = (1.0f + w[0] * expf(w[1] / fmaxf(cos_theta, 0.01f))) *
                        (w[2] + w[3] * expf(w[4] * gamma) + w[5] * cos_gamma * cos_gamma +
                         w[6] * chi + w[8] * sq);
      rgb[ch] = tonemap(p, fmaxf(val * w[9], 0.0f));
    }
    return make_float3(rgb[0], rgb[1], rgb[2]);
  }
  const float y_lum = fmaxf(perez(p.coef_y, cos_theta, gamma, cos_gamma) * p.zy, 0.0f);
  const float x_c = perez(p.coef_x, cos_theta, gamma, cos_gamma) * p.zx;
  const float y_c = fmaxf(perez(p.coef_yc, cos_theta, gamma, cos_gamma) * p.zyc, 1e-6f);
  const float big_x = x_c / y_c * y_lum;
  const float big_z = (1.0f - x_c - y_c) / y_c * y_lum;
  const float r = fmaxf(3.2404542f * big_x + -1.5371385f * y_lum + -0.4985314f * big_z, 0.0f);
  const float g = fmaxf(-0.9692660f * big_x + 1.8760108f * y_lum + 0.0415560f * big_z, 0.0f);
  const float b = fmaxf(0.0556434f * big_x + -0.2040259f * y_lum + 1.0572252f * big_z, 0.0f);
  return make_float3(tonemap(p, r), tonemap(p, g), tonemap(p, b));
}

// Texture coordinates of the hit for an image lookup (megakernel.py:2890-2957).
__device__ float2 hit_uv(const float* __restrict__ f, bool is_sphere, bool bbox_remap,
                         float snx, float sny, float snz, float ox, float oy, float oz,
                         float dx, float dy, float dz) {
  if (is_sphere) {
    // Facing rotation from the per-primitive trig (hittable.rs:367-406).
    const float cyw = __ldg(f + F_CYW), syw = __ldg(f + F_SYW);
    const float cp = __ldg(f + F_CP), sp = __ldg(f + F_SP);
    const float qx = cyw * snx + syw * sny;
    const float qy = -syw * snx + cyw * sny;
    float rx = cp * qx + sp * snz;
    const float ry = qy;
    const float rz = -sp * qx + cp * snz;
    if (rx * rx + ry * ry < 1e-12f) rx = 1.0f;
    const float pi = (float)3.141592653589793;
    const float two_pi = (float)(2.0 * 3.141592653589793);
    const float theta = acosf(clampf(-rz, (float)(-1.0 + 1e-7), (float)(1.0 - 1e-7)));
    const float phi = atan2f(ry, rx) + pi;
    const float phi_m = phi - floorf(phi / two_pi) * two_pi;
    return make_float2(phi_m * (float)(0.5 / 3.141592653589793),
                       theta * (float)(1.0 / 3.141592653589793));
  }
  // Triangle barycentrics recomputed for the winner (hittable.rs:433-452).
  const float ax = __ldg(f + F_AX), ay = __ldg(f + F_AY), az = __ldg(f + F_AZ);
  const float e1x = __ldg(f + F_BX) - ax, e1y = __ldg(f + F_BY) - ay, e1z = __ldg(f + F_BZ) - az;
  const float e2x = __ldg(f + F_CX) - ax, e2y = __ldg(f + F_CY) - ay, e2z = __ldg(f + F_CZ) - az;
  const float uvx = dy * e2z - dz * e2y;
  const float uvy = dz * e2x - dx * e2z;
  const float uvz = dx * e2y - dy * e2x;
  const float det = e1x * uvx + e1y * uvy + e1z * uvz;
  const float inv_det = 1.0f / (fabsf(det) > 1e-20f ? det : 1.0f);
  const float aox = ox - ax, aoy = oy - ay, aoz = oz - az;
  const float bu = (aox * uvx + aoy * uvy + aoz * uvz) * inv_det;
  const float vvx = aoy * e1z - aoz * e1y;
  const float vvy = aoz * e1x - aox * e1z;
  const float vvz = aox * e1y - aoy * e1x;
  const float bv = (dx * vvx + dy * vvy + dz * vvz) * inv_det;
  const float ua_u = __ldg(f + F_UVA + 0), ua_v = __ldg(f + F_UVA + 1);
  const float ub_u = __ldg(f + F_UVA + 2), ub_v = __ldg(f + F_UVA + 3);
  const float uc_u = __ldg(f + F_UVA + 4), uc_v = __ldg(f + F_UVA + 5);
  if (bbox_remap) {  // reference quirk (hittable.rs:466-481)
    const float lo_u = fminf(fminf(ua_u, ub_u), uc_u), hi_u = fmaxf(fmaxf(ua_u, ub_u), uc_u);
    const float lo_v = fminf(fminf(ua_v, ub_v), uc_v), hi_v = fmaxf(fmaxf(ua_v, ub_v), uc_v);
    return make_float2(lo_u + (hi_u - lo_u) * bu, lo_v + (hi_v - lo_v) * bv);
  }
  const float w0 = 1.0f - bu - bv;
  return make_float2(w0 * ua_u + bu * ub_u + bv * uc_u, w0 * ua_v + bu * ub_v + bv * uc_v);
}

// One lane's path between bounces: the segment to search next, the
// throughput so far, and the keys of its draws.
struct Path {
  float ox, oy, oz, dx, dy, dz;
  float tpr, tpg, tpb;
  uint32_t gid;
  int depth;
};

// The camera ray of sample `s` of pixel `pix` (megakernel.py:493-530).
__device__ __forceinline__ Path camera_path(const Params& p, const Ints& q, uint32_t pix, int s) {
  const float fx0 = (float)(int)(pix % (uint32_t)q.width);
  const float fy0 = (float)(int)(pix / (uint32_t)q.width);
  const uint32_t samp = (uint32_t)(q.sample_offset + s);
  const uint32_t gwork = samp * (uint32_t)q.n_global + pix;  // int32 wrap, as in JAX

  // Halton jitter by sample index (camera.rs:239), optionally scrambled
  // per pixel with purposes 5/6.
  float off_u = radical2(samp + 1u);
  float off_v = radical3(samp + 1u);
  if (!(q.flags & FLAG_SHARED_JITTER)) {
    off_u = off_u + uniform01(q.seed, pix, 0u, 5u);
    off_u = off_u - floorf(off_u);
    off_v = off_v + uniform01(q.seed, pix, 0u, 6u);
    off_v = off_v - floorf(off_v);
  }
  const float fx = fx0 + off_u, fy = fy0 + off_v;
  const float sx = p.pix00[0] + fx * p.du[0] + fy * p.dv[0];
  const float sy = p.pix00[1] + fx * p.du[1] + fy * p.dv[1];
  const float sz = p.pix00[2] + fx * p.du[2] + fy * p.dv[2];
  float ox = p.center[0], oy = p.center[1], oz = p.center[2];
  if (q.flags & FLAG_DEFOCUS) {  // thin lens, purposes 21/22 (camera.rs:366-371)
    const float r = sqrtf(uniform01(q.seed, gwork, 0u, 21u));
    const float th = uniform01(q.seed, gwork, 0u, 22u) * (float)(2.0 * 3.141592653589793);
    const float dskx = r * cosf(th), dsky = r * sinf(th);
    ox = p.center[0] + dskx * p.dku[0] + dsky * p.dkv[0];
    oy = p.center[1] + dskx * p.dku[1] + dsky * p.dkv[1];
    oz = p.center[2] + dskx * p.dku[2] + dsky * p.dkv[2];
  }
  return Path{ox, oy, oz, sx - ox, sy - oy, sz - oz, 1.0f, 1.0f, 1.0f, gwork, 0};
}

// One bounce of path `ps` after its search found `hit` (megakernel.py:
// 2788-3216 for one lane).  `table` holds one row of F_ROWS values per id
// the search returns.  Returns true when the path ends, with its radiance
// in `out`; otherwise advances `ps` to its next segment.
__device__ __forceinline__ bool bounce(const Params& p, const Ints& q, const float* __restrict__ table,
                       const float* __restrict__ atlas, Hit hit, Path& ps, float3& out) {
  const float ox = ps.ox, oy = ps.oy, oz = ps.oz, dx = ps.dx, dy = ps.dy, dz = ps.dz;
  const float tpr = ps.tpr, tpg = ps.tpg, tpb = ps.tpb;
  const uint32_t gid = ps.gid;
  const int depth = ps.depth;
  const float a = dx * dx + dy * dy + dz * dz;
  const float inv_dn = 1.0f / fmaxf(sqrtf(a), 1e-20f);
  const float udx = dx * inv_dn, udy = dy * inv_dn, udz = dz * inv_dn;
  if (!(hit.t < BIG)) {
    const float3 s = sky(p, q.flags, udx, udy, udz);
    out = make_float3(tpr * s.x, tpg * s.y, tpb * s.z);
    return true;
  }
  const float* __restrict__ f = table + F_ROWS * hit.prim;
  const float px = ox + hit.t * dx, py = oy + hit.t * dy, pz = oz + hit.t * dz;

  // Normal and front face (hittable.rs:340-346, 464).
  const bool is_sphere = __ldg(f + F_IS_SPHERE) > 0.5f;
  const float inv_r = 1.0f / fmaxf(__ldg(f + F_RADIUS), 1e-20f);
  float snx = (px - __ldg(f + F_AX)) * inv_r;
  float sny = (py - __ldg(f + F_AY)) * inv_r;
  float snz = (pz - __ldg(f + F_AZ)) * inv_r;
  const bool s_front = dx * snx + dy * sny + dz * snz < 0.0f;
  const float sgn = s_front ? 1.0f : -1.0f;
  snx = snx * sgn;
  sny = sny * sgn;
  snz = snz * sgn;
  const float tnx = __ldg(f + F_NX), tny = __ldg(f + F_NY), tnz = __ldg(f + F_NZ);
  const bool t_front = dx * tnx + dy * tny + dz * tnz <= 0.0f;
  const float nx = is_sphere ? snx : tnx;
  const float ny = is_sphere ? sny : tny;
  const float nz = is_sphere ? snz : tnz;
  const bool front = is_sphere ? s_front : t_front;

  // Texture: solid, checker on floor(p / scale) parity, image.
  const float tex_kind = __ldg(f + F_TEX_KIND);
  const float inv_scale = __ldg(f + F_INV_SCALE);
  const int cells = (int)floorf(inv_scale * px) + (int)floorf(inv_scale * py) +
                    (int)floorf(inv_scale * pz);
  const bool use_even = tex_kind < 0.5f || (cells & 1) == 0;
  const int col = use_even ? F_CE : F_CO;
  float tr = __ldg(f + col), tg = __ldg(f + col + 1), tb = __ldg(f + col + 2);
  if ((q.flags & FLAG_IMAGES) && tex_kind > 1.5f) {
    const float2 uv = hit_uv(f, is_sphere, q.flags & FLAG_UV_BBOX_REMAP, snx, sny, snz, ox,
                             oy, oz, dx, dy, dz);
    // Nearest texel, clamped, index truncated (texture.rs:107-117).
    const float w_img = fmaxf(__ldg(f + F_RECT + 2), 1.0f);
    const float h_img = fmaxf(__ldg(f + F_RECT + 3), 1.0f);
    const int ix = (int)(clampf(uv.x, 0.0f, 1.0f) * (w_img - 1.0f));
    const int iy = (int)(clampf(uv.y, 0.0f, 1.0f) * (h_img - 1.0f));
    const int tx = min(max((int)__ldg(f + F_RECT + 0) + ix, 0), q.atlas_w - 1);
    const int ty = min(max((int)__ldg(f + F_RECT + 1) + iy, 0), q.atlas_h - 1);
    const float* texel = atlas + 3 * (ty * q.atlas_w + tx);
    tr = __ldg(texel);
    tg = __ldg(texel + 1);
    tb = __ldg(texel + 2);
  }

  const float kind = __ldg(f + F_MAT_KIND);
  if (kind > 2.5f) {  // emissive: deposit and terminate
    out = make_float3(tpr * tr, tpg * tg, tpb * tb);
    return true;
  }

  // Scatter draws: purposes 3..9 keyed on (gid, depth) (material.rs).
  const uint32_t seed = q.seed, dep = (uint32_t)depth;
  const float ux3 = uniform01(seed, gid, dep, 3) * 2.0f - 1.0f;
  const float uy3 = uniform01(seed, gid, dep, 4) * 2.0f - 1.0f;
  const float uz3 = uniform01(seed, gid, dep, 5) * 2.0f - 1.0f;
  const float inv_n1 = 1.0f / fmaxf(sqrtf(ux3 * ux3 + uy3 * uy3 + uz3 * uz3), 1e-12f);
  const float r1x = ux3 * inv_n1, r1y = uy3 * inv_n1, r1z = uz3 * inv_n1;
  const float vx3 = uniform01(seed, gid, dep, 6) * 2.0f - 1.0f;
  const float vy3 = uniform01(seed, gid, dep, 7) * 2.0f - 1.0f;
  const float vz3 = uniform01(seed, gid, dep, 8) * 2.0f - 1.0f;
  const float inv_n2 = 1.0f / fmaxf(sqrtf(vx3 * vx3 + vy3 * vy3 + vz3 * vz3), 1e-12f);
  const float r2x = vx3 * inv_n2, r2y = vy3 * inv_n2, r2z = vz3 * inv_n2;
  const float noise = uniform01(seed, gid, dep, 9);

  float new_dx, new_dy, new_dz;
  float att_r = tr, att_g = tg, att_b = tb;
  const float fuzz = __ldg(f + F_FUZZ);
  if (kind < 0.5f) {
    // Lambertian: n + unit, near-zero fallback (material.rs:110-120).
    new_dx = nx + r1x;
    new_dy = ny + r1y;
    new_dz = nz + r1z;
    if (fabsf(new_dx) < 3.45e-4f && fabsf(new_dy) < 3.45e-4f && fabsf(new_dz) < 3.45e-4f) {
      new_dx = nx;
      new_dy = ny;
      new_dz = nz;
    }
  } else if (kind < 1.5f) {
    // Metal: reflect the raw direction + fuzz * unit (material.rs:94-107).
    const float d_dot_n = dx * nx + dy * ny + dz * nz;
    new_dx = dx - 2.0f * d_dot_n * nx + fuzz * r2x;
    new_dy = dy - 2.0f * d_dot_n * ny + fuzz * r2y;
    new_dz = dz - 2.0f * d_dot_n * nz + fuzz * r2z;
  } else {
    // Dielectric with optional frost (material.rs:150-178).
    const float ior = __ldg(f + F_IOR);
    const float ri = front ? 1.0f / ior : ior;
    const float cos_t = fminf(-(udx * nx + udy * ny + udz * nz), 1.0f);
    const float sin_t = sqrtf(fmaxf(1.0f - cos_t * cos_t, 0.0f));
    const bool cannot = ri * sin_t > 1.0f;
    float r0 = (1.0f - ri) / (1.0f + ri);
    r0 = r0 * r0;
    const float omc = 1.0f - cos_t;
    const float omc2 = omc * omc;
    const float reflectance = r0 + (1.0f - r0) * omc2 * omc2 * omc;
    float ddx, ddy, ddz;
    if (cannot || reflectance > noise) {
      const float ud_dot_n = udx * nx + udy * ny + udz * nz;
      ddx = udx - 2.0f * ud_dot_n * nx;
      ddy = udy - 2.0f * ud_dot_n * ny;
      ddz = udz - 2.0f * ud_dot_n * nz;
    } else {
      const float rpx = (udx + nx * cos_t) * ri;
      const float rpy = (udy + ny * cos_t) * ri;
      const float rpz = (udz + nz * cos_t) * ri;
      const float perp_sq = rpx * rpx + rpy * rpy + rpz * rpz;
      const float par = -sqrtf(fmaxf(fabsf(1.0f - perp_sq), 1e-12f));
      ddx = rpx + par * nx + fuzz * r2x;
      ddy = rpy + par * ny + fuzz * r2y;
      ddz = rpz + par * nz + fuzz * r2z;
    }
    const float inv_dd = 1.0f / fmaxf(sqrtf(ddx * ddx + ddy * ddy + ddz * ddz), 1e-20f);
    new_dx = ddx * inv_dd;
    new_dy = ddy * inv_dd;
    new_dz = ddz * inv_dd;
    att_r = att_g = att_b = 1.0f;
  }

  // Russian roulette, purpose 10 (camera.rs:280-293; clamped).
  const float p_rr = clampf(fmaxf(fmaxf(att_r, att_g), att_b), 0.0f, p.rr_clamp);
  if (!(uniform01(seed, gid, dep, 10) < p_rr) || depth >= q.max_depth) {
    out = make_float3(0.0f, 0.0f, 0.0f);
    return true;
  }
  const float inv_p = 1.0f / fmaxf(p_rr, 1e-12f);

  // New origin, offset along the normal toward the outgoing side by an
  // amount that scales with the hit point's magnitude.
  const float scale = fmaxf(fmaxf(fabsf(px), fmaxf(fabsf(py), fabsf(pz))), 1.0f);
  const float off = p.origin_offset * scale * signf(new_dx * nx + new_dy * ny + new_dz * nz);
  ps.ox = px + off * nx;
  ps.oy = py + off * ny;
  ps.oz = pz + off * nz;
  ps.dx = new_dx;
  ps.dy = new_dy;
  ps.dz = new_dz;
  ps.tpr = tpr * att_r * inv_p;
  ps.tpg = tpg * att_g * inv_p;
  ps.tpb = tpb * att_b * inv_p;
  ps.depth = depth + 1;
  return false;
}

// The next indices of `counter` for the lanes with `need` set, one each in
// lane order, by one atomicAdd a warp; -1 for the other lanes.  Every lane
// of the warp must call it.
__device__ __forceinline__ int warp_claim(bool need, int* __restrict__ counter, int lane) {
  const unsigned need_m = __ballot_sync(kFullMask, need);
  if (need_m == 0u) return -1;
  const int leader = __ffs(need_m) - 1;
  int first = 0;
  if (lane == leader) first = atomicAdd(counter, __popc(need_m));
  first = __shfl_sync(kFullMask, first, leader);
  return need ? first + __popc(need_m & ((1u << lane) - 1u)) : -1;
}

// The next items of the 64-bit `counter` for the lanes with `need` set,
// as `warp_claim` takes them; -1 for the other lanes.
__device__ __forceinline__ long long warp_claim_items(bool need,
                                                      unsigned long long* __restrict__ counter,
                                                      int lane) {
  const unsigned need_m = __ballot_sync(kFullMask, need);
  if (need_m == 0u) return -1;
  const int leader = __ffs(need_m) - 1;
  unsigned long long first = 0;
  if (lane == leader) first = atomicAdd(counter, (unsigned long long)__popc(need_m));
  first = __shfl_sync(kFullMask, first, leader);
  return need ? (long long)first + __popc(need_m & ((1u << lane) - 1u)) : -1;
}

// K1's ring in device memory, zero at launch.  Pixel i takes the slot at
// place i of a queue of P cells: cell i % P in round i / P (round 0's cells
// hold slots 0..P-1).  The t-th pixel summed hands its slot on to place
// t + P, once pixel t has taken that cell's slot of the round before.
struct Ring {
  unsigned long long* next_item;  // the claim counter
  unsigned int* waits;            // steps lanes waited for a slot, or to hand one on
  unsigned int* summed;           // pixels summed so far
  int* done;                      // per slot: samples stored
  int* turn;                      // per cell: 2r while it holds round r's slot, 2r + 1 once taken
  int* cell;                      // per cell: that slot (rounds from 1)
  int* slot_of;                   // per pixel of the range: its slot + 1; 0 before it has one
};

// Pixel i's slot, or -1 while its place in the queue is empty.  The first
// lane to find the slot records it in slot_of and frees the cell.
__device__ __forceinline__ int pixel_slot(const Ring& ring, int n_slots, int i) {
  const int known = *(const volatile int*)(ring.slot_of + i);
  if (known > 0) return known - 1;
  const int c = i % n_slots, r = i / n_slots;
  if (*(const volatile int*)(ring.turn + c) != 2 * r) return -1;
  __threadfence();  // the cell is read after its turn
  const int slot = r == 0 ? c : *(const volatile int*)(ring.cell + c);
  const int prev = atomicCAS(ring.slot_of + i, 0, slot + 1);
  if (prev != 0) return prev - 1;  // another lane took it first (the cell may have moved on)
  __threadfence();
  atomicExch(ring.turn + c, 2 * r + 1);
  return slot;
}

// Puts `slot`, freed by the t-th pixel summed, at place t + P of the queue:
// false while pixel t has not taken the cell's slot of the round before.
__device__ __forceinline__ bool hand_on(const Ring& ring, int n_slots, unsigned int t, int slot) {
  const int c = (int)(t % (unsigned int)n_slots), r = (int)(t / (unsigned int)n_slots) + 1;
  if (*(const volatile int*)(ring.turn + c) != 2 * r - 1) return false;
  *(volatile int*)(ring.cell + c) = slot;
  __threadfence();  // the slot's sum, its reset count and the cell come before the turn
  atomicExch(ring.turn + c, 2 * r);
  return true;
}

// A lane's state in K1's step loop.
enum : int { kIdle, kLive, kStore, kHandOn, kDone };

// K1: a persistent grid of warps in a converged step loop over the launch's
// n_pixels * spp items (see the top of this file).  Item k = i * spp + s
// traces sample s of pixel i into row s of the pixel's slot.
__global__ void __launch_bounds__(kFlatBlock)
    megakernel_flat(const Params p, const Ints q, long long n_items, int n_slots,
                    const float4* __restrict__ sph, const float4* __restrict__ tri,
                    const float* __restrict__ table, const float* __restrict__ atlas,
                    float* __restrict__ scratch, const Ring ring, float* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  Path ps{};
  int state = kIdle;
  int i = 0, s = 0;       // the item's pixel in the range and sample
  float3 c;               // its radiance, once the path has ended
  int slot = 0;           // the slot of a summed pixel, to hand on ...
  unsigned int t = 0;     // ... to place t + P of the queue
  unsigned int waited = 0;
  for (;;) {
    const bool need = state == kIdle;
    const long long claimed = warp_claim_items(need, ring.next_item, lane);
    if (need) {
      if (claimed < n_items) {
        i = (int)(claimed / q.spp);
        s = (int)(claimed - (long long)i * q.spp);
        ps = camera_path(p, q, (uint32_t)(q.pixel_base + i), s);
        state = kLive;
      } else {
        state = kDone;
      }
    }
    if (!__any_sync(kFullMask, state != kDone)) break;
    if (__any_sync(kFullMask, state == kLive)) {
      if (state == kLive) {
        const Hit hit =
            nearest(p, q, sph, tri, pair_ray(ps.ox, ps.oy, ps.oz, ps.dx, ps.dy, ps.dz));
        if (bounce(p, q, table, atlas, hit, ps, c)) state = kStore;
      }
    } else {
      __nanosleep(256);  // every lane waits on the queue: let the other warps run
    }
    if (state == kStore) {
      const int got = pixel_slot(ring, n_slots, i);
      if (got < 0) {
        ++waited;
      } else {
        float* row = scratch + 3LL * q.spp * got;
        __stcg(row + 3 * s + 0, c.x);
        __stcg(row + 3 * s + 1, c.y);
        __stcg(row + 3 * s + 2, c.z);
        __threadfence();  // the sample is in L2 before it is counted
        state = kIdle;
        if (atomicAdd(ring.done + got, 1) == q.spp - 1) {  // the pixel's last sample
          __threadfence();
          float r = 0.0f, g = 0.0f, b = 0.0f;
          for (int k = 0; k < q.spp; ++k) {  // sample order, from L2
            r = r + __ldcg(row + 3 * k + 0);
            g = g + __ldcg(row + 3 * k + 1);
            b = b + __ldcg(row + 3 * k + 2);
          }
          out[3LL * i + 0] = r * p.inv_spp;
          out[3LL * i + 1] = g * p.inv_spp;
          out[3LL * i + 2] = b * p.inv_spp;
          atomicExch(ring.done + got, 0);
          slot = got;
          t = atomicAdd(ring.summed, 1u);
          state = kHandOn;
        }
      }
    }
    if (state == kHandOn) {
      if (hand_on(ring, n_slots, t, slot)) {
        state = kIdle;
      } else {
        ++waited;
      }
    }
  }
  const unsigned int warp_waited = __reduce_add_sync(kFullMask, waited);
  if (lane == 0 && warp_waited != 0u) atomicAdd(ring.waits, warp_waited);
}

// K5: a persistent grid of warps in a converged step loop (see the top of
// this file).  `next_pixel` is a device int, 0 at launch: the claim counter.
__global__ void __launch_bounds__(kClusteredBlock, kClusteredMinBlocks)
    megakernel_clustered(const Params p, const Ints q, const ClusterSet sph, const ClusterSet tri,
                         const float* __restrict__ table, const float* __restrict__ atlas,
                         float* __restrict__ out, int* __restrict__ next_pixel) {
  const int lane = threadIdx.x & 31;
  const bool cull = q.flags & FLAG_BACKFACE_CULL;
  Path ps{};
  bool alive = false;  // a path is in flight
  bool done = false;   // no pixel is left to claim
  int pix_i = -1;      // the lane's pixel in the launch's range; -1: none
  int s = 0;           // the lane's next sample of pix_i
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f;
  for (;;) {
    if (!alive && pix_i >= 0 && s == q.spp) {  // every sample summed: write the pixel
      out[3 * pix_i + 0] = acc_r * p.inv_spp;
      out[3 * pix_i + 1] = acc_g * p.inv_spp;
      out[3 * pix_i + 2] = acc_b * p.inv_spp;
      pix_i = -1;
    }
    const bool need = !alive && pix_i < 0 && !done;
    const int claimed = warp_claim(need, next_pixel, lane);
    if (need) {
      if (claimed < q.n_pixels) {
        pix_i = claimed;
        s = 0;
        acc_r = acc_g = acc_b = 0.0f;
      } else {
        done = true;
      }
    }
    if (!alive && pix_i >= 0) {
      ps = camera_path(p, q, (uint32_t)(q.pixel_base + pix_i), s);
      alive = true;
    }
    const unsigned active = __ballot_sync(kFullMask, alive);
    if (active == 0u) break;
    float t = BIG;
    int prim = -1;
    warp_walk_rays(sph, tri, active, ps.ox, ps.oy, ps.oz, ps.dx, ps.dy, ps.dz, p.t_min, p.t_max,
                   cull, lane, t, prim);
    float3 c;
    if (alive && bounce(p, q, table, atlas, Hit{t, prim}, ps, c)) {
      acc_r = acc_r + c.x;
      acc_g = acc_g + c.y;
      acc_b = acc_b + c.z;
      ++s;
      alive = false;
    }
  }
}

Params load_params(const float* params) {
  Params p;
  const float* src = params;
  float* dst = reinterpret_cast<float*>(&p);
  for (int k = 0; k < 80; ++k) dst[k] = src[k];
  return p;
}

std::atomic<int> resident_flat[kMaxDevices];       // megakernel_flat's grid per device
std::atomic<int> resident_clustered[kMaxDevices];  // megakernel_clustered's grid per device

// K1 over every sample of the range in one launch.
cudaError_t launch_flat(const Params& p, const Ints& q, int n_slots, const float4* sph,
                        const float4* tri, const float* table, const float* atlas, float* scratch,
                        const Ring& ring, float* out, cudaStream_t stream) {
  int fit = 0;
  const cudaError_t e = resident_blocks(megakernel_flat, kFlatBlock, resident_flat, fit);
  if (e != cudaSuccess) return e;
  if (q.spp < 1 || q.n_pixels < 1 || n_slots < 1 || n_slots > q.n_pixels) {
    return cudaErrorInvalidValue;
  }
  const long long items = (long long)q.n_pixels * q.spp;
  const long long want = (items + kFlatBlock - 1) / kFlatBlock;
  megakernel_flat<<<(int)(want < fit ? want : fit), kFlatBlock, 0, stream>>>(
      p, q, items, n_slots, sph, tri, table, atlas, scratch, ring, out);
  return cudaGetLastError();
}

cudaError_t launch_clustered(const Params& p, const Ints& q, const ClusterSet& sph,
                             const ClusterSet& tri, const float* table, const float* atlas,
                             float* out, int* next_pixel, cudaStream_t stream) {
  int fit = 0;
  const cudaError_t e =
      resident_blocks(megakernel_clustered, kClusteredBlock, resident_clustered, fit);
  if (e != cudaSuccess) return e;
  const int want = (q.n_pixels + kClusteredBlock - 1) / kClusteredBlock;
  megakernel_clustered<<<want < fit ? want : fit, kClusteredBlock, 0, stream>>>(
      p, q, sph, tri, table, atlas, out, next_pixel);
  return cudaGetLastError();
}

}  // namespace
}  // namespace rt

// C entry points, bound with ctypes by rt_tpu_torch/megakernel.py.
// `params` is a host pointer to 80 floats (rt::Params); every other pointer
// is device memory.  Each launches on `stream` and returns
// cudaGetLastError().

// K1 over samples [0, spp) of pixels [0, n_pixels) of the range, their
// mean into `out` f32[n_pixels, 3].  `table` is the per-primitive shade
// table, one row per primitive; `scratch` holds the ring f32[n_slots, spp,
// 3], 1 <= n_slots <= n_pixels; `ring` is int32[4 + 3 * n_slots +
// n_pixels], zero at launch: the 64-bit claim counter, the waited steps,
// the pixels summed, then per slot the samples stored, per queue cell its
// turn and its slot, and per pixel its slot + 1 (struct rt::Ring).
extern "C" int rt_megakernel_flat(const float* params, int n_pixels, int pixel_base, int spp,
                                  int sample_offset, unsigned int seed, int width, int n_global,
                                  int max_depth, int n_spheres, int n_tris, int atlas_h,
                                  int atlas_w, int flags, const float* sph, const float* tri,
                                  const float* table, const float* atlas, int n_slots,
                                  float* scratch, int* ring, float* out, void* stream) {
  const rt::Ints q{n_pixels, pixel_base, spp, sample_offset, seed, width, n_global, max_depth,
                   n_spheres, n_tris, atlas_h, atlas_w, flags};
  const rt::Ring r{reinterpret_cast<unsigned long long*>(ring),
                   reinterpret_cast<unsigned int*>(ring + 2),
                   reinterpret_cast<unsigned int*>(ring + 3),
                   ring + 4,
                   ring + 4 + n_slots,
                   ring + 4 + 2LL * n_slots,
                   ring + 4 + 3LL * n_slots};
  return static_cast<int>(rt::launch_flat(
      rt::load_params(params), q, n_slots, reinterpret_cast<const float4*>(sph),
      reinterpret_cast<const float4*>(tri), table, atlas, scratch, r, out,
      static_cast<cudaStream_t>(stream)));
}

// K5: per kind the super and cluster AABBs f32[., 8] (16-byte aligned), the
// slot table f32[rows, n_clusters * 128] of scene.ClusterData, each
// cluster's live count i32[n_clusters] (cluster_ops.live_counts), each slot's
// primitive id i32[n_clusters * 128] (ClusterData.sph_prim / tri_prim) and the
// two widening factors of its boxes (cluster_ops.cluster_args); triangle slot
// ids start at n_sph_slots.  `table` is the slot-ordered shade table, one row
// per slot.  `next_pixel` is one int, 0 at launch.
extern "C" int rt_megakernel_clustered(
    const float* params, int n_pixels, int pixel_base, int spp, int sample_offset,
    unsigned int seed, int width, int n_global, int max_depth, int atlas_h, int atlas_w,
    int flags, const float* sph_super, int n_sph_super, const float* sph_cluster,
    int n_sph_cluster, const float* sph_slots, const int* sph_live, const int* sph_prim,
    float sph_reach_lin, float sph_reach_sq, const float* tri_super, int n_tri_super,
    const float* tri_cluster, int n_tri_cluster, const float* tri_slots, const int* tri_live,
    const int* tri_prim, float tri_reach_lin, float tri_reach_sq, int n_sph_slots,
    const float* table, const float* atlas, float* out, int* next_pixel, void* stream) {
  const rt::Ints q{n_pixels, pixel_base, spp, sample_offset, seed, width, n_global, max_depth,
                   0, 0, atlas_h, atlas_w, flags};
  const rt::ClusterSet sph{sph_super, sph_cluster, sph_slots, sph_live, sph_prim, n_sph_super,
                           n_sph_cluster, (long long)n_sph_cluster * rt::kClusterSlots, 0,
                           sph_reach_lin, sph_reach_sq};
  const rt::ClusterSet tri{tri_super, tri_cluster, tri_slots, tri_live, tri_prim, n_tri_super,
                           n_tri_cluster, (long long)n_tri_cluster * rt::kClusterSlots,
                           n_sph_slots, tri_reach_lin, tri_reach_sq};
  const rt::Params p = rt::load_params(params);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(rt::launch_clustered(p, q, sph, tri, table, atlas, out, next_pixel, s));
}
