// The packed scene table and the per-primitive ray tests shared by the
// txr_torch CUDA kernels (step_probe.cu, nearest_hit.cu, shadow_sweep.cu).
//
// Device-function transcriptions of txr/kernels/pallas_intersect.py:41-210
// (the same arithmetic in the same order as the PyTorch twins in
// txr_torch/kernels/primitives.py and scene_table.py), for one ray per
// thread.  Primitive records are read from the packed scene table (see
// scene_table.py REC):
//   plane   pos3 normal3
//   sphere  pos3 radius hollow quat4
//   surface pos3 quat4 coef6 v_min3 v_max3   (clip box clamped to +-INF_T)
//   box     pos3 quat4 form3
//   torus   pos3 quat4 form2
//   ring    pos3 quat4 r1 r2                 (radii squared)
// Compiled without fast-math and without FMA contraction (-fmad=false): the
// Ferrari solve and the IEEE sqrt and division decide silhouettes and torus
// roots, and with contraction the f32 quartic's roots move in their last
// bits and flip a few lanes, so the kernel rounds operation for operation
// as its twin does.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace txr {

constexpr float BIG = 1.0e30f;
constexpr float INF_T = 3.0e38f;  // stand-in for +inf inside the kernels
constexpr float PI_F = 3.14159265358979f;
constexpr float TWO_PI_F = 6.28318530717958f;

struct f3 {
  float x, y, z;
};

__device__ __forceinline__ f3 sub(f3 a, const float* b) {
  return {a.x - b[0], a.y - b[1], a.z - b[2]};
}

// Reference rotate(): (w^2 - |qv|^2) v + 2 (qv.v) qv + 2 w (qv x v).
__device__ __forceinline__ f3 rot(float qx, float qy, float qz, float qw, f3 v) {
  float dot = qx * v.x + qy * v.y + qz * v.z;
  float cx = qy * v.z - qz * v.y;
  float cy = qz * v.x - qx * v.z;
  float cz = qx * v.y - qy * v.x;
  float k = qw * qw - (qx * qx + qy * qy + qz * qz);
  return {k * v.x + 2.0f * dot * qx + 2.0f * qw * cx,
          k * v.y + 2.0f * dot * qy + 2.0f * qw * cy,
          k * v.z + 2.0f * dot * qz + 2.0f * qw * cz};
}

__device__ __forceinline__ f3 rotq(const float* q, f3 v) { return rot(q[0], q[1], q[2], q[3], v); }

__device__ __forceinline__ f3 rotq_conj(const float* q, f3 v) {
  return rot(-q[0], -q[1], -q[2], q[3], v);
}

__device__ __forceinline__ float safe_recip(float v) {
  return (v >= 0.0f ? 1.0f : -1.0f) / fmaxf(fabsf(v), 1.0e-30f);
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__device__ __forceinline__ f3 norm3(f3 v) {
  float inv = 1.0f / sqrtf(v.x * v.x + v.y * v.y + v.z * v.z + 1e-30f);
  return {v.x * inv, v.y * inv, v.z * inv};
}

// rt.frag:356-370
__device__ __forceinline__ bool plane_test(const float* P, f3 o, f3 d, bool one_side, float& t) {
  const float nx = P[3], ny = P[4], nz = P[5];
  float denom = clampf(nx * d.x + ny * d.y + nz * d.z, -1.0f, 1.0f);
  bool facing = one_side ? (denom < -1e-6f) : (fabsf(denom) > 1e-6f);
  float num = (P[0] - o.x) * nx + (P[1] - o.y) * ny + (P[2] - o.z) * nz;
  t = num / (facing ? denom : 1.0f);
  return facing && t > 0.0f;
}

// rt.frag:342-354; hollow spheres take the far root from inside.  Shadow
// rays and light bulbs pass hollow = false.
__device__ __forceinline__ bool sphere_test(const float* c, float rad, bool hollow, f3 o, f3 d,
                                            float& t) {
  float ocx = o.x - c[0], ocy = o.y - c[1], ocz = o.z - c[2];
  float b = ocx * d.x + ocy * d.y + ocz * d.z;
  float cc = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  float h = b * b - cc;
  bool has = h >= 0.0f;
  float hs = sqrtf(has ? h : 0.0f);
  t = -b - hs;
  if (hollow && t < 0.0f) t = -b + hs;
  return has && t > 0.0f;
}

// rt.frag:499-585 incl. the world-space clip box
__device__ __forceinline__ bool surface_test(const float* S, f3 o, f3 d, float& t) {
  const float* q = S + 3;
  const float* k = S + 7;
  const float* vmin = S + 13;
  const float* vmax = S + 16;
  f3 lo = rotq(q, sub(o, S));
  f3 ld = rotq(q, d);
  const float a = k[0], b = k[1], c = k[2], dd = k[3], e = k[4], f = k[5];
  float p1 = 2.0f * a * ld.x * lo.x + 2.0f * b * ld.y * lo.y + 2.0f * c * ld.z * lo.z +
             dd * ld.z + ld.y * e;
  float p2 = a * ld.x * ld.x + b * ld.y * ld.y + c * ld.z * ld.z;
  float p3 = a * lo.x * lo.x + b * lo.y * lo.y + c * lo.z * lo.z + dd * lo.z + e * lo.y + f;
  float disc = p1 * p1 - 4.0f * p2 * p3;
  bool ok = disc >= 0.0f && fabsf(p2) >= 1e-6f;
  float p4 = sqrtf(ok ? disc : 0.0f);
  float inv2p2 = (ok ? 1.0f : 0.0f) / (ok ? 2.0f * p2 : 1.0f);
  float t1 = (-p1 - p4) * inv2p2;
  float t2 = (-p1 + p4) * inv2p2;
  const float eps = 1e-4f;
  bool t1ok = t1 > eps, t2ok = t2 > eps;
  float lo_t = fminf(t1, t2), hi_t = fmaxf(t1, t2);
  bool both = t1ok && t2ok;
  float near_t = both ? lo_t : (t1ok ? t1 : (t2ok ? t2 : INF_T));
  float far_t = both ? hi_t : (t1ok ? t2 : (t2ok ? t1 : INF_T));
  auto between = [&](float tt) {
    float wx = o.x + d.x * tt, wy = o.y + d.y * tt, wz = o.z + d.z * tt;
    return wx > vmin[0] && wx < vmax[0] && wy > vmin[1] && wy < vmax[1] && wz > vmin[2] &&
           wz < vmax[2];
  };
  bool near_fin = near_t < INF_T;
  bool near_in = near_fin && between(near_fin ? near_t : 0.0f);
  bool far_ok = far_t >= eps && far_t < INF_T;
  bool far_in = far_ok && between(far_ok ? far_t : 0.0f);
  t = near_in ? near_t : (far_in ? far_t : INF_T);
  return ok && t < INF_T;
}

// rt.frag:399-427 (iq slab test; tN may be negative inside)
__device__ __forceinline__ bool box_test(const float* B, f3 o, f3 d, float& t) {
  const float* q = B + 3;
  f3 lo = rotq(q, sub(o, B));
  f3 ld = rotq(q, d);
  float mx = safe_recip(ld.x), my = safe_recip(ld.y), mz = safe_recip(ld.z);
  float nx = mx * lo.x, ny = my * lo.y, nz = mz * lo.z;
  float kx = fabsf(mx) * B[7], ky = fabsf(my) * B[8], kz = fabsf(mz) * B[9];
  float tN = fmaxf(fmaxf(-nx - kx, -ny - ky), -nz - kz);
  float tF = fminf(fminf(-nx + kx, -ny + ky), -nz + kz);
  t = tN;
  return tN <= tF && tF >= 0.0f;
}

struct Quartic {
  float c4, c3, c2, c1, c0;
};

// Newton steps on the quartic, skipped where |f'| <= 1e-6 (torus.py:292-302)
__device__ __forceinline__ float newton_refine(float ts, const Quartic& k, int steps) {
  for (int s = 0; s < steps; ++s) {
    float f = (((k.c4 * ts + k.c3) * ts + k.c2) * ts + k.c1) * ts + k.c0;
    float fp = ((4.0f * k.c4 * ts + 3.0f * k.c3) * ts + 2.0f * k.c2) * ts + k.c1;
    bool ok = fabsf(fp) > 1e-6f;
    ts = ts - (ok ? f / fp : 0.0f);
  }
  return ts;
}

// Newton steps on the same quartic in its factored form
// f(t) = (|p|^2 + R^2 - r^2)^2 - 4 R^2 (px^2 + py^2), p = o + t d, which
// stays accurate in f32 near the tube where the expanded coefficients lose
// the root to cancellation (txr_torch/geometry/torus.py)
__device__ __forceinline__ float newton_refine_factored(float ts, f3 o, f3 d, float R2, float r2,
                                                        int steps) {
  for (int s = 0; s < steps; ++s) {
    float px = o.x + d.x * ts, py = o.y + d.y * ts, pz = o.z + d.z * ts;
    float sq = px * px + py * py + pz * pz + R2 - r2;
    float rho = px * d.x + py * d.y;
    float f = sq * sq - 4.0f * R2 * (px * px + py * py);
    float fp = 4.0f * sq * (rho + pz * d.z) - 8.0f * R2 * rho;
    bool ok = fabsf(fp) > 1e-6f;
    ts = ts - (ok ? f / fp : 0.0f);
  }
  return ts;
}

// Largest real root of the Ferrari resolvent by Newton from the Lagrange
// upper bound (torus.py:185-211)
__device__ __forceinline__ float resolvent_root(float p, float qq, float r) {
  const float A2 = p;
  const float A1 = 0.25f * (p * p - 4.0f * r);
  const float A0 = -0.125f * qq * qq;
  const float cbrt_a0 = powf(fmaxf(fabsf(A0), 1e-30f), 1.0f / 3.0f);
  float m = 2.0f * fmaxf(fabsf(A2), fmaxf(sqrtf(fabsf(A1)), cbrt_a0)) + 1e-6f;
  for (int it = 0; it < 20; ++it) {
    float f = ((m + A2) * m + A1) * m + A0;
    float fp = (3.0f * m + 2.0f * A2) * m + A1;
    bool ok = fabsf(fp) > 1e-20f;
    m = m - (ok ? f / fp : 0.0f);
  }
  return fmaxf(m, 0.0f);
}

__device__ __forceinline__ float split_err(float B1, float C1, float B2, float C2, float p,
                                           float qq, float r) {
  return fabsf(C1 + C2 + B1 * B2 - p) + fabsf(B1 * C2 + B2 * C1 - qq) +
         fabsf(C1 * C2 - r) / (1.0f + fabsf(p));
}

__device__ __forceinline__ void quad_roots(float B, float C, float* re, float* im2) {
  float D = B * B - 4.0f * C;
  float sqD = sqrtf(fmaxf(D, 0.0f));
  bool cplx = D < 0.0f;
  float rec = -0.5f * B;
  float is = fmaxf(-D, 0.0f) * 0.25f;
  re[0] = cplx ? rec : 0.5f * (-B - sqD);
  re[1] = cplx ? rec : 0.5f * (-B + sqD);
  im2[0] = im2[1] = cplx ? is : 0.0f;
}

// Ferrari: the four roots as (re, im^2) (torus.py:214-280)
__device__ __forceinline__ void ferrari_roots(const Quartic& k, float* re, float* im2) {
  float inv4 = 1.0f / (fabsf(k.c4) > 1e-20f ? k.c4 : 1e-20f);
  float a = k.c3 * inv4, b = k.c2 * inv4, c = k.c1 * inv4, d = k.c0 * inv4;
  float a2 = a * a;
  float p = b - 0.375f * a2;
  float qq = c - 0.5f * a * b + 0.125f * a2 * a;
  float r = d - 0.25f * a * c + 0.0625f * a2 * b - (3.0f / 256.0f) * a2 * a2;
  float m = resolvent_root(p, qq, r);
  float s = sqrtf(fmaxf(2.0f * m, 0.0f));
  float qs = qq / fmaxf(2.0f * s, 1e-12f);
  float gB1 = -s, gC1 = 0.5f * p + m + qs;
  float gB2 = s, gC2 = 0.5f * p + m - qs;
  float db = sqrtf(fmaxf(0.25f * p * p - r, 0.0f));
  float bC1 = 0.5f * p + db, bC2 = 0.5f * p - db;
  bool biq = split_err(0.0f, bC1, 0.0f, bC2, p, qq, r) < split_err(gB1, gC1, gB2, gC2, p, qq, r);
  quad_roots(biq ? 0.0f : gB1, biq ? bC1 : gC1, re, im2);
  quad_roots(biq ? 0.0f : gB2, biq ? bC2 : gC2, re + 2, im2 + 2);
  float off = 0.25f * a;
  for (int j = 0; j < 4; ++j) re[j] -= off;
}

// The torus's bounding-sphere cull (primitives.py:_torus_culled): true when
// the line lo + t ld misses the sphere of radius^2
// ((R + r) TORUS_CULL_RHO)^2 + TORUS_CULL_K |lo|^4 / (R r), where the Ferrari
// solve finds no root either.  The second term covers the float32 solve's
// false hits on near-tangent rays from afar (their margin grows as |lo|^4);
// a line and not a ray, since the solve also accepts roots of some rays
// leaving the sphere.  Rays of a warp are neighbouring pixels, so the branch
// is nearly warp-uniform; some 3-6 % of the demo's rays pass it.
constexpr float TORUS_CULL_RHO = 1.001f, TORUS_CULL_K = 2.0e-6f;

__device__ __forceinline__ bool torus_culled(f3 lo, f3 ld, float R, float r) {
  float c0 = lo.x * lo.x + lo.y * lo.y + lo.z * lo.z;
  float hb = lo.x * ld.x + lo.y * ld.y + lo.z * ld.z;
  float A = ld.x * ld.x + ld.y * ld.y + ld.z * ld.z;
  float rb = (R + r) * TORUS_CULL_RHO;
  float rho2 = rb * rb + TORUS_CULL_K * (c0 * c0) / fmaxf(fabsf(R * r), 1e-12f);
  return hb * hb < A * (c0 - rho2);
}

// Ferrari closed form with the reference's acceptance (rt.frag:478-486);
// the accepted root is polished on the factored quartic.  Culled lines
// return before the solve.
__device__ __forceinline__ bool torus_test(const float* T, f3 o, f3 d, float& t) {
  const float* q = T + 3;
  f3 lo = rotq(q, sub(o, T));
  f3 ld = rotq(q, d);
  const float R = T[7], r = T[8];
  t = 0.0f;
  if (torus_culled(lo, ld, R, r)) return false;
  float A = ld.x * ld.x + ld.y * ld.y + ld.z * ld.z;
  float Bq = 2.0f * (lo.x * ld.x + lo.y * ld.y + lo.z * ld.z);
  float R2 = R * R;
  float Cq = lo.x * lo.x + lo.y * lo.y + lo.z * lo.z + R2 - r * r;
  float a2 = ld.x * ld.x + ld.y * ld.y;
  float b2 = 2.0f * (lo.x * ld.x + lo.y * ld.y);
  float c2 = lo.x * lo.x + lo.y * lo.y;
  Quartic k{A * A, 2.0f * A * Bq, Bq * Bq + 2.0f * A * Cq - 4.0f * R2 * a2,
            2.0f * Bq * Cq - 4.0f * R2 * b2, Cq * Cq - 4.0f * R2 * c2};
  float re[4], im2[4];
  ferrari_roots(k, re, im2);
  float best = 1e4f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float rr = im2[j] > 0.0f ? re[j] : newton_refine(re[j], k, 2);
    bool good = im2[j] <= 1e-6f && rr >= 0.0f;
    best = fminf(best, good ? rr : 1e4f);
  }
  bool hit = best > 0.0f && best < 100.0f;
  t = newton_refine_factored(hit ? best : 0.0f, lo, ld, R2, r * r, 2);
  return hit;
}

// rt.frag:372-390; also the in-plane hit x and radius^2 p for the ring UV
__device__ __forceinline__ bool ring_test(const float* Rg, f3 o, f3 d, float& t, float& x,
                                          float& p) {
  const float* q = Rg + 3;
  f3 lo = rotq(q, sub(o, Rg));
  f3 ld = rotq(q, d);
  bool nzero = ld.z != 0.0f;
  t = -lo.z / (nzero ? ld.z : 1.0f);
  x = lo.x + ld.x * t;
  float y = lo.y + ld.y * t;
  p = x * x + y * y;
  return t > 0.0f && p < Rg[8] && p > Rg[7] && nzero;
}

// Header of the packed scene table (scene_table.py pack_scene): counts
// (planes, spheres, surfaces, boxes, toruses, rings, point lights, direct
// lights), n_atlas, flags, section offsets (the same eight, then materials,
// texture slots, texture dims), buffer length.
constexpr int HDR_LEN = 22;
constexpr int FLAG_ONE_SIDE = 1, FLAG_SHADOW = 2, FLAG_FRESNEL = 4, FLAG_TIR = 8,
              FLAG_SHADE_FLIPPED = 16;
// record widths of the packed scene table (scene_table.py REC)
constexpr int RPL = 6, RSP = 9, RSU = 19, RBX = 10, RTO = 9, RRI = 9, RLP = 7, RLD = 4;

struct Meta {
  int n_pl, n_sp, n_su, n_bx, n_to, n_ri, n_lp, n_ld;
  int n_atlas, flags;
  int o_pl, o_sp, o_su, o_bx, o_to, o_ri, o_lp, o_ld, o_mat, o_texslot, o_texdim;
  int n_buf;
  float pix_angle;
};

inline Meta make_meta(const int* h, float pix_angle) {
  return Meta{h[0],  h[1],  h[2],  h[3],  h[4],  h[5],  h[6],  h[7],  h[8],  h[9],  h[10], h[11],
              h[12], h[13], h[14], h[15], h[16], h[17], h[18], h[19], h[20], h[21], pix_angle};
}

// Every block copies the table into shared memory once; each primitive read
// is then a broadcast.  The table is a few hundred floats for real scenes.
__device__ __forceinline__ void stage_table(const Meta& m, const float* __restrict__ buf,
                                            float* sm) {
  for (int k = threadIdx.x; k < m.n_buf; k += blockDim.x) sm[k] = buf[k];
  __syncthreads();
}

// calcInter (rt.frag:587-628): every slot in reference order (planes,
// spheres, surfaces, boxes, toruses, rings, point-light bulbs) with strict
// '<'.  A miss leaves tmin = INF_T and slot 0.
__device__ __forceinline__ void nearest_sweep(const Meta& m, const float* sm, f3 o, f3 d,
                                              float& tmin, int& slot) {
  const bool one_side = m.flags & FLAG_ONE_SIDE;
  tmin = INF_T;
  slot = 0;
  int s = 0;
  float t;
  for (int k = 0; k < m.n_pl; ++k, ++s)
    if (plane_test(sm + m.o_pl + RPL * k, o, d, one_side, t) && t < tmin) tmin = t, slot = s;
  for (int k = 0; k < m.n_sp; ++k, ++s) {
    const float* S = sm + m.o_sp + RSP * k;
    if (sphere_test(S, S[3], S[4] != 0.0f, o, d, t) && t < tmin) tmin = t, slot = s;
  }
  for (int k = 0; k < m.n_su; ++k, ++s)
    if (surface_test(sm + m.o_su + RSU * k, o, d, t) && t < tmin) tmin = t, slot = s;
  for (int k = 0; k < m.n_bx; ++k, ++s)
    if (box_test(sm + m.o_bx + RBX * k, o, d, t) && t < tmin) tmin = t, slot = s;
  for (int k = 0; k < m.n_to; ++k, ++s)
    if (torus_test(sm + m.o_to + RTO * k, o, d, t) && t < tmin) tmin = t, slot = s;
  for (int k = 0; k < m.n_ri; ++k, ++s) {
    float x, pp;
    if (ring_test(sm + m.o_ri + RRI * k, o, d, t, x, pp) && t < tmin) tmin = t, slot = s;
  }
  for (int k = 0; k < m.n_lp; ++k, ++s) {
    const float* L = sm + m.o_lp + RLP * k;
    if (sphere_test(L, L[3], false, o, d, t) && t < tmin) tmin = t, slot = s;
  }
}

// inShadow's solid part (rt.frag:630-658): any occluder closer than dist.
// Spheres are tested solid, planes occlude only when two-sided; rings are
// left to the caller, which needs each ring's (hit, u, v).  The bit is an
// OR, so the ray stops at its first occluder, testing the cheap types
// first: spheres, two-sided planes, boxes, surfaces, then toruses.
__device__ __forceinline__ bool occluded(const Meta& m, const float* sm, f3 o, f3 d,
                                         float dist) {
  const bool one_side = m.flags & FLAG_ONE_SIDE;
  float t;
  for (int k = 0; k < m.n_sp; ++k) {
    const float* S = sm + m.o_sp + RSP * k;
    if (sphere_test(S, S[3], false, o, d, t) && t < dist) return true;
  }
  if (!one_side)
    for (int k = 0; k < m.n_pl; ++k)
      if (plane_test(sm + m.o_pl + RPL * k, o, d, one_side, t) && t < dist) return true;
  for (int k = 0; k < m.n_bx; ++k)
    if (box_test(sm + m.o_bx + RBX * k, o, d, t) && t < dist) return true;
  for (int k = 0; k < m.n_su; ++k)
    if (surface_test(sm + m.o_su + RSU * k, o, d, t) && t < dist) return true;
  for (int k = 0; k < m.n_to; ++k)
    if (torus_test(sm + m.o_to + RTO * k, o, d, t) && t < dist) return true;
  return false;
}

// Ring k's shadow-ray hit closer than dist, with its (u, v):
// u = (p - r1)/(r2 - r1), v = x/|xy|; zeros where there is no hit.
__device__ __forceinline__ bool ring_shadow(const float* Rg, f3 o, f3 d, float dist, float& u,
                                            float& v) {
  float t, x, pp;
  bool h = ring_test(Rg, o, d, t, x, pp) && t < dist;
  u = h ? (pp - Rg[7]) / (Rg[8] - Rg[7]) : 0.0f;
  v = h ? x / sqrtf(fmaxf(pp, 1e-20f)) : 0.0f;
  return h;
}

// A barrier over the first nthreads threads of the block (a multiple of 32):
// after warps have retired, __syncthreads would wait for them.
__device__ __forceinline__ void sync_first(int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

// In-block stream compaction over the block's first nwarps warps, which
// all call it: each thread with pred set writes its `item` to list[k], k its
// rank among the set threads in thread order, and every caller gets the
// count.  One ballot and popcount per warp, per-warp offsets in shared
// memory (wcount, one int per warp), two barriers over the callers.
__device__ __forceinline__ int compact(bool pred, int item, int nwarps, int* list, int* wcount) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned ballot = __ballot_sync(0xffffffffu, pred);
  if (lane == 0) wcount[warp] = __popc(ballot);
  sync_first(nwarps * 32);
  int off = 0, total = 0;
  for (int w = 0; w < nwarps; ++w) {
    const int c = wcount[w];
    off += w < warp ? c : 0;
    total += c;
  }
  if (pred) list[off + __popc(ballot & ((1u << lane) - 1u))] = item;
  sync_first(nwarps * 32);
  return total;
}

// Raise the dynamic shared-memory limit of a kernel when its table needs it.
template <typename Kernel>
inline int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

}  // namespace txr
