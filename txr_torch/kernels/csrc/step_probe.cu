// The fused bounce-step probe, CUDA C++ for sm_90a.
//
// Replaces txr/kernels/pallas_step.py:step_probe_pallas (kernel body
// _build_step_kernel, pallas_step.py:110-574).  One thread per ray computes,
// in one pass: the nearest-hit sweep over every slot in reference order with
// strict '<'; the winner's normal, flipped to face the ray, and the outside
// flag; Fresnel rm with total internal reflection; the texture request
// (kind, atlas slot, uv or the rotated sphere normal, footprint LOD, box
// face weight); the 12-float material row; and for each light (point, then
// direct) the diffuse weight, the specular term, the solid any-hit bit and
// each ring's (hit, u, v).  Outputs are structure-of-arrays, f [NF, N] and
// i [3, N] (slot, kind, req_k), in the row order of pallas_step.py:558-571,
// so the stores of a warp are coalesced and the rows compare one to one
// with the JAX kernel and the PyTorch twin (step_probe.py:step_probe_ref).
//
// What bounds it: arithmetic.  Per ray it reads 24 B of rays and writes
// 4*NF + 12 B of probe (152 B for the demo scene), but one sweep plus one
// shadow sweep per light is some four thousand FP32 operations, most of
// them the torus's Ferrari solve (a 20-step resolvent Newton loop) and the
// quadrics.  The scene (a few hundred floats) is copied into shared memory
// once per block, so every primitive parameter is a shared-memory broadcast
// read.  Counts are runtime loop bounds and the lanes of a warp diverge on
// the texture and Fresnel branches.  This first version is simple and
// correct, not yet fast: no specialisation on the scene's topology, no
// compaction of dead lanes.
//
// The environment request of the Pallas body (cube_base >= 0) is left out:
// the main path fetches the environment once after the bounce loop, so
// cube_base is always -1 there (pallas_step.py:681).  The sphere UV is
// finished outside the kernel, as in the JAX package: textured-sphere lanes
// emit the rotated normal.  Built without --use_fast_math and with
// -fmad=false, so it rounds as its twin does (txr_common.cuh).

#include <cuda_runtime.h>

#include "txr_common.cuh"

namespace {

using namespace txr;  // f3, Meta, the record widths and flags of the packed table

constexpr int kThreads = 128;
constexpr float LOD_COS_MIN = 0.125f;
constexpr float MAX_DIST = 1.0e6f;
constexpr int KIND_RGBA = 1, KIND_BOX = 2;

__device__ __forceinline__ float pow5(float x) {
  float x2 = x * x;
  return x2 * x2 * x;
}

__global__ void __launch_bounds__(kThreads)
    step_probe_kernel(Meta m, const float* __restrict__ buf, const float* __restrict__ ro,
                      const float* __restrict__ rd, float* __restrict__ fout,
                      int* __restrict__ iout, long long n) {
  extern __shared__ float sm[];
  txr::stage_table(m, buf, sm);
  const long long ray = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n) return;

  const float* PL = sm + m.o_pl;
  const float* SP = sm + m.o_sp;
  const float* SU = sm + m.o_su;
  const float* BX = sm + m.o_bx;
  const float* TO = sm + m.o_to;
  const float* RI = sm + m.o_ri;
  const float* LP = sm + m.o_lp;
  const float* LD = sm + m.o_ld;
  const float* MAT = sm + m.o_mat;
  const float* TEXSLOT = sm + m.o_texslot;
  const float* TEXDIM = sm + m.o_texdim;

  const f3 o = {ro[3 * ray], ro[3 * ray + 1], ro[3 * ray + 2]};
  const f3 d = {rd[3 * ray], rd[3 * ray + 1], rd[3 * ray + 2]};

  // ---- nearest-hit sweep (calcInter), reference slot order --------------
  float tmin;
  int slot;
  txr::nearest_sweep(m, sm, o, d, tmin, slot);

  const bool hit = tmin < txr::INF_T;
  const float ts = hit ? tmin : 0.0f;
  const f3 p = {o.x + d.x * ts, o.y + d.y * ts, o.z + d.z * ts};

  // ---- winner info (get_hit_info) ----------------------------------------
  // A miss keeps slot 0, like the Pallas body: its rows describe slot 0 at
  // t = 0 and are never consumed.
  const int b_sp = m.n_pl, b_su = b_sp + m.n_sp, b_bx = b_su + m.n_su, b_to = b_bx + m.n_bx;
  const int b_ri = b_to + m.n_to, b_lp = b_ri + m.n_ri, n_slots = b_lp + m.n_lp;
  f3 nrm = {0.0f, 0.0f, 0.0f};
  if (slot < b_sp) {
    const float* v = PL + RPL * slot + 3;
    float inv = 1.0f / sqrtf(v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + 1e-30f);
    nrm = {v[0] * inv, v[1] * inv, v[2] * inv};
  } else if (slot < b_su) {
    nrm = txr::norm3(txr::sub(p, SP + RSP * (slot - b_sp)));
  } else if (slot < b_bx) {
    const float* S = SU + RSU * (slot - b_su);
    f3 l = txr::rotq(S + 3, txr::sub(p, S));
    f3 g = {2.0f * S[7] * l.x, 2.0f * S[8] * l.y + S[11], 2.0f * S[9] * l.z + S[10]};
    nrm = txr::norm3(txr::rotq_conj(S + 3, g));
  } else if (slot < b_to) {
    const float* B = BX + RBX * (slot - b_bx);
    f3 lo = txr::rotq(B + 3, txr::sub(o, B));
    f3 ld = txr::rotq(B + 3, d);
    float mx = txr::safe_recip(ld.x), my = txr::safe_recip(ld.y), mz = txr::safe_recip(ld.z);
    float t1x = -mx * lo.x - fabsf(mx) * B[7];
    float t1y = -my * lo.y - fabsf(my) * B[8];
    float t1z = -mz * lo.z - fabsf(mz) * B[9];
    f3 g = {-(ld.x >= 0.0f ? 1.0f : -1.0f) * ((t1x >= t1y && t1x >= t1z) ? 1.0f : 0.0f),
            -(ld.y >= 0.0f ? 1.0f : -1.0f) * ((t1y >= t1z && t1y >= t1x) ? 1.0f : 0.0f),
            -(ld.z >= 0.0f ? 1.0f : -1.0f) * ((t1z >= t1x && t1z >= t1y) ? 1.0f : 0.0f)};
    nrm = txr::rotq_conj(B + 3, g);
  } else if (slot < b_ri) {
    const float* T = TO + RTO * (slot - b_to);
    f3 l = txr::rotq(T + 3, txr::sub(p, T));
    float kk = l.x * l.x + l.y * l.y + l.z * l.z - T[8] * T[8];
    float R2 = T[7] * T[7];
    nrm = txr::norm3(txr::rotq_conj(T + 3, {l.x * (kk - R2), l.y * (kk - R2), l.z * (kk + R2)}));
  } else if (slot < b_lp) {
    nrm = txr::rotq_conj(RI + RRI * (slot - b_ri) + 3, {0.0f, 0.0f, -1.0f});
  }

  // ---- texture request ----------------------------------------------------
  const int atk = slot < n_slots ? (int)TEXSLOT[slot] : -1;
  const bool textured = hit && atk >= 0;
  float req_a = 0.0f, req_b = 0.0f, req_c = 0.0f, tex_w = 1.0f, lodv = 0.0f;
  int kind = 0, req_k = 0;
  const float pix = m.pix_angle;
  float fw = 0.0f, tH = 0.0f, tW = 0.0f;
  if (pix != 0.0f) {
    float cos_in = fabsf(d.x * nrm.x + d.y * nrm.y + d.z * nrm.z);
    fw = ts * pix / fmaxf(cos_in, LOD_COS_MIN);
    int kk = textured ? atk : 0;
    if (kk >= 0 && kk < m.n_atlas) tH = TEXDIM[2 * kk], tW = TEXDIM[2 * kk + 1];
  }
  if (textured) {
    if (slot >= b_sp && slot < b_su) {
      const float* S = SP + RSP * (slot - b_sp);
      f3 rn = txr::rotq(S + 5, nrm);
      req_a = rn.x, req_b = rn.y, req_c = rn.z;
      kind = KIND_RGBA, req_k = atk;
      if (pix != 0.0f) {
        float tpw = fmaxf(tW / txr::TWO_PI_F, tH / txr::PI_F) / fmaxf(S[3], 1e-6f);
        lodv = log2f(fmaxf(fw * tpw, 1.0f));
      }
    } else if (slot >= b_bx && slot < b_to) {
      // the reference rotates box.pos by the quat, not pos-relative
      const float* B = BX + RBX * (slot - b_bx);
      f3 cp = txr::rotq(B + 3, {B[0], B[1], B[2]});
      f3 lp = txr::rotq(B + 3, p);
      f3 ln = txr::rotq(B + 3, nrm);
      float rx = lp.x - cp.x, ry = lp.y - cp.y, rz = lp.z - cp.z;
      float ax = fabsf(ln.x), ay = fabsf(ln.y), az = fabsf(ln.z);
      bool dom_x = ax >= ay && ax >= az;
      bool dom_y = !dom_x && ay >= az;
      float u = dom_x ? rz : (dom_y ? rz : rx);
      float v = dom_x ? ry : (dom_y ? rx : ry);
      req_a = 0.5f * u - 0.5f, req_b = 0.5f * v - 0.5f;
      tex_w = dom_x ? ax : (dom_y ? ay : az);
      kind = KIND_BOX, req_k = atk;
      if (pix != 0.0f) lodv = log2f(fmaxf(fw * 0.5f * fmaxf(tH, tW), 1.0f));
    } else if (slot >= b_ri && slot < b_lp) {
      const float* Rg = RI + RRI * (slot - b_ri);
      const float r1 = Rg[7], r2 = Rg[8];
      f3 lo = txr::rotq(Rg + 3, txr::sub(o, Rg));
      f3 ld = txr::rotq(Rg + 3, d);
      float hx = lo.x + ld.x * ts, hy = lo.y + ld.y * ts;
      float pp = hx * hx + hy * hy;
      req_a = (pp - r1) / (r2 - r1);
      req_b = hx / sqrtf(fmaxf(pp, 1e-20f));
      kind = KIND_RGBA, req_k = atk;
      if (pix != 0.0f) {
        float rmid = sqrtf(fmaxf(0.5f * (r1 + r2), 1e-12f));
        float tpw = fmaxf(tW * 2.0f * rmid / fmaxf(r2 - r1, 1e-12f), tH / (txr::PI_F * rmid));
        lodv = log2f(fmaxf(fw * tpw, 1.0f));
      }
    }
  }

  // ---- material row ---------------------------------------------------------
  float mat[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) mat[j] = slot < n_slots ? MAT[12 * slot + j] : 0.0f;
  const float m_refl = mat[7], m_refr = mat[8], m_spec = mat[9];

  // ---- facing flip + Fresnel (rt.frag:837-849) ------------------------------
  const bool outside = (d.x * nrm.x + d.y * nrm.y + d.z * nrm.z) < 0.0f;
  const float flip = outside ? 1.0f : -1.0f;
  const f3 nf = {nrm.x * flip, nrm.y * flip, nrm.z * flip};
  const float ndotv = txr::clampf(-(d.x * nf.x + d.y * nf.y + d.z * nf.z), 0.0f, 1.0f);
  const float schlick = m_refl + (1.0f - m_refl) * pow5(1.0f - ndotv);
  float rm = schlick;
  if ((m.flags & FLAG_TIR) && m_refr > 0.0f) {
    if (m.flags & FLAG_FRESNEL) {
      float n1 = outside ? 1.0f : m_refr;
      float n2 = outside ? m_refr : 1.0f;
      float n2s = fabsf(n2) > 1e-6f ? n2 : 1.0f;
      float w = (n1 - n2) / (n1 + n2s);
      float r0 = w * w;
      float cosx = -(d.x * nf.x + d.y * nf.y + d.z * nf.z);
      bool entering = n1 > n2;
      float ratio = n1 / n2s;
      float sin_t2 = ratio * ratio * (1.0f - cosx * cosx);
      bool tirm = entering && sin_t2 > 1.0f;
      bool no_tir = sin_t2 < 1.0f;
      float cost = sqrtf(no_tir ? 1.0f - sin_t2 : 1.0f);
      cosx = entering ? (no_tir ? cost : 0.0f) : cosx;
      float xf = 1.0f - cosx;
      float x2 = xf * xf;
      float ret = r0 + (1.0f - r0) * x2 * x2 * xf;
      ret = m_refl + (1.0f - m_refl) * ret;
      rm = tirm ? 1.0f : ret;
    } else {
      rm = m_refl;
    }
  }

  // ---- base rows ------------------------------------------------------------
  float* F = fout + ray;
  const long long N = n;
  float base[11] = {tmin, nf.x, nf.y, nf.z, outside ? 1.0f : 0.0f, rm,
                    req_a, req_b, req_c, lodv, tex_w};
#pragma unroll
  for (int j = 0; j < 11; ++j) F[j * N] = base[j];
#pragma unroll
  for (int j = 0; j < 12; ++j) F[(11 + j) * N] = mat[j];
  iout[ray] = slot;
  iout[N + ray] = kind;
  iout[2 * N + ray] = req_k;

  // ---- shading probes per light (calcShade2 + inShadow) ---------------------
  const float bias = (9e-3f * ts + 35.0f) / 35e3f;
  const f3 so = {p.x + nf.x * bias, p.y + nf.y * bias, p.z + nf.z * bias};
  // the glossy probe shades with the unflipped normal (rt.frag:787-802)
  const f3 sn = (m.flags & FLAG_SHADE_FLIPPED) ? nf : nrm;
  const bool shadows = m.flags & FLAG_SHADOW;
  int row = 23;

  auto shade_probe = [&](f3 ldir, float dist, float wgt) {
    float dp = txr::clampf(sn.x * ldir.x + sn.y * ldir.y + sn.z * ldir.z, 0.0f, 1.0f);
    float lddn = ldir.x * sn.x + ldir.y * sn.y + ldir.z * sn.z;
    float rfx = ldir.x - 2.0f * lddn * sn.x;
    float rfy = ldir.y - 2.0f * lddn * sn.y;
    float rfz = ldir.z - 2.0f * lddn * sn.z;
    float sdp = txr::clampf(d.x * rfx + d.y * rfy + d.z * rfz, 0.0f, 1.0f);
    float spec = m_spec > 0.0f ? powf(fmaxf(sdp, 1e-12f), m_spec) : 0.0f;
    F[row++ * N] = dp * wgt;
    F[row++ * N] = spec;
    F[row++ * N] = shadows && txr::occluded(m, sm, so, ldir, dist) ? 1.0f : 0.0f;
    for (int k = 0; k < m.n_ri; ++k) {
      float u = 0.0f, v = 0.0f;
      bool h = shadows && txr::ring_shadow(RI + RRI * k, so, ldir, dist, u, v);
      F[row++ * N] = h ? 1.0f : 0.0f;
      F[row++ * N] = u;
      F[row++ * N] = v;
    }
  };

#pragma unroll 1
  for (int l = 0; l < m.n_lp; ++l) {
    const float* L = LP + RLP * l;
    float lx = L[0] - so.x, ly = L[1] - so.y, lz = L[2] - so.z;
    float dist = sqrtf(lx * lx + ly * ly + lz * lz + 1e-30f);
    float inv = 1.0f / dist;
    float dist_div = 1.0f + L[5] * dist + L[6] * dist * dist;
    shade_probe({lx * inv, ly * inv, lz * inv}, dist, L[4] / dist_div);
  }
#pragma unroll 1
  for (int l = 0; l < m.n_ld; ++l) {
    const float* L = LD + RLD * l;
    float inv = 1.0f / sqrtf(L[0] * L[0] + L[1] * L[1] + L[2] * L[2] + 1e-30f);
    shade_probe({-L[0] * inv, -L[1] * inv, -L[2] * inv}, MAX_DIST, L[3]);
  }
}

}  // namespace

// hdr: the table header (txr::Meta's integer fields in order), read on the
// host.  Returns cudaGetLastError() after the launch; the caller raises on
// non-zero.
extern "C" int txr_step_probe(const int* hdr, const float* buf, float pix_angle, const float* ro,
                              const float* rd, float* fout, int* iout, long long n,
                              void* stream) {
  const Meta m = txr::make_meta(hdr, pix_angle);
  if (n <= 0) return 0;
  const size_t smem = (size_t)m.n_buf * sizeof(float);
  if (int e = txr::allow_smem(step_probe_kernel, smem)) return e;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  step_probe_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(m, buf, ro, rd, fout, iout,
                                                                     n);
  return (int)cudaGetLastError();
}
