// The fused bounce-step probe, CUDA C++ for sm_90a.
//
// Replaces txr/kernels/pallas_step.py:step_probe_pallas (kernel body
// _build_step_kernel, pallas_step.py:110-574).  For each live ray, in one
// pass: the nearest-hit sweep over every slot in reference order with
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
// Lanes.  `alive` (uint8 [N], or null for every lane) marks the rays whose
// rows the caller reads.  What the kernel stores on the other lanes depends
// on the header's FLAG_FILL bit:
//  - set (the rows are saved for a VJP, trace.step_saving, and the twin's
//    comparisons): an off lane, or one that misses, gets fixed fill rows
//    (t = INF_T, every other row 0, slot/kind/req_k 0); so do the light rows
//    of a hit on a light bulb.  The twin writes the same fills, so kernel and
//    twin agree on every lane;
//  - clear (a forward step's probe and every glossy probe): the kernel stores
//    only what the consume kernels read (step_consume.cu).  An off lane gets
//    nothing, a live miss t = INF_T alone, a bulb hit its 23 base rows and
//    slot/kind/req_k; every other row of those lanes is left as it was.
//    The consume reads rows only on alive lanes, t alone on a miss, t and the
//    slot on a bulb; the glossy rays kernel reads the slot only after a hit.
//
// What bounds it: the work of the live lanes.  A ray reads 24 B and writes
// 4*NF + 12 B (152 B for the demo scene); its sweep and its per-light shadow
// sweeps are some 1.8 thousand FP32 operations each without the torus
// cull.  So the kernel does only the work the live lanes need:
//  - each block compacts its live lanes into a shared-memory list (ballot,
//    popcount, per-warp offsets); warps past the live count retire, the
//    others sweep full warps of live rays, and a block with none skips even
//    the table copy.  With FLAG_FILL, off lanes write their fills themselves,
//    coalesced; without it, such a block returns right after its ballot, and
//    the stores are the live lanes' alone (most of a frame's probe lanes
//    are dead: past its first steps, and nearly all of a glossy probe's);
//  - after the sweep the block compacts again: only hit lanes that are not
//    a light bulb run the per-light shading probes, from the shadow origin,
//    shading normal, direction and specular exponent that the sweeping
//    thread leaves in shared memory.  The live warps take them as (lane,
//    light) pairs, light by light: a warp traces one light's shadow rays
//    from neighbouring lanes, and a lane's lights run in parallel (with
//    tiles, a lane and a group of its lights a thread: below);
//  - the torus's Ferrari solve runs only on lines that cross its inflated
//    bounding sphere, and a shadow ray stops at its first solid occluder
//    (txr_common.cuh).
// The scene table is copied into shared memory once per block, so every
// primitive parameter is a broadcast read: the whole table when it fits the
// room a block has at the kernel's register-limited occupancy (the demo's is
// a few hundred floats).  A table that does not (thousands of primitives) is
// swept in tiles of its slot records, in slot order with the
// same strict '<', so the winner and its ties are the whole sweep's
// (txr_common.cuh plan_stage, Span): step_probe_kernel<true>.  Its tiles are
// staged with each sphere as one 16-byte (centre, r^2) record, and a pair
// takes the root only where the line meets the sphere (sphere_tile_line):
// such a sweep is bound by the instructions a (ray, sphere) pair issues,
// nearly every pair a miss.  So its shadow pass takes a shading lane and a
// group of up to kGroup of its lights a thread (Lights): the lights share
// the shadow origin, so a sphere's offset from it and |oc|^2 - r^2 are
// computed, and its record loaded, once for the group
// (txr_common.cuh occluded_group_span), and with at most kGroup lights the
// pass is one round of kThreads items.  Then every warp of a block stays for
// the stages and barriers; the sweep streams the tiles once, the shadow
// items once a round, and the winner's record, material row and texture slot
// are read from global memory.  Counts are runtime loop bounds: no
// specialisation on the scene's topology yet.
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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBaseRows = 23;  // t, n3, outside, rm, req3, lod, tex_w, mat12
constexpr float LOD_COS_MIN = 0.125f;
constexpr float MAX_DIST = 1.0e6f;
constexpr int KIND_RGBA = 1, KIND_BOX = 2;

__device__ __forceinline__ float pow5(float x) {
  float x2 = x * x;
  return x2 * x2 * x;
}

// Fill rows r0..r1-1 of column `col`: INF_T in row 0 (t), 0 elsewhere.
__device__ __forceinline__ void fill_rows(float* fout, long long col, long long N, int r0,
                                          int r1) {
  for (int j = r0; j < r1; ++j) fout[j * N + col] = j == 0 ? txr::INF_T : 0.0f;
}

__device__ __forceinline__ void fill_ints(int* iout, long long col, long long N) {
  iout[col] = 0;
  iout[N + col] = 0;
  iout[2 * N + col] = 0;
}

// A shading lane's (lane, light) pair: its column of the rows, the shadow
// ray's origin, direction and distance, and its solid row.
struct Pair {
  float* G;
  f3 so, ldir;
  float dist;
  int row;
};

// Pair q of the n_shade lanes' pairs, light by light: the light's
// direction, distance and weight (calcShade2), the diffuse weight and the
// specular term stored; → what its shadow probe needs.  Light records are
// read at tab (shared or global memory).
__device__ __forceinline__ Pair begin_pair(const Meta& m, const float* tab, int q, int n_shade,
                                           const int* s_shade, const int* s_live,
                                           const float (*s_in)[kThreads], float* col,
                                           long long N) {
  const int l = q / n_shade, src = s_shade[q - l * n_shade];
  float* G = col + s_live[src];
  const f3 so = {s_in[0][src], s_in[1][src], s_in[2][src]};
  const f3 sn = {s_in[3][src], s_in[4][src], s_in[5][src]};
  const f3 d = {s_in[6][src], s_in[7][src], s_in[8][src]};
  const float m_spec = s_in[9][src];

  f3 ldir;
  float dist, wgt;
  if (l < m.n_lp) {
    const float* Lp = tab + m.o_lp + RLP * l;
    float lx = Lp[0] - so.x, ly = Lp[1] - so.y, lz = Lp[2] - so.z;
    dist = sqrtf(lx * lx + ly * ly + lz * lz + 1e-30f);
    float inv = 1.0f / dist;
    float dist_div = 1.0f + Lp[5] * dist + Lp[6] * dist * dist;
    ldir = {lx * inv, ly * inv, lz * inv};
    wgt = Lp[4] / dist_div;
  } else {
    const float* Ld = tab + m.o_ld + RLD * (l - m.n_lp);
    float inv = 1.0f / sqrtf(Ld[0] * Ld[0] + Ld[1] * Ld[1] + Ld[2] * Ld[2] + 1e-30f);
    ldir = {-Ld[0] * inv, -Ld[1] * inv, -Ld[2] * inv};
    dist = MAX_DIST;
    wgt = Ld[3];
  }

  float dp = txr::clampf(sn.x * ldir.x + sn.y * ldir.y + sn.z * ldir.z, 0.0f, 1.0f);
  float lddn = ldir.x * sn.x + ldir.y * sn.y + ldir.z * sn.z;
  float rfx = ldir.x - 2.0f * lddn * sn.x;
  float rfy = ldir.y - 2.0f * lddn * sn.y;
  float rfz = ldir.z - 2.0f * lddn * sn.z;
  float sdp = txr::clampf(d.x * rfx + d.y * rfy + d.z * rfz, 0.0f, 1.0f);
  float spec = m_spec > 0.0f ? powf(fmaxf(sdp, 1e-12f), m_spec) : 0.0f;
  const int row = kBaseRows + l * (3 + 3 * m.n_ri);
  G[row * N] = dp * wgt;
  G[(row + 1) * N] = spec;
  return Pair{G, so, ldir, dist, row + 2};
}

// The lights a thread of the tiled kernel's shadow pass takes at once, at
// most: one group a shading lane whenever the scene has at most kGroup lights,
// so the pass is a single round of kThreads items and stages each tile once.
constexpr int kGroup = 4;

// A shading lane's group of n lights l0 .. l0 + n - 1 (n <= kGroup): the
// lane's column and shadow origin, and each light's direction and distance.
// The lights are indexed at run time, so they live in local memory between
// the tiles, and a tile's sweep holds the n it takes in registers: the
// tiled kernel has 64 registers a thread.
struct Lights {
  float* G;
  f3 so;
  f3 ldir[kGroup];
  float dist[kGroup];
  int l0, n;

  // light l0 + j's pair: its shadow ray and solid row
  __device__ __forceinline__ Pair pair(const Meta& m, int j) const {
    return Pair{G, so, ldir[j], dist[j], kBaseRows + (l0 + j) * (3 + 3 * m.n_ri) + 2};
  }
};

// Item q of the n_shade lanes' items, group by group: lane q mod n_shade
// with the lights of group q / n_shade, each begun as its pair (begin_pair
// stores its diffuse and specular rows).
__device__ __forceinline__ Lights begin_lights(const Meta& m, const float* tab, int q,
                                               int n_shade, int n_lights, const int* s_shade,
                                               const int* s_live,
                                               const float (*s_in)[kThreads], float* col,
                                               long long N) {
  const int g = q / n_shade, i = q - g * n_shade;
  Lights s{};
  s.l0 = g * kGroup;
  s.n = min(kGroup, n_lights - s.l0);
#pragma unroll 1
  for (int j = 0; j < s.n; ++j) {
    const Pair p = begin_pair(m, tab, (s.l0 + j) * n_shade + i, n_shade, s_shade, s_live, s_in,
                              col, N);
    s.G = p.G;
    s.so = p.so;
    s.ldir[j] = p.ldir;
    s.dist[j] = p.dist;
  }
  return s;
}

// The pair's (hit, u, v) rows of the rings of span sp (zeros without
// shadows).
__device__ __forceinline__ void ring_rows(const Meta& m, const txr::Span& sp, const float* sm,
                                          const Pair& p, long long N, bool shadows) {
  const float* RI = sm - sp.a + sp.lay.o[5];
  for (int k = sp.lo[5]; k < sp.hi[5]; ++k) {
    float u = 0.0f, v = 0.0f;
    bool h = shadows && txr::ring_shadow(RI + RRI * k, p.so, p.ldir, p.dist, u, v);
    float* G = p.G + (long long)(p.row + 1 + 3 * k) * N;
    G[0] = h ? 1.0f : 0.0f;
    G[N] = u;
    G[2 * N] = v;
  }
}

// kTiled: the table is swept in tiles (txr_common.cuh Tiles, Span);
// otherwise staged whole, and `tl` is unused.
template <bool kTiled>
__device__ __forceinline__ void step_probe(Meta m, const float* __restrict__ buf, txr::Tiles tl,
                                           const float* __restrict__ ro,
                                           const float* __restrict__ rd,
                                           const unsigned char* __restrict__ alive,
                                           float* __restrict__ fout, int* __restrict__ iout,
                                           long long n) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int s_live[kThreads], s_shade[kThreads], s_wc1[kWarps], s_wc2[kWarps];
  // what a shading lane needs, by its place in the live list: the shadow
  // origin, the shading normal, the ray direction and the specular exponent
  __shared__ float s_in[10][kThreads];

  const int tid = threadIdx.x, warp = tid >> 5;
  const long long N = n;
  const long long base = (long long)blockIdx.x * kThreads;
  const int n_lights = m.n_lp + m.n_ld;
  const int NF = kBaseRows + n_lights * (3 + 3 * m.n_ri);
  const bool fill = m.flags & FLAG_FILL;

  // ---- live lanes: compact, fill the others ---------------------------------
  const long long own = base + tid;
  const bool live = own < N && (alive == nullptr || alive[own] != 0);
  const int n_live = txr::compact(live, tid, kWarps, s_live, s_wc1);
  if (fill && own < N && !live) {
    fill_rows(fout, own, N, 0, NF);
    fill_ints(iout, own, N);
  }
  if (n_live == 0) return;  // the whole block
  if (!kTiled) txr::stage_table(m, buf, sm);
  const int n_busy = (n_live + 31) >> 5;
  // warps past the live count retire; with tiles they stay for the stages
  if (!kTiled && warp >= n_busy) return;
  // thread j of the live warps sweeps the j-th live lane
  const bool mine = tid < n_live;
  const int L = mine ? s_live[tid] : 0;
  const long long ray = base + L;

  // the records after the sweep: staged whole, or read from global memory
  const float* tab = kTiled ? buf : sm;
  const float* PL = tab + m.o_pl;
  const float* SP = tab + m.o_sp;
  const float* SU = tab + m.o_su;
  const float* BX = tab + m.o_bx;
  const float* TO = tab + m.o_to;
  const float* RI = tab + m.o_ri;
  const float* MAT = tab + m.o_mat;
  const float* TEXSLOT = tab + m.o_texslot;
  const float* TEXDIM = tab + m.o_texdim;
  float* F = fout + ray;

  // ---- nearest-hit sweep (calcInter), reference slot order ------------------
  f3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 0.0f};
  if (mine) {
    o = {ro[3 * ray], ro[3 * ray + 1], ro[3 * ray + 2]};
    d = {rd[3 * ray], rd[3 * ray + 1], rd[3 * ray + 2]};
  }
  float tmin = txr::INF_T;
  int slot = 0;
  if (kTiled) {
    for (int a = 0; a < tl.lay.n; a += tl.tile) {
      const int b = min(a + tl.tile, tl.lay.n);
      txr::stage_tile(m, tl.lay, buf, sm, a, b);
      if (mine)
        txr::nearest_span<true>(m, txr::tile_span(m, tl.lay, a, b), sm, o, d, tmin, slot);
    }
  } else if (mine) {
    txr::nearest_sweep(m, sm, o, d, tmin, slot);
  }

  bool shade = false;
  if (mine) {
    const bool hit = tmin < txr::INF_T;
    const int b_sp = m.n_pl, b_su = b_sp + m.n_sp, b_bx = b_su + m.n_su, b_to = b_bx + m.n_bx;
    const int b_ri = b_to + m.n_to, b_lp = b_ri + m.n_ri, n_slots = b_lp + m.n_lp;
    if (!hit) {
      fill_rows(fout, ray, N, 0, fill ? NF : 1);  // without FLAG_FILL, t alone
      if (fill) fill_ints(iout, ray, N);
    } else {
      const float ts = tmin;
      const f3 p = {o.x + d.x * ts, o.y + d.y * ts, o.z + d.z * ts};

      // ---- winner info (get_hit_info) --------------------------------------
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
        float mx = txr::safe_recip(ld.x), my = txr::safe_recip(ld.y),
              mz = txr::safe_recip(ld.z);
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
        nrm = txr::norm3(
            txr::rotq_conj(T + 3, {l.x * (kk - R2), l.y * (kk - R2), l.z * (kk + R2)}));
      } else if (slot < b_lp) {
        nrm = txr::rotq_conj(RI + RRI * (slot - b_ri) + 3, {0.0f, 0.0f, -1.0f});
      }

      // ---- texture request --------------------------------------------------
      const int atk = slot < n_slots ? (int)TEXSLOT[slot] : -1;
      const bool textured = atk >= 0;
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
            float tpw =
                fmaxf(tW * 2.0f * rmid / fmaxf(r2 - r1, 1e-12f), tH / (txr::PI_F * rmid));
            lodv = log2f(fmaxf(fw * tpw, 1.0f));
          }
        }
      }

      // ---- material row -------------------------------------------------------
      float mat[12];
#pragma unroll
      for (int j = 0; j < 12; ++j) mat[j] = slot < n_slots ? MAT[12 * slot + j] : 0.0f;
      const float m_refl = mat[7], m_refr = mat[8], m_spec = mat[9];

      // ---- facing flip + Fresnel (rt.frag:837-849) ----------------------------
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

      // ---- base rows ----------------------------------------------------------
      float rows[11] = {tmin, nf.x, nf.y, nf.z, outside ? 1.0f : 0.0f, rm,
                        req_a, req_b, req_c, lodv, tex_w};
#pragma unroll
      for (int j = 0; j < 11; ++j) F[j * N] = rows[j];
#pragma unroll
      for (int j = 0; j < 12; ++j) F[(11 + j) * N] = mat[j];
      iout[ray] = slot;
      iout[N + ray] = kind;
      iout[2 * N + ray] = req_k;

      // ---- what the shading probes need (calcShade2 + inShadow) ---------------
      shade = slot < b_lp && n_lights > 0;
      if (shade) {
        const float bias = (9e-3f * ts + 35.0f) / 35e3f;
        // the glossy probe shades with the unflipped normal (rt.frag:787-802)
        const f3 sn = (m.flags & FLAG_SHADE_FLIPPED) ? nf : nrm;
        const float in[10] = {p.x + nf.x * bias, p.y + nf.y * bias, p.z + nf.z * bias,
                              sn.x, sn.y, sn.z, d.x, d.y, d.z, m_spec};
#pragma unroll
        for (int j = 0; j < 10; ++j) s_in[j][tid] = in[j];
      } else if (fill) {
        fill_rows(fout, ray, N, kBaseRows, NF);
      }
    }
  }

  // ---- the lanes that shade: compact again ------------------------------------
  // Staged whole, each thread of the live warps takes (lane, light) pairs,
  // light by light, so a warp traces one light's shadow rays from
  // neighbouring lanes and a lane's lights run side by side.  With tiles,
  // each thread of every warp takes a lane and a group of its lights
  // (Lights), group by group, a round of kThreads items at a time, each
  // round streaming the tiles once (a thread whose lights are all occluded
  // keeps taking part in the stages).
  const int n_shade = txr::compact(shade, tid, kTiled ? kWarps : n_busy, s_shade, s_wc2);
  const bool shadows = m.flags & FLAG_SHADOW;
  float* col = fout + base;
  if (!kTiled) {
    const int n_pairs = n_shade * n_lights;
#pragma unroll 1
    for (int q = tid; q < n_pairs; q += n_busy * 32) {
      const Pair p = begin_pair(m, sm, q, n_shade, s_shade, s_live, s_in, col, N);
      p.G[p.row * N] = shadows && txr::occluded(m, sm, p.so, p.ldir, p.dist) ? 1.0f : 0.0f;
      ring_rows(m, txr::whole_span(m), sm, p, N, shadows);
    }
    return;
  }
  const int n_items = n_shade * ((n_lights + kGroup - 1) / kGroup);
#pragma unroll 1
  for (int q0 = 0; q0 < n_items; q0 += kThreads) {
    const int q = q0 + tid;
    const bool item = q < n_items;
    Lights s{};
    if (item) s = begin_lights(m, buf, q, n_shade, n_lights, s_shade, s_live, s_in, col, N);
    unsigned occ = 0;  // bit j: light l0 + j is occluded
    if (shadows) {
      for (int a = 0; a < tl.lay.n; a += tl.tile) {
        const int b = min(a + tl.tile, tl.lay.n);
        txr::stage_tile(m, tl.lay, buf, sm, a, b);
        if (item) {
          const txr::Span sp = txr::tile_span(m, tl.lay, a, b);
          occ = txr::occluded_group_span(m, sp, sm, s.so, s.ldir, s.dist, s.n, occ);
#pragma unroll 1
          for (int j = 0; j < s.n; ++j) ring_rows(m, sp, sm, s.pair(m, j), N, true);
        }
      }
    } else if (item) {
#pragma unroll 1
      for (int j = 0; j < s.n; ++j) ring_rows(m, txr::whole_span(m), sm, s.pair(m, j), N, false);
    }
    if (item) {
#pragma unroll 1
      for (int j = 0; j < s.n; ++j) {
        const Pair p = s.pair(m, j);
        p.G[p.row * N] = occ >> j & 1u ? 1.0f : 0.0f;
      }
    }
  }
}

template <bool kTiled>
__global__ void step_probe_kernel(Meta m, const float* __restrict__ buf, txr::Tiles tl,
                                  const float* __restrict__ ro, const float* __restrict__ rd,
                                  const unsigned char* __restrict__ alive,
                                  float* __restrict__ fout, int* __restrict__ iout, long long n);

// The whole-table kernel takes the registers ptxas gives it.  The tiled one
// is held to 64, so that 4 blocks share an SM: left to itself, ptxas gives
// its light groups 80, and at 3 blocks an SM its sweep of a large table is
// slower.
template <>
__global__ void __launch_bounds__(kThreads)
    step_probe_kernel<false>(Meta m, const float* __restrict__ buf, txr::Tiles tl,
                             const float* __restrict__ ro, const float* __restrict__ rd,
                             const unsigned char* __restrict__ alive, float* __restrict__ fout,
                             int* __restrict__ iout, long long n) {
  step_probe<false>(m, buf, tl, ro, rd, alive, fout, iout, n);
}

template <>
__global__ void __launch_bounds__(kThreads, 4)
    step_probe_kernel<true>(Meta m, const float* __restrict__ buf, txr::Tiles tl,
                            const float* __restrict__ ro, const float* __restrict__ rd,
                            const unsigned char* __restrict__ alive, float* __restrict__ fout,
                            int* __restrict__ iout, long long n) {
  step_probe<true>(m, buf, tl, ro, rd, alive, fout, iout, n);
}

}  // namespace

// hdr: the table header (txr::Meta's integer fields in order), read on the
// host; alive: uint8 [n] or null for every lane; tile: 0 to stage the table
// as txr::plan_stage finds best, > 0 to force tiles of that many floats of
// the tile layout (tests); n_tiles: where the number of stages a block makes a sweep is
// written (1: the whole table), or null; grouped: where 1 is written when the
// launch's shadow pass takes a lane's lights in groups (the tiled kernel,
// shadows on, some light), else 0, or null.  Returns cudaGetLastError()
// after the launch; the caller raises on non-zero.
extern "C" int txr_step_probe(const int* hdr, const float* buf, float pix_angle, const float* ro,
                              const float* rd, const unsigned char* alive, float* fout,
                              int* iout, long long n, int tile, int* n_tiles, int* grouped,
                              void* stream) {
  const Meta m = txr::make_meta(hdr, pix_angle);
  txr::Stage st;
  if (int e = txr::plan_stage(m, step_probe_kernel<false>, step_probe_kernel<true>, kThreads,
                              m.n_buf, tile, st))
    return e;
  if (n_tiles) *n_tiles = st.n_tiles;
  if (grouped) *grouped = st.t.tile != 0 && (m.flags & FLAG_SHADOW) && m.n_lp + m.n_ld > 0;
  if (n <= 0) return 0;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  if (st.t.tile == 0) {
    step_probe_kernel<false><<<grid, kThreads, st.smem, s>>>(m, buf, st.t, ro, rd, alive, fout,
                                                             iout, n);
  } else {
    step_probe_kernel<true><<<grid, kThreads, st.smem, s>>>(m, buf, st.t, ro, rd, alive, fout,
                                                            iout, n);
  }
  return (int)cudaGetLastError();
}

// The kernel that a launch on a table with header hdr takes (plan_stage):
// its registers a thread and its blocks an SM at the planned shared memory.
// Returns a CUDA error, or 0.
extern "C" int txr_step_probe_occupancy(const int* hdr, int* regs, int* blocks) {
  const Meta m = txr::make_meta(hdr, 0.0f);
  txr::Stage st;
  if (int e = txr::plan_stage(m, step_probe_kernel<false>, step_probe_kernel<true>, kThreads,
                              m.n_buf, 0, st))
    return e;
  const void* k = st.t.tile == 0 ? (const void*)step_probe_kernel<false>
                                 : (const void*)step_probe_kernel<true>;
  cudaFuncAttributes fa;
  if (int e = (int)cudaFuncGetAttributes(&fa, k)) return e;
  *regs = fa.numRegs;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, k, kThreads, st.smem);
}
