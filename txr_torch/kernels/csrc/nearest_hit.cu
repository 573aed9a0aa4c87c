// The nearest-hit sweep, CUDA C++ for sm_90a, built once per scene topology.
//
// Replaces txr/kernels/pallas_intersect.py:nearest_hit_pallas (kernel body
// _build_kernel, pallas_intersect.py:281-345).  For each live ray, calcInter
// over every primitive of the packed scene table in reference order
// (planes, spheres, surfaces, boxes, toruses, rings, point-light bulbs;
// strict '<') writes (tmin, slot); tmin >= BIG means a miss.  `alive`
// (uint8 [n], or null for every ray) marks the rays whose answer the caller
// reads; the others get the fill of a miss (tmin = INF_T, slot 0), as in
// the twin (kernels/nearest_hit.py: nearest_hit_ref).
//
// What bounds it: instructions.  A ray reads 24 B and writes 8 B, but its
// sweep is some 1.8 thousand FP32 operations on the demo scene, half of
// them the torus's Ferrari solve.  So the kernel does only the work that
// the live rays need, with nothing left to decide at run time:
//  - the slot counts are -D defines (TXR_N_PL ... TXR_N_LP, kernels/
//    build.py builds one library per topology, as the Pallas kernel bakes
//    its counts in at trace time): every loop unrolls, and every record
//    offset into the table is a constant;
//  - each block compacts its live rays into a shared-memory list (ballot,
//    popcount, per-warp offsets; txr_common.cuh compact).  Off lanes write
//    their fill themselves, coalesced; warps past the live count retire, and
//    a block with none skips even the table copy;
//  - the torus's Ferrari solve runs only on lines that cross its culling
//    sphere (txr_common.cuh torus_culled), in line: a second pass that
//    compacted the crossing rays of each block onto full warps measured
//    slower on the demo frame's bounce steps, whose crossing rays lie close
//    together (PERF.md, findings on the nearest-hit redesign).
// The table is staged in shared memory once per block, so every primitive
// parameter is a broadcast read; a table too large for a block's room at full
// occupancy is swept in tiles of its slot records that every thread of the
// block stages in turn, in slot order with the same strict '<', each sphere
// staged as one 16-byte (centre, r^2) record (txr_common.cuh plan_stage,
// nearest_span): nearest_hit_kernel<true>.  A
// type's loop unrolls only up to UNROLL_MAX records, so a topology of
// thousands of spheres still builds.  Built with -fmad=false so it rounds as
// its twin does.

#include <cuda_runtime.h>

#include "txr_common.cuh"

#if !defined(TXR_N_PL) || !defined(TXR_N_SP) || !defined(TXR_N_SU) || !defined(TXR_N_BX) || \
    !defined(TXR_N_TO) || !defined(TXR_N_RI) || !defined(TXR_N_LP)
#error "nearest_hit.cu is built per scene topology: define TXR_N_PL ... TXR_N_LP (kernels/build.py)"
#endif

namespace {

using namespace txr;  // f3, the record widths, the primitive tests

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// slot counts of the topology this library is built for
constexpr int NPL = TXR_N_PL, NSP = TXR_N_SP, NSU = TXR_N_SU, NBX = TXR_N_BX, NTO = TXR_N_TO,
              NRI = TXR_N_RI, NLP = TXR_N_LP;
// record offsets of the packed table (scene_table.py pack_scene puts the
// slot records first, in slot order), its slot part's length, and the
// first slot of each type
constexpr int OPL = 0, OSP = OPL + RPL * NPL, OSU = OSP + RSP * NSP, OBX = OSU + RSU * NSU,
              OTO = OBX + RBX * NBX, ORI = OTO + RTO * NTO, OLP = ORI + RRI * NRI,
              NTAB = OLP + RLP * NLP;
constexpr int SSP = NPL, SSU = SSP + NSP, SBX = SSU + NSU, STO = SBX + NBX, SRI = STO + NTO,
              SLP = SRI + NRI;
constexpr int kWrongTable = -1;  // the launcher's code for a table of another topology
// a loop over n records unrolls whole up to UNROLL_MAX of them
constexpr int UNROLL_MAX = 64;
__host__ __device__ constexpr int unroll(int n) { return n >= 1 && n <= UNROLL_MAX ? n : 1; }

// calcInter over every slot in reference order with strict '<'.  A miss
// leaves tmin = INF_T, slot 0.
__device__ __forceinline__ void sweep(const float* sm, f3 o, f3 d, bool one_side, float& tmin,
                                      int& slot) {
  tmin = INF_T;
  slot = 0;
  float t;
#pragma unroll unroll(NPL)
  for (int k = 0; k < NPL; ++k)
    if (plane_test(sm + OPL + RPL * k, o, d, one_side, t) && t < tmin) tmin = t, slot = k;
#pragma unroll unroll(NSP)
  for (int k = 0; k < NSP; ++k) {
    const float* S = sm + OSP + RSP * k;
    if (sphere_test(S, S[3], S[4] != 0.0f, o, d, t) && t < tmin) tmin = t, slot = SSP + k;
  }
#pragma unroll unroll(NSU)
  for (int k = 0; k < NSU; ++k)
    if (surface_test(sm + OSU + RSU * k, o, d, t) && t < tmin) tmin = t, slot = SSU + k;
#pragma unroll unroll(NBX)
  for (int k = 0; k < NBX; ++k)
    if (box_test(sm + OBX + RBX * k, o, d, t) && t < tmin) tmin = t, slot = SBX + k;
#pragma unroll unroll(NTO)
  for (int k = 0; k < NTO; ++k)
    if (torus_test(sm + OTO + RTO * k, o, d, t) && t < tmin) tmin = t, slot = STO + k;
#pragma unroll unroll(NRI)
  for (int k = 0; k < NRI; ++k) {
    float x, pp;
    if (ring_test(sm + ORI + RRI * k, o, d, t, x, pp) && t < tmin) tmin = t, slot = SRI + k;
  }
#pragma unroll unroll(NLP)
  for (int k = 0; k < NLP; ++k) {
    const float* L = sm + OLP + RLP * k;
    if (sphere_test(L, L[3], false, o, d, t) && t < tmin) tmin = t, slot = SLP + k;
  }
}

// kTiled: the table is swept in tiles (txr_common.cuh Tiles, Span, reading
// m); otherwise staged whole, and `tl` is unused.
template <bool kTiled>
__global__ void __launch_bounds__(kThreads)
    nearest_hit_kernel(Meta m, const float* __restrict__ buf, Tiles tl,
                       const float* __restrict__ ro, const float* __restrict__ rd,
                       const unsigned char* __restrict__ alive, float* __restrict__ tout,
                       int* __restrict__ sout, long long n, bool one_side) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int s_live[kThreads], s_wc[kWarps];
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * kThreads;
  const long long own = base + tid;
  const bool live = own < n && (alive == nullptr || alive[own] != 0);
  const int n_live = compact(live, tid, kWarps, s_live, s_wc);
  if (own < n && !live) {
    tout[own] = INF_T;
    sout[own] = 0;
  }
  if (n_live == 0) return;  // the whole block
  const bool mine = tid < n_live;
  const long long ray = base + (mine ? s_live[tid] : 0);
  f3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 0.0f};
  float tmin = INF_T;
  int slot = 0;
  if (!kTiled) {
    for (int k = tid; k < NTAB; k += kThreads) sm[k] = buf[k];
    __syncthreads();
    if (!mine) return;  // past the live count: retire
    o = {ro[3 * ray], ro[3 * ray + 1], ro[3 * ray + 2]};
    d = {rd[3 * ray], rd[3 * ray + 1], rd[3 * ray + 2]};
    sweep(sm, o, d, one_side, tmin, slot);
  } else {
    if (mine) {
      o = {ro[3 * ray], ro[3 * ray + 1], ro[3 * ray + 2]};
      d = {rd[3 * ray], rd[3 * ray + 1], rd[3 * ray + 2]};
    }
    for (int a = 0; a < tl.lay.n; a += tl.tile) {
      const int b = min(a + tl.tile, tl.lay.n);
      stage_tile(m, tl.lay, buf, sm, a, b);
      if (mine) nearest_span<true>(m, tile_span(m, tl.lay, a, b), sm, o, d, tmin, slot);
    }
    if (!mine) return;
  }
  tout[ray] = tmin;
  sout[ray] = slot;
}

}  // namespace

// hdr: the table header, read on the host; it must hold this library's
// counts and offsets, else kWrongTable and no launch.  alive: uint8 [n] or
// null for every ray; tout [n] f32, sout [n] int32; tile as txr_step_probe's.
// Returns cudaGetLastError() after the launch; the caller raises on non-zero.
extern "C" int txr_nearest_hit(const int* hdr, const float* buf, const float* ro, const float* rd,
                               const unsigned char* alive, float* tout, int* sout, long long n,
                               int tile, void* stream) {
  const int counts[7] = {NPL, NSP, NSU, NBX, NTO, NRI, NLP};
  const int offsets[8] = {OPL, OSP, OSU, OBX, OTO, ORI, OLP, NTAB};
  for (int j = 0; j < 7; ++j)
    if (hdr[j] != counts[j]) return kWrongTable;
  for (int j = 0; j < 8; ++j)
    if (hdr[10 + j] != offsets[j]) return kWrongTable;
  const Meta m = make_meta(hdr, 0.0f);
  Stage st;
  if (int e = plan_stage(m, nearest_hit_kernel<false>, nearest_hit_kernel<true>, kThreads, NTAB,
                         tile, st))
    return e;
  if (n <= 0) return 0;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  const bool one_side = (hdr[9] & FLAG_ONE_SIDE) != 0;
  if (st.t.tile == 0) {
    nearest_hit_kernel<false><<<grid, kThreads, st.smem, s>>>(m, buf, st.t, ro, rd, alive, tout,
                                                              sout, n, one_side);
  } else {
    nearest_hit_kernel<true><<<grid, kThreads, st.smem, s>>>(m, buf, st.t, ro, rd, alive, tout,
                                                             sout, n, one_side);
  }
  return (int)cudaGetLastError();
}
