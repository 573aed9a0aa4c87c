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
// parameter is a broadcast read.  Built with -fmad=false so it rounds as
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

// calcInter over every slot in reference order with strict '<'.  A miss
// leaves tmin = INF_T, slot 0.
__device__ __forceinline__ void sweep(const float* sm, f3 o, f3 d, bool one_side, float& tmin,
                                      int& slot) {
  tmin = INF_T;
  slot = 0;
  float t;
#pragma unroll
  for (int k = 0; k < NPL; ++k)
    if (plane_test(sm + OPL + RPL * k, o, d, one_side, t) && t < tmin) tmin = t, slot = k;
#pragma unroll
  for (int k = 0; k < NSP; ++k) {
    const float* S = sm + OSP + RSP * k;
    if (sphere_test(S, S[3], S[4] != 0.0f, o, d, t) && t < tmin) tmin = t, slot = SSP + k;
  }
#pragma unroll
  for (int k = 0; k < NSU; ++k)
    if (surface_test(sm + OSU + RSU * k, o, d, t) && t < tmin) tmin = t, slot = SSU + k;
#pragma unroll
  for (int k = 0; k < NBX; ++k)
    if (box_test(sm + OBX + RBX * k, o, d, t) && t < tmin) tmin = t, slot = SBX + k;
#pragma unroll
  for (int k = 0; k < NTO; ++k)
    if (torus_test(sm + OTO + RTO * k, o, d, t) && t < tmin) tmin = t, slot = STO + k;
#pragma unroll
  for (int k = 0; k < NRI; ++k) {
    float x, pp;
    if (ring_test(sm + ORI + RRI * k, o, d, t, x, pp) && t < tmin) tmin = t, slot = SRI + k;
  }
#pragma unroll
  for (int k = 0; k < NLP; ++k) {
    const float* L = sm + OLP + RLP * k;
    if (sphere_test(L, L[3], false, o, d, t) && t < tmin) tmin = t, slot = SLP + k;
  }
}

__global__ void __launch_bounds__(kThreads)
    nearest_hit_kernel(const float* __restrict__ buf, const float* __restrict__ ro,
                       const float* __restrict__ rd, const unsigned char* __restrict__ alive,
                       float* __restrict__ tout, int* __restrict__ sout, long long n,
                       bool one_side) {
  extern __shared__ float sm[];
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
  for (int k = tid; k < NTAB; k += kThreads) sm[k] = buf[k];
  __syncthreads();
  if (tid >= n_live) return;  // past the live count: retire
  const long long ray = base + s_live[tid];
  const f3 o = {ro[3 * ray], ro[3 * ray + 1], ro[3 * ray + 2]};
  const f3 d = {rd[3 * ray], rd[3 * ray + 1], rd[3 * ray + 2]};
  float tmin;
  int slot;
  sweep(sm, o, d, one_side, tmin, slot);
  tout[ray] = tmin;
  sout[ray] = slot;
}

}  // namespace

// hdr: the table header, read on the host; it must hold this library's
// counts and offsets, else kWrongTable and no launch.  alive: uint8 [n] or
// null for every ray; tout [n] f32, sout [n] int32.  Returns
// cudaGetLastError() after the launch; the caller raises on non-zero.
extern "C" int txr_nearest_hit(const int* hdr, const float* buf, const float* ro, const float* rd,
                               const unsigned char* alive, float* tout, int* sout, long long n,
                               void* stream) {
  const int counts[7] = {NPL, NSP, NSU, NBX, NTO, NRI, NLP};
  const int offsets[8] = {OPL, OSP, OSU, OBX, OTO, ORI, OLP, NTAB};
  for (int j = 0; j < 7; ++j)
    if (hdr[j] != counts[j]) return kWrongTable;
  for (int j = 0; j < 8; ++j)
    if (hdr[10 + j] != offsets[j]) return kWrongTable;
  if (n <= 0) return 0;
  const size_t smem = (size_t)NTAB * sizeof(float);
  if (int e = allow_smem(nearest_hit_kernel, smem)) return e;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  nearest_hit_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      buf, ro, rd, alive, tout, sout, n, (hdr[9] & FLAG_ONE_SIDE) != 0);
  return (int)cudaGetLastError();
}
