// The shadow any-hit sweep, CUDA C++ for sm_90a.
//
// Replaces txr/kernels/pallas_intersect.py:shadow_sweep_pallas (kernel body
// _build_shadow_kernel, pallas_intersect.py:423-485).  One thread per
// shadow ray tests every occluder closer than the light's distance:
// spheres (solid; the hollow flag is ignored), two-sided planes, boxes,
// surfaces and toruses.  It writes solid [n] as 0/1 and, for each ring k,
// rows 3k..3k+2 of ring [3 nr, n]: the hit bit and the hit's (u, v), zeros
// where the ring is not hit, so the caller can weigh a textured ring by its
// texture alpha.  `need` (uint8 [n], or null for every ray) marks the rays
// whose answer the caller reads; the others get the fill of a ray that hits
// nothing (all zeros), as in the twin (shadow_sweep.py:shadow_sweep_ref).
//
// What bounds it: the work of the needed rays.  A ray reads 28 B and writes
// 4 + 12 nr B; its sweep was some 1.8 thousand FP32 operations on the demo
// scene, half of them the torus.  So each block compacts its needed rays
// into a shared-memory list (ballot, popcount, per-warp offsets; warps past
// the count retire, a block with none skips the table copy), a ray stops
// at its first solid occluder, and the torus's Ferrari solve runs only on
// lines that cross its inflated bounding sphere (txr_common.cuh).  Every
// ring's (hit, u, v) is still an output, so rings are always tested.  The
// table is staged in shared memory once per block, whole when it fits a
// block's room at full occupancy, else in tiles of its slot records that
// every thread of the block stages in turn, each sphere as one 16-byte
// (centre, r^2) record (txr_common.cuh plan_stage): shadow_sweep_kernel<true>.  Built with
// -fmad=false so it rounds as its twin does.

#include <cuda_runtime.h>

#include "txr_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// kTiled: the table is swept in tiles (txr_common.cuh Tiles, Span);
// otherwise staged whole, and `tl` is unused.
template <bool kTiled>
__global__ void __launch_bounds__(kThreads)
    shadow_sweep_kernel(txr::Meta m, const float* __restrict__ buf, txr::Tiles tl,
                        const float* __restrict__ ro, const float* __restrict__ rd,
                        const float* __restrict__ dist, const unsigned char* __restrict__ need,
                        float* __restrict__ solid, float* __restrict__ ring, long long n) {
  extern __shared__ __align__(16) float sm[];
  __shared__ int s_list[kThreads], s_wc[kWarps];
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * kThreads;
  const long long own = base + tid;
  const bool live = own < n && (need == nullptr || need[own] != 0);
  const int count = txr::compact(live, tid, kWarps, s_list, s_wc);
  if (own < n && !live) {
    solid[own] = 0.0f;
    for (int j = 0; j < 3 * m.n_ri; ++j) ring[j * n + own] = 0.0f;
  }
  if (count == 0) return;  // the whole block
  if (!kTiled) txr::stage_table(m, buf, sm);
  // past the needed count: retire, or with tiles stay for the stages
  if (!kTiled && tid >= count) return;
  const bool mine = tid < count;
  const long long ray = base + (mine ? s_list[tid] : 0);
  txr::f3 o = {0.0f, 0.0f, 0.0f}, d = {0.0f, 0.0f, 0.0f};
  float dmax = 0.0f;
  if (mine) {
    o = {ro[3 * ray], ro[3 * ray + 1], ro[3 * ray + 2]};
    d = {rd[3 * ray], rd[3 * ray + 1], rd[3 * ray + 2]};
    dmax = dist[ray];
  }
  // each ring's (hit, u, v), for the rings of one span
  auto rings = [&](const txr::Span& sp) {
    const float* RI = sm - sp.a + sp.lay.o[5];
    for (int k = sp.lo[5]; k < sp.hi[5]; ++k) {
      float u, v;
      bool h = txr::ring_shadow(RI + txr::RRI * k, o, d, dmax, u, v);
      ring[(3 * k) * n + ray] = h ? 1.0f : 0.0f;
      ring[(3 * k + 1) * n + ray] = u;
      ring[(3 * k + 2) * n + ray] = v;
    }
  };
  if (!kTiled) {
    solid[ray] = txr::occluded(m, sm, o, d, dmax) ? 1.0f : 0.0f;
    rings(txr::whole_span(m));
    return;
  }
  bool occ = false;
  for (int a = 0; a < tl.lay.n; a += tl.tile) {
    const int b = min(a + tl.tile, tl.lay.n);
    txr::stage_tile(m, tl.lay, buf, sm, a, b);
    if (mine) {
      const txr::Span sp = txr::tile_span(m, tl.lay, a, b);
      occ = occ || txr::occluded_span<true>(m, sp, sm, o, d, dmax);
      rings(sp);
    }
  }
  if (mine) solid[ray] = occ ? 1.0f : 0.0f;
}

}  // namespace

// hdr: the table header, read on the host; need: uint8 [n] or null for
// every ray; solid [n] f32, ring [3 nr, n] f32 (unused without rings); tile
// as txr_step_probe's.  Returns cudaGetLastError() after the launch.
extern "C" int txr_shadow_sweep(const int* hdr, const float* buf, const float* ro,
                                const float* rd, const float* dist, const unsigned char* need,
                                float* solid, float* ring, long long n, int tile, void* stream) {
  const txr::Meta m = txr::make_meta(hdr, 0.0f);
  txr::Stage st;
  if (int e = txr::plan_stage(m, shadow_sweep_kernel<false>, shadow_sweep_kernel<true>, kThreads,
                              m.n_buf, tile, st))
    return e;
  if (n <= 0) return 0;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  const cudaStream_t s = (cudaStream_t)stream;
  if (st.t.tile == 0) {
    shadow_sweep_kernel<false><<<grid, kThreads, st.smem, s>>>(m, buf, st.t, ro, rd, dist, need,
                                                               solid, ring, n);
  } else {
    shadow_sweep_kernel<true><<<grid, kThreads, st.smem, s>>>(m, buf, st.t, ro, rd, dist, need,
                                                              solid, ring, n);
  }
  return (int)cudaGetLastError();
}
