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
// table is staged in shared memory once per block.  Built with -fmad=false
// so it rounds as its twin does.

#include <cuda_runtime.h>

#include "txr_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

__global__ void __launch_bounds__(kThreads)
    shadow_sweep_kernel(txr::Meta m, const float* __restrict__ buf, const float* __restrict__ ro,
                        const float* __restrict__ rd, const float* __restrict__ dist,
                        const unsigned char* __restrict__ need, float* __restrict__ solid,
                        float* __restrict__ ring, long long n) {
  extern __shared__ float sm[];
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
  txr::stage_table(m, buf, sm);
  if (tid >= count) return;  // past the needed count: retire
  const long long ray = base + s_list[tid];
  const txr::f3 o = {ro[3 * ray], ro[3 * ray + 1], ro[3 * ray + 2]};
  const txr::f3 d = {rd[3 * ray], rd[3 * ray + 1], rd[3 * ray + 2]};
  const float dmax = dist[ray];
  solid[ray] = txr::occluded(m, sm, o, d, dmax) ? 1.0f : 0.0f;
  for (int k = 0; k < m.n_ri; ++k) {
    float u, v;
    bool h = txr::ring_shadow(sm + m.o_ri + txr::RRI * k, o, d, dmax, u, v);
    ring[(3 * k) * n + ray] = h ? 1.0f : 0.0f;
    ring[(3 * k + 1) * n + ray] = u;
    ring[(3 * k + 2) * n + ray] = v;
  }
}

}  // namespace

// hdr: the table header, read on the host; need: uint8 [n] or null for
// every ray; solid [n] f32, ring [3 nr, n] f32 (unused without rings).
// Returns cudaGetLastError() after the launch.
extern "C" int txr_shadow_sweep(const int* hdr, const float* buf, const float* ro,
                                const float* rd, const float* dist, const unsigned char* need,
                                float* solid, float* ring, long long n, void* stream) {
  const txr::Meta m = txr::make_meta(hdr, 0.0f);
  if (n <= 0) return 0;
  const size_t smem = (size_t)m.n_buf * sizeof(float);
  if (int e = txr::allow_smem(shadow_sweep_kernel, smem)) return e;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  shadow_sweep_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(m, buf, ro, rd, dist, need,
                                                                       solid, ring, n);
  return (int)cudaGetLastError();
}
