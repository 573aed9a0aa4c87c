// The shadow any-hit sweep, CUDA C++ for sm_90a.
//
// Replaces txr/kernels/pallas_intersect.py:shadow_sweep_pallas (kernel body
// _build_shadow_kernel, pallas_intersect.py:423-485).  One thread per
// shadow ray tests every occluder closer than the light's distance:
// spheres (solid; the hollow flag is ignored), surfaces, boxes, toruses,
// and planes only when two-sided.  It writes solid [n] as 0/1 and, for each
// ring k, rows 3k..3k+2 of ring [3 nr, n]: the hit bit and the hit's
// (u, v), zeros where the ring is not hit, so the caller can weigh a
// textured ring by its texture alpha.
//
// What bounds it: arithmetic.  A ray reads 28 B and writes 4 + 12 nr B, but
// its sweep is some 1.8 thousand FP32 operations on the demo scene, half of
// them the torus.  The table is staged in shared memory once per block.  A
// ray does not stop at its first occluder: every ring's (hit, u, v) is an
// output, and the sweep stays the twin's (shadow_sweep.py:shadow_sweep_ref)
// operation for operation.  Built with -fmad=false.

#include <cuda_runtime.h>

#include "txr_common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    shadow_sweep_kernel(txr::Meta m, const float* __restrict__ buf, const float* __restrict__ ro,
                        const float* __restrict__ rd, const float* __restrict__ dist,
                        float* __restrict__ solid, float* __restrict__ ring, long long n) {
  extern __shared__ float sm[];
  txr::stage_table(m, buf, sm);
  const long long ray = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n) return;
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

// hdr: the table header, read on the host; solid [n] f32, ring [3 nr, n] f32
// (unused without rings).  Returns cudaGetLastError() after the launch.
extern "C" int txr_shadow_sweep(const int* hdr, const float* buf, const float* ro,
                                const float* rd, const float* dist, float* solid, float* ring,
                                long long n, void* stream) {
  const txr::Meta m = txr::make_meta(hdr, 0.0f);
  if (n <= 0) return 0;
  const size_t smem = (size_t)m.n_buf * sizeof(float);
  if (int e = txr::allow_smem(shadow_sweep_kernel, smem)) return e;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  shadow_sweep_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(m, buf, ro, rd, dist,
                                                                       solid, ring, n);
  return (int)cudaGetLastError();
}
