// The nearest-hit sweep, CUDA C++ for sm_90a.
//
// Replaces txr/kernels/pallas_intersect.py:nearest_hit_pallas (kernel body
// _build_kernel, pallas_intersect.py:281-345).  One thread per ray runs
// calcInter over every primitive of the packed scene table in reference
// order (planes, spheres, surfaces, boxes, toruses, rings, point-light
// bulbs; strict '<') and writes (tmin, slot); tmin >= BIG means a miss.
//
// What bounds it: arithmetic.  A ray reads 24 B and writes 8 B, but its
// sweep is some 1.8 thousand FP32 operations on the demo scene, half of
// them the torus's Ferrari solve, which runs only on lines that cross the
// torus's inflated bounding sphere (txr_common.cuh: torus_culled).  The
// table is staged in shared memory once per block, so every primitive
// parameter is a broadcast read; counts are runtime loop bounds.  No
// topology specialisation, no compaction of dead rays yet.  Built with
// -fmad=false so it rounds as its twin (kernels/nearest_hit.py:
// nearest_hit_ref) does.

#include <cuda_runtime.h>

#include "txr_common.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
    nearest_hit_kernel(txr::Meta m, const float* __restrict__ buf, const float* __restrict__ ro,
                       const float* __restrict__ rd, float* __restrict__ tout,
                       int* __restrict__ sout, long long n) {
  extern __shared__ float sm[];
  txr::stage_table(m, buf, sm);
  const long long ray = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= n) return;
  const txr::f3 o = {ro[3 * ray], ro[3 * ray + 1], ro[3 * ray + 2]};
  const txr::f3 d = {rd[3 * ray], rd[3 * ray + 1], rd[3 * ray + 2]};
  float tmin;
  int slot;
  txr::nearest_sweep(m, sm, o, d, tmin, slot);
  tout[ray] = tmin;
  sout[ray] = slot;
}

}  // namespace

// hdr: the table header, read on the host; tout [n] f32, sout [n] int32.
// Returns cudaGetLastError() after the launch; the caller raises on non-zero.
extern "C" int txr_nearest_hit(const int* hdr, const float* buf, const float* ro, const float* rd,
                               float* tout, int* sout, long long n, void* stream) {
  const txr::Meta m = txr::make_meta(hdr, 0.0f);
  if (n <= 0) return 0;
  const size_t smem = (size_t)m.n_buf * sizeof(float);
  if (int e = txr::allow_smem(nearest_hit_kernel, smem)) return e;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  nearest_hit_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(m, buf, ro, rd, tout, sout,
                                                                      n);
  return (int)cudaGetLastError();
}
