// The lane map of a compacted bounce step, CUDA C++ for sm_90a.
//
// Replaces no TPU kernel.  The JAX package compacts its bounce state in
// XLA (txr/render/compact.py, the lax.cond tiers of txr/render/trace.py);
// the port's render_jit runs each bounce step after the first two on the
// live lanes gathered into C < R rows (render/graphs.py:
// TraceUnit._step), and the ATen ops of that map (cumsum, where,
// index_put_ of an arange over every lane, an index_select per state
// field, an index_put_ per field back, a sum over every lane) were some 25
// launches a step.  Here they are three, in two entry points:
//
//  - txr_lane_compact: alive [R] -> lane [C], the live lanes in ascending
//    order and then R as a fill, and the eight state fields of each mapped
//    lane gathered into C rows; a fill row is row R - 1's with alive off,
//    as the plain twin (kernels/lane_map.py: compact_ref) gives it; live
//    is set to 0 for the scatter that follows.  Two launches: the count of
//    live lanes in each tile of kTile lanes, then the map, in which each
//    block sums the counts before its tile (no atomic decides a position,
//    so the order is the twin's), ranks its live lanes by warp ballots and
//    popcounts round by round, and writes their lanes and rows; every
//    block writes its share of the fills.  Live lanes past C are dropped,
//    as in the twin; the caller never has more than C.
//  - txr_lane_scatter: a step's new rows [C] back to the state's rows at
//    lane (a fill writes nothing), and the live new rows counted: a block
//    sum, then one integer atomic into live, which is exact.
//
// What bounds it: bytes.  A compacted step reads the alive bytes twice (R
// each), moves 58 B of state for each live lane in and out and writes 8 B
// of lane a row; a fill reads one shared row.  So one thread per lane
// and round, neighbouring threads on neighbouring lanes: the reads of the
// gathered lanes and the writes of their rows are coalesced runs, the
// count reads 8 alive bytes a thread in one load, and a tile whose count
// is 0 skips its rounds.  Words are copied as bits, so every field,
// NaN payloads included, arrives as the twin's index_select gives it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 8;                 // lanes a thread counts, rounds a block maps
constexpr int kTile = kThreads * kPer;  // lanes of a block's tile

// The bounce state's fields in STATE_KEYS order (kernels/step_consume.py):
// ro, rd, color, mask [n, 3] and absorb_dist, bounces [n] as 32-bit words,
// alive and missed [n] as bytes.
struct State {
  unsigned* v3[4];
  unsigned* absorb;
  unsigned* bounces;
  unsigned char* alive;
  unsigned char* missed;
};

__device__ __forceinline__ void copy_row(const State& s, long long i, const State& d,
                                         long long p) {
#pragma unroll
  for (int f = 0; f < 4; ++f) {
    const unsigned* a = s.v3[f] + 3 * i;
    unsigned* b = d.v3[f] + 3 * p;
    b[0] = a[0];
    b[1] = a[1];
    b[2] = a[2];
  }
  d.absorb[p] = s.absorb[i];
  d.bounces[p] = s.bounces[i];
  d.alive[p] = s.alive[i];
  d.missed[p] = s.missed[i];
}

// The sum of v over the block, to every thread; red: kWarps ints of shared
// memory.
__device__ __forceinline__ int block_sum(int v, int* red) {
  v = __reduce_add_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int t = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += red[w];
  __syncthreads();
  return t;
}

// The nonzero bytes of a word.
__device__ __forceinline__ int nonzero_bytes(unsigned w) { return __popc(__vcmpne4(w, 0u)) >> 3; }

__global__ void __launch_bounds__(kThreads)
    lane_count_kernel(const unsigned char* __restrict__ alive, long long R,
                      int* __restrict__ counts, unsigned long long* __restrict__ live) {
  __shared__ int red[kWarps];
  const long long first = (long long)blockIdx.x * kTile + (long long)threadIdx.x * kPer;
  int c = 0;
  if (first + kPer <= R && (reinterpret_cast<uintptr_t>(alive) & 7) == 0) {
    const uint2 w = *reinterpret_cast<const uint2*>(alive + first);
    c = nonzero_bytes(w.x) + nonzero_bytes(w.y);
  } else {
    for (int j = 0; j < kPer; ++j) c += first + j < R && alive[first + j] != 0;
  }
  c = block_sum(c, red);
  if (threadIdx.x == 0) counts[blockIdx.x] = c;
  if (blockIdx.x == 0 && threadIdx.x == 0) *live = 0;
}

__global__ void __launch_bounds__(kThreads)
    lane_compact_kernel(State src, State dst, const int* __restrict__ counts, int nb,
                        long long R, long long C, long long* __restrict__ lane) {
  __shared__ int red[kWarps], wc[kWarps];
  int before = 0, total = 0;
  for (int j = threadIdx.x; j < nb; j += kThreads) {
    const int v = counts[j];
    total += v;
    before += j < (int)blockIdx.x ? v : 0;
  }
  before = block_sum(before, red);
  total = block_sum(total, red);
  const int mine = counts[blockIdx.x];
  const int lid = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long tile = (long long)blockIdx.x * kTile;
  int seen = 0;  // the tile's live lanes ranked so far: the same in every thread
  for (int r = 0; r < kPer && seen < mine; ++r) {
    const long long i = tile + (long long)r * kThreads + threadIdx.x;
    const bool a = i < R && src.alive[i] != 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, a);
    if (lid == 0) wc[warp] = __popc(ballot);
    __syncthreads();
    int off = 0, n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = wc[w];
      off += w < warp ? c : 0;
      n += c;
    }
    const long long p = (long long)before + seen + off + __popc(ballot & ((1u << lid) - 1u));
    if (a && p < C) {
      lane[p] = i;
      copy_row(src, i, dst, p);
    }
    seen += n;
    __syncthreads();
  }
  const long long step = (long long)gridDim.x * kThreads;
  for (long long p = (total < C ? total : C) + (long long)blockIdx.x * kThreads + threadIdx.x;
       p < C; p += step) {
    lane[p] = R;
    copy_row(src, R - 1, dst, p);
    dst.alive[p] = 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    lane_scatter_kernel(State src, const long long* __restrict__ lane, State rows, long long R,
                        long long C, unsigned long long* __restrict__ live) {
  __shared__ int red[kWarps];
  const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
  int c = 0;
  if (p < C) {
    const long long l = lane[p];
    if ((unsigned long long)l < (unsigned long long)R) {
      copy_row(src, p, rows, l);
      c = src.alive[p] != 0;
    }
  }
  c = block_sum(c, red);
  if (threadIdx.x == 0 && c) atomicAdd(live, (unsigned long long)c);
}

State make_state(void* const* f) {
  State s;
  for (int k = 0; k < 4; ++k) s.v3[k] = static_cast<unsigned*>(f[k]);
  s.absorb = static_cast<unsigned*>(f[4]);
  s.bounces = static_cast<unsigned*>(f[5]);
  s.alive = static_cast<unsigned char*>(f[6]);
  s.missed = static_cast<unsigned char*>(f[7]);
  return s;
}

}  // namespace

// The lanes of a tile: counts, txr_lane_compact's scratch, holds one int
// a tile.
extern "C" int txr_lane_tile() { return kTile; }

// src: the 8 field pointers of the state [R] (host array, STATE_KEYS
// order), dst: of the sub-state [C]; lane int64 [C]; counts int32
// [ceil(R / txr_lane_tile())] scratch; live int64 [1].  R >= 1, C >= 1.
// Returns cudaGetLastError() after each launch.
extern "C" int txr_lane_compact(void* const* src, void* const* dst, long long* lane,
                                int* counts, unsigned long long* live, long long R, long long C,
                                void* stream) {
  const State a = make_state(src), b = make_state(dst);
  const unsigned nb = (unsigned)((R + kTile - 1) / kTile);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  lane_count_kernel<<<nb, kThreads, 0, s>>>(a.alive, R, counts, live);
  if (cudaError_t e = cudaGetLastError()) return (int)e;
  lane_compact_kernel<<<nb, kThreads, 0, s>>>(a, b, counts, (int)nb, R, C, lane);
  return (int)cudaGetLastError();
}

// src: the 8 field pointers of the step's new state [C]; lane int64 [C];
// rows: of the state [R] (a lane of R is a fill); live int64 [1], to which
// the live lanes of src at non-fill lanes are added.  C >= 1.
extern "C" int txr_lane_scatter(void* const* src, const long long* lane, void* const* rows,
                                unsigned long long* live, long long R, long long C,
                                void* stream) {
  const State a = make_state(src), b = make_state(rows);
  const unsigned grid = (unsigned)((C + kThreads - 1) / kThreads);
  lane_scatter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a, lane, b, R, C,
                                                                                live);
  return (int)cudaGetLastError();
}
