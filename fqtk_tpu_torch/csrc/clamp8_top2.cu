// Exact-for-gating top-2 over int8 clamped counts for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel #7 of scripts/kernel_lab.py: the
// v3_clamp8 / v3w_clamp8 body `kern` at :453-508 that `make_variant` ->
// `go_raw` launches (pl.pallas_call at :515).  For every read row, K tile
// kb and column position p, with count = mismatches against column
// kb * tile_k + p of the lab's table (pad columns count L):
//   c8 = min(count, W)   (W = max_mm + max(delta, 1) + 1)
//   prev = m1[p]; better = c8 < prev
//   m1[p] = better ? c8 : prev; t1[p] = better ? kb : t1[p]
//   m2[p] = min(m2[p], max(prev, c8))
// over two int8 streams initialised to W and a uint8 first-tile stream
// initialised to 0 (at most 255 K tiles); then the emit of :484-508 over
// ext1 = (m1[p] * nt_pow2 + t1[p]) * tile_k + p: best, idx and next with
// counts clamped at W, bit for bit (lab_kernels.clamp8_top2_reference is
// the plain version).  v3w_clamp8 differs from v3_clamp8 on the TPU only in
// the MXU's output type (int8 instead of int32); counting here is by POPC,
// which has no such type, so both names run this kernel.
//
// Design and bounds: see lab_common.cuh.  The three byte streams take
// 3 x 32 x 256 = 24 KB of shared memory per CTA; each step is three shared
// loads and three stores per (row, column) pair, beside the count's NW
// broadcast loads and NW AND + POPC.  A model from instruction counts, not
// read from profiler counters: at L = 16 that is seven shared-memory warp
// accesses per 32 pairs, so the shared pipe (one warp-wide access per
// clock, ~4.6 pairs/clk/SM) binds before the POPC pipe (8 pairs/clk/SM):
// narrowing a stream to a byte saves bytes but not instructions while each
// thread holds one element per access.  Packing four positions per 32-bit
// word (__vminu4-style SIMD) is later work.
//
// Launch contract: launches on the caller's stream, allocates nothing,
// returns cudaGetLastError() (negative on a rejected argument).

#include "lab_common.cuh"

namespace {

using namespace lab;

template <int NW>
__global__ void __launch_bounds__(kThreads)
clamp8_pass1(const uint8_t* __restrict__ obs, int64_t b, int width,
             const uint32_t* __restrict__ bits, int length, int tile_k,
             int n_k_tiles, int w_clamp, int nt_pow2,
             int32_t* __restrict__ partial, int64_t n_row_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) uint32_t stage[kChunkTiles * kSlice * NW];
  volatile int8_t* m1 = reinterpret_cast<volatile int8_t*>(smem);
  volatile int8_t* m2 = m1 + kSlice * kThreads;
  volatile uint8_t* t1 = reinterpret_cast<volatile uint8_t*>(m2 + kSlice * kThreads);

  const int t = threadIdx.x;
  const int64_t row = (blockIdx.x % n_row_tiles) * kThreads + t;
  const int slice = (int)(blockIdx.x / n_row_tiles);
  const int s0 = slice * kSlice;
  const bool valid = row < b;

  uint32_t oh[NW];
  if (valid) load_onehot<NW>(obs, row, width, length, oh);
#pragma unroll
  for (int p = 0; p < kSlice; ++p) {
    m1[p * kThreads + t] = (int8_t)w_clamp;
    m2[p * kThreads + t] = (int8_t)w_clamp;
    t1[p * kThreads + t] = 0;
  }

  for (int kb0 = 0; kb0 < n_k_tiles; kb0 += kChunkTiles) {
    const int ct = min(kChunkTiles, n_k_tiles - kb0);
    __syncthreads();  // the previous chunk has been consumed
    stage_chunk<NW>(bits, tile_k, s0, kb0, ct, stage);
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < ct; ++j) {
      const int kb = kb0 + j;
      const uint32_t* cols = stage + j * kSlice * NW;
#pragma unroll 8
      for (int p = 0; p < kSlice; ++p) {
        const int32_t c8 = min(count_of<NW>(oh, cols + p * NW), w_clamp);
        const int i = p * kThreads + t;
        const int32_t prev = m1[i];
        const uint8_t tprev = t1[i];
        const bool better = c8 < prev;
        m1[i] = (int8_t)(better ? c8 : prev);
        t1[i] = better ? (uint8_t)kb : tprev;
        m2[i] = (int8_t)min((int32_t)m2[i], max(prev, c8));
      }
    }
  }
  if (!valid) return;
  Top2Keys acc;
#pragma unroll 8
  for (int p = 0; p < kSlice; ++p) {
    const int i = p * kThreads + t;
    acc.add(((int32_t)m1[i] * nt_pow2 + (int32_t)t1[i]) * tile_k + s0 + p);
    acc.m2c = min(acc.m2c, (int32_t)m2[i]);
  }
  store_top2(partial, tile_k / kSlice, slice, b, row, acc);
}

template <int NW>
int launch_clamp8(const uint8_t* obs, int64_t b, int width,
                  const uint32_t* bits, int length, int tile_k,
                  int n_k_tiles, int w_clamp, int nt_pow2, int32_t* partial,
                  int64_t n_row_tiles, cudaStream_t s) {
  return launch_pass1(clamp8_pass1<NW>, 3 * kSlice * kThreads, n_row_tiles,
                      tile_k / kSlice, s, obs, b, width, bits, length, tile_k,
                      n_k_tiles, w_clamp, nt_pow2, partial);
}

}  // namespace

extern "C" int fqtk_clamp8_top2(const void* obs, int64_t b, int width,
                                const void* bits, int nw, int length,
                                int tile_k, int n_k_tiles, int w_clamp,
                                int nt_pow2, void* partial, void* best,
                                void* idx, void* next, void* stream) {
  int64_t n_row_tiles = 0;
  const int rc = check_args(b, width, bits, nw, length, tile_k, n_k_tiles,
                            &n_row_tiles);
  if (rc != 0) return rc;
  if (w_clamp < 1 || w_clamp > 127 || n_k_tiles > 255 ||
      nt_pow2 < n_k_tiles || (nt_pow2 & (nt_pow2 - 1)))
    return -1;
  const uint8_t* o = static_cast<const uint8_t*>(obs);
  const uint32_t* w = static_cast<const uint32_t*>(bits);
  int32_t* part = static_cast<int32_t*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e = 0;
#define FQTK_CLAMP8(N)                                                      \
  e = launch_clamp8<N>(o, b, width, w, length, tile_k, n_k_tiles, w_clamp,  \
                       nt_pow2, part, n_row_tiles, s)
  switch (nw) {
    case 1: FQTK_CLAMP8(1); break;
    case 2: FQTK_CLAMP8(2); break;
    case 3: FQTK_CLAMP8(3); break;
    default: FQTK_CLAMP8(4); break;
  }
#undef FQTK_CLAMP8
  if (e != 0) return e;
  top2_fold<<<(unsigned)n_row_tiles, kThreads, 0, s>>>(
      part, b, tile_k / kSlice, tile_k, nt_pow2, static_cast<int32_t*>(best),
      static_cast<int32_t*>(idx), static_cast<int32_t*>(next));
  return (int)cudaGetLastError();
}
