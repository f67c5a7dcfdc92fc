// Exact-for-gating top-2 over int16 clamped keys for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel #5 of scripts/kernel_lab.py: the
// v5_clamp16 body `kern` at :263-307 that `make_variant` -> `go_raw`
// launches (pl.pallas_call at :314).  For every read row, K tile kb and
// column position p, with count = mismatches against column kb * tile_k + p
// of the lab's table (pad columns count L):
//   key = min(count, W) * nt_pow2 + kb        (int16; W = max_mm +
//         max(delta, 1) + 1, nt_pow2 = 2^max(1, bitlen(n_k_tiles - 1)))
//   prev = m1[p]; m1[p] = min(prev, key); m2[p] = min(m2[p], max(prev, key))
// over two int16 streams initialised to W * nt_pow2 + nt_pow2 - 1; then the
// emit of :290-307 over ext1 = m1[p] * tile_k + p: best, idx and next with
// counts clamped at W, bit for bit (lab_kernels.clamp16_top2_reference is
// the plain version).  Clamping never changes a gate decision or the
// winning index (docs/DESIGN.md).
//
// Design and bounds: see lab_common.cuh.  The two int16 streams take
// 2 x 32 x 256 x 2 = 32 KB of shared memory per CTA; each step is two
// shared loads and two stores of 16 bits per (row, column) pair, beside the
// NW broadcast loads and NW AND + POPC of the count.  A model from
// instruction counts, not read from profiler counters: at L = 16 that is
// five shared-memory warp accesses per 32 pairs against two POPC per pair,
// so the shared pipe and the POPC pipe (8 pairs/clk/SM) bind about equally.
// Packing two positions' keys per 32-bit word (__vminu2 / __vmaxu2) would
// halve the shared accesses: later work.
//
// Launch contract: launches on the caller's stream, allocates nothing,
// returns cudaGetLastError() (negative on a rejected argument).

#include "lab_common.cuh"

namespace {

using namespace lab;

template <int NW>
__global__ void __launch_bounds__(kThreads)
clamp16_pass1(const uint8_t* __restrict__ obs, int64_t b, int width,
              const uint32_t* __restrict__ bits, int length, int tile_k,
              int n_k_tiles, int w_clamp, int nt_pow2,
              int32_t* __restrict__ partial, int64_t n_row_tiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) uint32_t stage[kChunkTiles * kSlice * NW];
  volatile int16_t* m1 = reinterpret_cast<volatile int16_t*>(smem);
  volatile int16_t* m2 = m1 + kSlice * kThreads;

  const int t = threadIdx.x;
  const int64_t row = (blockIdx.x % n_row_tiles) * kThreads + t;
  const int slice = (int)(blockIdx.x / n_row_tiles);
  const int s0 = slice * kSlice;
  const bool valid = row < b;

  uint32_t oh[NW];
  if (valid) load_onehot<NW>(obs, row, width, length, oh);
  const int16_t kinit = (int16_t)(w_clamp * nt_pow2 + nt_pow2 - 1);
#pragma unroll
  for (int p = 0; p < kSlice; ++p) {
    m1[p * kThreads + t] = kinit;
    m2[p * kThreads + t] = kinit;
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
        const int cnt = count_of<NW>(oh, cols + p * NW);
        const int32_t key = min(cnt, w_clamp) * nt_pow2 + kb;
        const int i = p * kThreads + t;
        const int32_t prev = m1[i];
        m1[i] = (int16_t)min(prev, key);
        m2[i] = (int16_t)min((int32_t)m2[i], max(prev, key));
      }
    }
  }
  if (!valid) return;
  Top2Keys acc;
#pragma unroll 8
  for (int p = 0; p < kSlice; ++p) {
    acc.add((int32_t)m1[p * kThreads + t] * tile_k + s0 + p);
    acc.m2c = min(acc.m2c, (int32_t)m2[p * kThreads + t] / nt_pow2);
  }
  store_top2(partial, tile_k / kSlice, slice, b, row, acc);
}

template <int NW>
int launch_clamp16(const uint8_t* obs, int64_t b, int width,
                   const uint32_t* bits, int length, int tile_k,
                   int n_k_tiles, int w_clamp, int nt_pow2, int32_t* partial,
                   int64_t n_row_tiles, cudaStream_t s) {
  return launch_pass1(clamp16_pass1<NW>, 2 * sizeof(int16_t) * kSlice * kThreads,
                      n_row_tiles, tile_k / kSlice, s, obs, b, width, bits,
                      length, tile_k, n_k_tiles, w_clamp, nt_pow2, partial);
}

}  // namespace

extern "C" int fqtk_clamp16_top2(const void* obs, int64_t b, int width,
                                 const void* bits, int nw, int length,
                                 int tile_k, int n_k_tiles, int w_clamp,
                                 int nt_pow2, void* partial, void* best,
                                 void* idx, void* next, void* stream) {
  int64_t n_row_tiles = 0;
  const int rc = check_args(b, width, bits, nw, length, tile_k, n_k_tiles,
                            &n_row_tiles);
  if (rc != 0) return rc;
  if (w_clamp < 1 || nt_pow2 < n_k_tiles || (nt_pow2 & (nt_pow2 - 1)) ||
      (int64_t)w_clamp * nt_pow2 + nt_pow2 - 1 >= (1 << 15))
    return -1;
  const uint8_t* o = static_cast<const uint8_t*>(obs);
  const uint32_t* w = static_cast<const uint32_t*>(bits);
  int32_t* part = static_cast<int32_t*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e = 0;
#define FQTK_CLAMP16(N)                                                     \
  e = launch_clamp16<N>(o, b, width, w, length, tile_k, n_k_tiles, w_clamp, \
                        nt_pow2, part, n_row_tiles, s)
  switch (nw) {
    case 1: FQTK_CLAMP16(1); break;
    case 2: FQTK_CLAMP16(2); break;
    case 3: FQTK_CLAMP16(3); break;
    default: FQTK_CLAMP16(4); break;
  }
#undef FQTK_CLAMP16
  if (e != 0) return e;
  top2_fold<<<(unsigned)n_row_tiles, kThreads, 0, s>>>(
      part, b, tile_k / kSlice, tile_k, nt_pow2, static_cast<int32_t*>(best),
      static_cast<int32_t*>(idx), static_cast<int32_t*>(next));
  return (int)cudaGetLastError();
}
