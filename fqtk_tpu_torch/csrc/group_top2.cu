// Exact top-2 with a register pre-merge over P K tiles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel #6 of scripts/kernel_lab.py: the
// v6_group{P} body `kern` at :360-412 that `make_variant` -> `go_raw`
// launches (pl.pallas_call at :419).  For every read row and column
// position p, the K tiles are taken P at a time (group jb):
//   key_q = count(tile jb*P + q, p) * nt_pow2 + (jb*P + q),  q < P
//   (lo1, lo2) = the register top-2 of the P keys (a min/max ladder)
//   prev = m1[p]; m1[p] = min(prev, lo1)
//   m2[p] = min(m2[p], min(max(prev, lo1), lo2))
// over two int32 streams initialised to 2^30 (count = mismatches against
// the lab table's column, pad columns counting L; nt_pow2 =
// 2^max(1, bitlen(n_k_tiles - 1))); then the emit of :393-412 over
// ext1 = m1[p] * tile_k + p: the exact (best, idx, next) over all k_padded
// columns in (count, index) order, bit for bit
// (lab_kernels.group_top2_reference is the plain version).  Instantiated
// for P = 2, 4 and 8.
//
// Design and bounds: see lab_common.cuh.  The two int32 streams take
// 2 x 32 x 256 x 4 = 64 KB of shared memory per CTA (dynamic, above the
// 48 KB default), and are read and written once per P tiles: per (row,
// column) pair 4/P shared accesses, the ladder's 2-3 min/max in registers,
// and the count's NW broadcast loads and NW AND + POPC.  A model from
// instruction counts, not read from profiler counters: at L = 16 and P 4
// the POPC pipe (8 pairs/clk/SM) binds, as in tile_top2.
//
// Launch contract: launches on the caller's stream, allocates nothing,
// returns cudaGetLastError() (negative on a rejected argument).

#include "lab_common.cuh"

namespace {

using namespace lab;

template <int P, int NW>
__global__ void __launch_bounds__(kThreads)
group_pass1(const uint8_t* __restrict__ obs, int64_t b, int width,
            const uint32_t* __restrict__ bits, int length, int tile_k,
            int n_k_tiles, int nt_pow2, int32_t* __restrict__ partial,
            int64_t n_row_tiles) {
  static_assert(P >= 2 && kChunkTiles % P == 0, "a chunk holds whole groups");
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) uint32_t stage[kChunkTiles * kSlice * NW];
  volatile int32_t* m1 = reinterpret_cast<volatile int32_t*>(smem);
  volatile int32_t* m2 = m1 + kSlice * kThreads;

  const int t = threadIdx.x;
  const int64_t row = (blockIdx.x % n_row_tiles) * kThreads + t;
  const int slice = (int)(blockIdx.x / n_row_tiles);
  const int s0 = slice * kSlice;
  const bool valid = row < b;

  uint32_t oh[NW];
  if (valid) load_onehot<NW>(obs, row, width, length, oh);
#pragma unroll
  for (int p = 0; p < kSlice; ++p) {
    m1[p * kThreads + t] = kMasked;
    m2[p * kThreads + t] = kMasked;
  }

  for (int kb0 = 0; kb0 < n_k_tiles; kb0 += kChunkTiles) {
    // n_k_tiles % P == 0, so every chunk holds whole groups
    const int ct = min(kChunkTiles, n_k_tiles - kb0);
    __syncthreads();  // the previous chunk has been consumed
    stage_chunk<NW>(bits, tile_k, s0, kb0, ct, stage);
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < ct; j += P) {
#pragma unroll 4
      for (int p = 0; p < kSlice; ++p) {
        int32_t key[P];
#pragma unroll
        for (int q = 0; q < P; ++q)
          key[q] = count_of<NW>(oh, stage + ((j + q) * kSlice + p) * NW) *
                       nt_pow2 + (kb0 + j + q);
        int32_t lo1 = min(key[0], key[1]), lo2 = max(key[0], key[1]);
#pragma unroll
        for (int q = 2; q < P; ++q) {
          const int32_t hi = max(lo1, key[q]);
          lo1 = min(lo1, key[q]);
          lo2 = min(lo2, hi);
        }
        const int i = p * kThreads + t;
        const int32_t prev = m1[i];
        m1[i] = min(prev, lo1);
        m2[i] = min((int32_t)m2[i], min(max(prev, lo1), lo2));
      }
    }
  }
  if (!valid) return;
  Top2Keys acc;
#pragma unroll 8
  for (int p = 0; p < kSlice; ++p) {
    acc.add(m1[p * kThreads + t] * tile_k + s0 + p);
    acc.m2c = min(acc.m2c, m2[p * kThreads + t] / nt_pow2);
  }
  store_top2(partial, tile_k / kSlice, slice, b, row, acc);
}

template <int P, int NW>
int launch_group(const uint8_t* obs, int64_t b, int width,
                 const uint32_t* bits, int length, int tile_k, int n_k_tiles,
                 int nt_pow2, int32_t* partial, int64_t n_row_tiles,
                 cudaStream_t s) {
  return launch_pass1(group_pass1<P, NW>, 2 * sizeof(int32_t) * kSlice * kThreads,
                      n_row_tiles, tile_k / kSlice, s, obs, b, width, bits,
                      length, tile_k, n_k_tiles, nt_pow2, partial);
}

template <int P>
int launch_p(int nw, const uint8_t* obs, int64_t b, int width,
             const uint32_t* bits, int length, int tile_k, int n_k_tiles,
             int nt_pow2, int32_t* partial, int64_t n_row_tiles,
             cudaStream_t s) {
#define FQTK_GROUP(N)                                                       \
  return launch_group<P, N>(obs, b, width, bits, length, tile_k, n_k_tiles, \
                            nt_pow2, partial, n_row_tiles, s)
  switch (nw) {
    case 1: FQTK_GROUP(1);
    case 2: FQTK_GROUP(2);
    case 3: FQTK_GROUP(3);
    default: FQTK_GROUP(4);
  }
#undef FQTK_GROUP
}

}  // namespace

extern "C" int fqtk_group_top2(const void* obs, int64_t b, int width,
                               const void* bits, int nw, int length,
                               int tile_k, int n_k_tiles, int group,
                               int nt_pow2, void* partial, void* best,
                               void* idx, void* next, void* stream) {
  int64_t n_row_tiles = 0;
  const int rc = check_args(b, width, bits, nw, length, tile_k, n_k_tiles,
                            &n_row_tiles);
  if (rc != 0) return rc;
  if ((group != 2 && group != 4 && group != 8) || n_k_tiles % group ||
      nt_pow2 < n_k_tiles || (nt_pow2 & (nt_pow2 - 1)))
    return -1;
  const uint8_t* o = static_cast<const uint8_t*>(obs);
  const uint32_t* w = static_cast<const uint32_t*>(bits);
  int32_t* part = static_cast<int32_t*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int e =
      group == 2 ? launch_p<2>(nw, o, b, width, w, length, tile_k, n_k_tiles,
                               nt_pow2, part, n_row_tiles, s)
      : group == 4 ? launch_p<4>(nw, o, b, width, w, length, tile_k,
                                 n_k_tiles, nt_pow2, part, n_row_tiles, s)
                   : launch_p<8>(nw, o, b, width, w, length, tile_k,
                                 n_k_tiles, nt_pow2, part, n_row_tiles, s);
  if (e != 0) return e;
  top2_fold<<<(unsigned)n_row_tiles, kThreads, 0, s>>>(
      part, b, tile_k / kSlice, tile_k, nt_pow2, static_cast<int32_t*>(best),
      static_cast<int32_t*>(idx), static_cast<int32_t*>(next));
  return (int)cudaGetLastError();
}
