// Exact top-2 barcode matcher for Hopper (sm_90a), with K split across CTAs.
//
// Replaces the Pallas TPU kernel `kernel`, the per-step lane-reduce body that
// `run_kernel` launches in fqtk_tpu/ops/pallas_matcher.py:285 (call :462)
// wherever plan_local_kernel turns the column-merge scheme off; on the
// device path (tile_k 2048, int8) that is K above 4,194,304.  It
// computes the function of csrc/colmerge_top2.cu: for every read row b and
// every whitelist column k < K, the number of positions l whose observed
// base mismatches barcode k, reduced to
//   best = min_k count[b, k]
//   idx  = the FIRST k reaching best   (strict <, barcode_matching.rs:132)
//   next = min over k != idx of count[b, k]   (255 when K == 1)
// bit for bit what fqtk_tpu.ops.matcher.assign_batch_np computes.
//
// Inputs
//   obs  [B, W] uint8, W = ceil(L/4): four 2-bit codes (A,C,G,T = 0..3) per
//        byte, lowest bit pair = first position (the native engine's "bit2").
//   bits [K_pad, NW] uint32, NW = ceil(4L/32): bit (c*L + l) of column k's
//        words is 1 iff code c mismatches barcode k at position l (the
//        class-major int8 table of pallas_matcher.py:65-88, packed once when
//        the state is built).  K_pad is a multiple of 4; columns >= K are
//        never read: the ragged K edge is masked here, not by pad values.
//   partial [n_tiles, B] uint32 scratch (the wrapper allocates it).
//
// Design.  The TPU kernel walks K tiles in order on one core, carrying a
// running (best, idx, next) in VMEM.  Here the K tiles are independent CTAs:
//   Pass 1.  CTA = 256 rows (one per thread) x one K tile of 8,192 columns.
//     The grid is flattened with the row tile fastest, so the CTAs in flight
//     share a K tile and its bits stay in L2.  Each thread unpacks its row's
//     bit2 codes into the one-hot bitmask (bit c*L + l) held in registers.
//     The K tile is staged from `bits` into shared memory in 16 KB stages
//     with coalesced 16-byte loads; every thread then scores its row against
//     each staged column as popcount(onehot & column) over NW words (all
//     lanes of a warp read the same column: shared-memory broadcasts).  Per
//     row it keeps the two smallest keys (count << 13 | local column).  Keys
//     are unique within the tile, so `m2 = min(m2, max(m1, key)); m1 =
//     min(m1, key)` is exact and the first index wins.  One uint32 per
//     (tile, row): (m1 << 8) | min(count of m2, 255).
//   Pass 2.  One thread per row walks the tiles in ascending order and
//     applies the TPU kernel's ordered merge (pallas_matcher.py:360-367):
//     take = tile_best < best; next = take ? min(best, tile_next)
//     : min(next, tile_best).  Strict <, so the earlier tile wins ties.
// No global column bits are in the key, so K is bounded only by the int32
// idx and by the flattened grid (row tiles x K tiles < 2^31).
//
// Bounds on this card (a model from instruction counts, not read from
// profiler counters).  Per (row, column) pair pass 1 issues NW shared-memory
// loads (broadcast), NW ANDs, NW POPCs, an add, the key build and three
// min/max.  POPC runs at 16/clk/SM, the other integer ops at 64/clk/SM and
// in parallel with it, so the POPC pipe (8 pairs/clk/SM at NW 2) is
// expected to bound pass 1 before issue does (~11 pairs/clk/SM): at
// K = 6,794,880, L = 16, B = 16,384 (1.1e11 pairs) ~53 ms on 132 SMs at
// 1.98 GHz.  Memory moves ~3.5 GB (the 54 MB bit table once per row tile,
// mostly from L2) plus 4 B per (tile, row) of partials: ~1 ms at 3.35 TB/s.
// So it should be bound by integer issue, not by HBM.
// What the design does about it: the one-hot lives in registers, the table
// is packed once in the state (colmerge_top2 re-packs its tile in every CTA),
// column reads are broadcasts with no bank conflicts, the top-2 update is
// branch-free, and K is spread over CTAs so every SM is busy for any B >= 256.
// Later work: fold the NW AND results into one word before a single POPC
// where the bit layout keeps positions apart (L = 16 halves the POPCs),
// tensor-core counting (mma.sync / wgmma) and cp.async / TMA staging.
//
// Launch contract: launches on the caller's stream, allocates nothing,
// returns cudaGetLastError() (negative on a rejected argument).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;           // rows per CTA, one per thread
constexpr int kTileBits = 13;
constexpr int kTileK = 1 << kTileBits;  // columns per CTA (the K tile)
constexpr int kStageWords = 4096;       // 16 KB of bit words per stage
constexpr int32_t kMaxCount = 255;
constexpr int32_t kKeyInit = 0x7fffffff;

template <int NWT>
__global__ void __launch_bounds__(kThreads)
tile_top2_pass1(const uint8_t* __restrict__ obs, int64_t b, int width,
                const uint32_t* __restrict__ bits, int nw, int k, int length,
                int64_t n_row_tiles, uint32_t* __restrict__ partial) {
  // columns per stage: a multiple of 4, so every stage starts 16-byte aligned
  constexpr int kStageCols = (kStageWords / NWT) & ~3;
  __shared__ __align__(16) uint32_t stage[kStageCols * NWT];

  const int t = threadIdx.x;
  const int64_t row_tile = blockIdx.x % n_row_tiles;
  const int64_t k_tile = blockIdx.x / n_row_tiles;
  const int64_t row = row_tile * kThreads + t;
  const bool valid = row < b;
  const int64_t k0 = k_tile * kTileK;
  const int64_t rest = (int64_t)k - k0;
  const int ncols = rest < kTileK ? (int)rest : kTileK;

  // Prologue: bit2 codes -> class-major one-hot bitmask.  The word index is
  // selected by compare so the array stays in registers.  Words >= nw stay
  // 0, so the unwritten pad words of a stage never count.
  uint32_t onehot[NWT];
#pragma unroll
  for (int w = 0; w < NWT; ++w) onehot[w] = 0u;
  if (valid) {
    const uint8_t* o = obs + row * (int64_t)width;
    for (int l = 0; l < length; ++l) {
      const int code = (o[l >> 2] >> ((l & 3) * 2)) & 3;
      const int bit = code * length + l;
#pragma unroll
      for (int w = 0; w < NWT; ++w)
        onehot[w] |= ((bit >> 5) == w) ? (1u << (bit & 31)) : 0u;
    }
  }

  int32_t m1 = kKeyInit, m2 = kKeyInit;
  for (int c0 = 0; c0 < ncols; c0 += kStageCols) {
    const int nsub = min(kStageCols, ncols - c0);
    const int nwords = nsub * nw;
    // rounding nwords up to whole uint4s stays inside the table: the start
    // is a multiple of 4 words and K_pad * nw is too
    const uint4* src = reinterpret_cast<const uint4*>(bits + (k0 + c0) * nw);
    __syncthreads();  // the previous stage has been consumed
    for (int q = t; q * 4 < nwords; q += kThreads) {
      const uint4 v = src[q];
      if (nw == NWT) {
        reinterpret_cast<uint4*>(stage)[q] = v;
      } else {  // re-stride columns from nw to NWT words
        const uint32_t vw[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int i = q * 4 + j;
          if (i < nwords) {
            const int c = i / nw;
            stage[c * NWT + (i - c * nw)] = vw[j];
          }
        }
      }
    }
    __syncthreads();
    if (valid) {
#pragma unroll 4
      for (int c = 0; c < nsub; ++c) {
        int cnt = 0;
#pragma unroll
        for (int w = 0; w < NWT; ++w)
          cnt += __popc(onehot[w] & stage[c * NWT + w]);
        const int32_t key = (cnt << kTileBits) | (c0 + c);
        m2 = min(m2, max(m1, key));
        m1 = min(m1, key);
      }
    }
  }
  // every tile has >= 1 column, so m1 is a real key (< 2^21); m2 stays
  // kKeyInit for a one-column tile and clamps to 255
  if (valid)
    partial[k_tile * b + row] =
        ((uint32_t)m1 << 8) | (uint32_t)min(m2 >> kTileBits, kMaxCount);
}

__global__ void __launch_bounds__(kThreads)
tile_top2_pass2(const uint32_t* __restrict__ partial, int64_t b, int n_tiles,
                int k, int32_t* __restrict__ best_out,
                int32_t* __restrict__ idx_out,
                int32_t* __restrict__ next_out) {
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (row >= b) return;
  int32_t a_best = kMaxCount, a_idx = k, a_next = kMaxCount;
  const uint32_t* p = partial + row;
#pragma unroll 8
  for (int t = 0; t < n_tiles; ++t) {
    const uint32_t v = p[(int64_t)t * b];
    const int32_t t_best = (int32_t)(v >> (kTileBits + 8));
    const int32_t t_idx = t * kTileK + (int32_t)((v >> 8) & (kTileK - 1));
    const int32_t t_next = (int32_t)(v & 0xffu);
    const bool take = t_best < a_best;
    a_next = take ? min(a_best, t_next) : min(a_next, t_best);
    a_idx = take ? t_idx : a_idx;
    a_best = take ? t_best : a_best;
  }
  best_out[row] = a_best;
  idx_out[row] = a_idx;
  next_out[row] = a_next;
}

template <int NWT>
void launch_pass1(const uint8_t* obs, int64_t b, int width,
                  const uint32_t* bits, int nw, int k, int length,
                  int64_t n_row_tiles, int64_t n_k_tiles, uint32_t* partial,
                  cudaStream_t stream) {
  tile_top2_pass1<NWT><<<(unsigned)(n_row_tiles * n_k_tiles), kThreads, 0,
                         stream>>>(obs, b, width, bits, nw, k, length,
                                   n_row_tiles, partial);
}

}  // namespace

extern "C" int fqtk_tile_top2(const void* obs, int64_t b, int width,
                              const void* bits, int64_t k_pad, int nw, int k,
                              int length, void* partial, void* best,
                              void* idx, void* next, void* stream) {
  if (b <= 0 || k < 1 || length < 1 || length > 255 ||
      width != (length + 3) / 4 || nw != (4 * length + 31) / 32 ||
      k_pad < k || k_pad % 4 != 0)
    return -1;
  if ((reinterpret_cast<uintptr_t>(bits) & 15u) != 0) return -2;
  const int64_t n_row_tiles = (b + kThreads - 1) / kThreads;
  const int64_t n_k_tiles = ((int64_t)k + kTileK - 1) / kTileK;
  if (n_row_tiles * n_k_tiles > 0x7fffffffLL) return -3;

  const uint8_t* o = static_cast<const uint8_t*>(obs);
  const uint32_t* w = static_cast<const uint32_t*>(bits);
  uint32_t* part = static_cast<uint32_t*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FQTK_LAUNCH(N) \
  launch_pass1<N>(o, b, width, w, nw, k, length, n_row_tiles, n_k_tiles, part, s)
  if (nw <= 1) FQTK_LAUNCH(1);
  else if (nw <= 2) FQTK_LAUNCH(2);
  else if (nw <= 3) FQTK_LAUNCH(3);
  else if (nw <= 4) FQTK_LAUNCH(4);
  else if (nw <= 6) FQTK_LAUNCH(6);
  else if (nw <= 8) FQTK_LAUNCH(8);
  else if (nw <= 16) FQTK_LAUNCH(16);
  else FQTK_LAUNCH(32);
#undef FQTK_LAUNCH
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  tile_top2_pass2<<<(unsigned)n_row_tiles, kThreads, 0, s>>>(
      part, b, (int)n_k_tiles, k, static_cast<int32_t*>(best),
      static_cast<int32_t*>(idx), static_cast<int32_t*>(next));
  return (int)cudaGetLastError();
}
