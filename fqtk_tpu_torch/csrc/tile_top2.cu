// Exact top-2 barcode matcher for Hopper (sm_90a), with K split across CTAs:
// the per-tile reduce and ordered merge.
//
// Replaces the Pallas TPU kernel `kernel`, the per-step lane-reduce body that
// `run_kernel` launches in fqtk_tpu/ops/pallas_matcher.py:285-371
// (pl.pallas_call at :462) wherever plan_local_kernel turns the column-merge
// scheme off; on the device path (tile_k 2048, int8) that is K above
// 4,194,304, e.g. the 6,794,880-barcode single-cell whitelist.  It computes
// the function of csrc/colmerge_top2.cu: for every read row b and every
// whitelist column k < K, the number of positions l whose observed base
// mismatches barcode k, reduced to
//   best = min_k count[b, k]
//   idx  = the FIRST k reaching best   (strict <, barcode_matching.rs:132)
//   next = min over k != idx of count[b, k]   (255 when K == 1)
// bit for bit what the NumPy spec assign_batch_np computes.
//
// Like the TPU body it reduces each K tile to (best, first idx, next) with a
// key that holds only the column INSIDE the tile, and merges the tiles in
// ascending order with the TPU kernel's rule (pallas_matcher.py:360-367):
//   take = tile_best < best; next = take ? min(best, tile_next)
//   : min(next, tile_best)   (strict <: the earlier tile wins ties).
// No global column is in a key, so K is bounded only by the int32 idx.
// The TPU walks its tiles in order on one core; here a tile is the column
// range of one CTA (`cols_per_cta`, a multiple of 128, at most 2^23 so that
// count << shift | local column stays an int32), the tiles run in parallel,
// and pass 2 is the ordered merge over `partial` [2, n_tiles, B] int32
// (smallest key; count of the second smallest).
//
// Inputs (csrc/mma_count.cuh has the layouts): obs [B, ceil(L/4)] uint8
// bit2 rows (classes = 4), or [B, ceil(L/2)] nib4 masks (classes = 16: the
// TPU kernel's 16-class input, packed_masks=True and its raw-byte default);
// table: the [K_pad, KP] int8 mismatch table in the tiled order the product
// reads, packed once when the state is built: 435 MB at K = 6,794,880,
// L = 16 (1.74 GB at 16 classes).  It no longer fits the 50 MB L2, so
// blockIdx runs over the row tiles of one K tile first: the CTAs in flight
// walk the same columns at the same time, the table comes from HBM once per
// wave (0.13 ms at 3.35 TB/s) and from L2 once per CTA.
//
// What bounds it on this card: operations, 2 * B * K * KP int8 against
// 1,979 TOP/s (7.2 ms at K = 6,794,880, B = 16,384, KP = 64); bytes are
// under 1% of that.  The previous design counted by POPC at 8 pairs per
// clock and SM (56.7 ms at that shape) with the tensor cores idle.  What the
// design does about it is the engine of csrc/mma_count.cuh: wgmma.m64n128k32
// counting from a ring of bulk copies, and a top-2 that builds keys only where a
// three-input-minimum test over the raw counts says a key can change the
// row's pair.
//
// Launch contract: launches on the caller's stream, allocates nothing,
// returns cudaGetLastError() (negative on a rejected argument).

#include "mma_count.cuh"

namespace {

using namespace mmac;

// Pass 1: keys hold the column inside the tile; a row writes its smallest
// key and the count of its second.
struct TileScheme {
  static constexpr bool kLocalKeys = true;
  static __device__ __forceinline__ void emit(const Pass1Args& a, int64_t tile,
                                              int64_t row, int32_t m1,
                                              int32_t m2) {
    // every tile has >= 1 column < K, so m1 is a real key; m2 stays
    // kKeyInit for a one-column tile and clamps to 255
    a.partial[tile * a.b + row] = m1;
    a.partial[((int64_t)a.n_chunks + tile) * a.b + row] =
        min(m2 >> a.shift, kMaxCount);
  }
};

__global__ void __launch_bounds__(256)
tile_top2_pass2(const int32_t* __restrict__ partial, int64_t b, int n_tiles,
                int64_t cols_per_cta, int shift, int32_t k,
                int32_t* __restrict__ best_out, int32_t* __restrict__ idx_out,
                int32_t* __restrict__ next_out) {
  const int64_t row = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (row >= b) return;
  // best starts above any count: the first tile is always taken
  int32_t a_best = kMaxCount + 1, a_idx = k, a_next = kMaxCount;
#pragma unroll 4
  for (int t = 0; t < n_tiles; ++t) {
    const int32_t m1 = partial[(int64_t)t * b + row];
    const int32_t t_next = partial[((int64_t)n_tiles + t) * b + row];
    const int32_t t_best = m1 >> shift;
    const int32_t t_idx =
        (int32_t)(t * cols_per_cta) + (m1 & ((1 << shift) - 1));
    const bool take = t_best < a_best;
    a_next = take ? min(a_best, t_next) : min(a_next, t_best);
    a_idx = take ? t_idx : a_idx;
    a_best = take ? t_best : a_best;
  }
  best_out[row] = a_best;
  idx_out[row] = a_idx;
  next_out[row] = a_next;
}

}  // namespace

extern "C" int fqtk_tile_top2(const void* obs, int64_t b, int width,
                              const void* table, int64_t k_pad, int kp,
                              int64_t k, int length, int classes, int n_tiles,
                              int64_t cols_per_cta, void* partial, void* best,
                              void* idx, void* next, void* stream) {
  const int bad = check_args(b, width, table, k_pad, kp, k, length, classes,
                             n_tiles, cols_per_cta);
  if (bad != 0) return bad;
  if (k > 0x7fffffffLL || cols_per_cta > (1 << 23) || partial == nullptr)
    return -1;
  int shift = 7;
  while ((1LL << shift) < cols_per_cta) ++shift;  // local column bits, <= 23

  int32_t* pp = static_cast<int32_t*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Pass1Args args{static_cast<const uint8_t*>(obs), b, width, length,
                       static_cast<const uint8_t*>(table), kp, k, cols_per_cta,
                       (b + kRows - 1) / kRows, n_tiles, shift, pp,
                       nullptr, nullptr, nullptr};
  const cudaError_t e = launch_pass1<TileScheme>(args, classes, s);
  if (e != cudaSuccess) return (int)e;
  tile_top2_pass2<<<(unsigned)((b + 255) / 256), 256, 0, s>>>(
      pp, b, n_tiles, cols_per_cta, shift, (int32_t)k,
      static_cast<int32_t*>(best), static_cast<int32_t*>(idx),
      static_cast<int32_t*>(next));
  return (int)cudaGetLastError();
}

// What the card makes of the sliced walk's pass-1 instantiation a launch
// at (classes, kp > 128) runs: 6 int32 to `out` (registers, static and
// dynamic shared bytes, CTAs an SM holds, local bytes, ring stages;
// walk_info_at in mma_count.cuh).  0, -1 for a depth the walk does not
// take, else the CUDA error.
extern "C" int fqtk_tile_top2_walk_info(int classes, int kp, void* out) {
  return walk_info<TileScheme>(classes, kp, static_cast<int32_t*>(out));
}
