// Exact top-2 barcode matcher for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `kernel_colmerge` launched by `run_kernel`
// in fqtk_tpu/ops/pallas_matcher.py (make_kernel_runner).  For every read
// row b of a bit2-packed observation matrix and every whitelist column k < K
// it counts the positions l whose observed base mismatches barcode k, and
// keeps
//   best = min_k count[b, k]
//   idx  = the FIRST k reaching best   (strict <, barcode_matching.rs:132)
//   next = min over k != idx of count[b, k]   (255 when K == 1)
// bit for bit what fqtk_tpu.ops.matcher.assign_batch_np computes.
//
// Inputs
//   obs    [B, W] uint8, W = ceil(L/4): four 2-bit codes (A,C,G,T = 0..3)
//          per byte, lowest bit pair = first position (the native engine's
//          "bit2" layout, fqtk_tpu.ops.device_encoding.unpack_bit2).
//   compat [4L, K_pad] int8, class-major rows c*L + l: 1 iff code c
//          mismatches barcode k at position l (pallas_matcher.py:65-88,
//          before the TPU kernel's ck_s2 scale).  Columns >= K are never
//          read: the ragged K edge is masked here, not by pad values.
//
// Design.  The count is a dot product of the row's one-hot [4L] with a
// compat column; both are 0/1, so it is popcount(onehot_bits & col_bits)
// over ceil(4L/32) 32-bit words.  Each CTA of 256 threads:
//   - prologue: every thread unpacks its row's bit2 codes into the one-hot
//     bitmask (bit c*L + l), held in registers for the whole K walk;
//   - walks ALL of K in ascending tiles of 256 columns (this loop replaces
//     the TPU's sequential grid axis; CTAs run in no order): each thread
//     packs one column of the int8 tile into NW bit words in shared memory,
//     then every thread scores its row against the tile's columns;
//   - keeps per row the two smallest keys (count << shift | column): one
//     min gives (best, first idx), the second-smallest key's count is next.
//     Keys are unique (column in the low bits), so the running update
//     `m2 = min(m2, max(m1, key)); m1 = min(m1, key)` is exact and the
//     merge of two partial (m1, m2) pairs is merge_top2's rule;
//   - with ksplit > 1 (small B: too few row tiles to fill 132 SMs), the
//     CTA's threads split each tile's columns into ksplit groups over the
//     same rows, and the partial pairs merge through shared memory at the
//     end.  All threads of one warp share a column group, so the tile reads
//     are shared-memory broadcasts.
// The B edge is masked in the kernel; the wrapper pads nothing.
//
// Bounds.  At K = 8192, L = 16, B = 131072 the work is 1.07e9 (row, column)
// pairs.  Per pair this kernel issues 2 POPC (16/clk/SM on sm_90), 2 AND,
// an add, the key build and 3 min/max: ~0.6 ms of POPC issue on 132 SMs at
// 1.75 GHz, far above the ~70 us an int8 tensor-core contraction would take
// at 1,979 TOPS.  Device memory is never the bound: ~0.25 B in and 12 B out
// per row, plus compat (0.5 MB at K = 8192, 47 MB at K = 737,280) read per
// CTA from L2.  Tensor-core counting (mma.sync / wgmma), TMA staging and a
// persistent layout are later work.
//
// Launch contract: launches on the caller's stream, allocates nothing,
// returns cudaGetLastError() (negative on a rejected argument).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileK = 256;  // == kThreads: each thread packs one column
constexpr int32_t kMaxCount = 255;
constexpr int32_t kKeyInit = 0x7fffffff;

template <int NW>
__global__ void __launch_bounds__(kThreads)
colmerge_top2_kernel(const uint8_t* __restrict__ obs, int64_t b, int width,
                     const int8_t* __restrict__ compat, int64_t k_pad, int k,
                     int length, int ksplit, int shift,
                     int32_t* __restrict__ best_out,
                     int32_t* __restrict__ idx_out,
                     int32_t* __restrict__ next_out) {
  __shared__ uint32_t tile[kTileK][NW];
  __shared__ int32_t part[2][kThreads];

  const int t = threadIdx.x;
  const int rows_per_cta = kThreads / ksplit;
  const int r = t % rows_per_cta;
  const int g = t / rows_per_cta;  // column group
  const int64_t row = (int64_t)blockIdx.x * rows_per_cta + r;
  const bool valid = row < b;

  // Prologue: bit2 codes -> class-major one-hot bitmask.  The word index is
  // selected by compare so the array stays in registers.
  uint32_t onehot[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) onehot[w] = 0u;
  if (valid) {
    const uint8_t* o = obs + row * (int64_t)width;
    for (int l = 0; l < length; ++l) {
      const int code = (o[l >> 2] >> ((l & 3) * 2)) & 3;
      const int bit = code * length + l;
#pragma unroll
      for (int w = 0; w < NW; ++w)
        onehot[w] |= ((bit >> 5) == w) ? (1u << (bit & 31)) : 0u;
    }
  }

  const int wl = 4 * length;
  int32_t m1 = kKeyInit, m2 = kKeyInit;
  for (int k0 = 0; k0 < k; k0 += kTileK) {
    const int ncols = min(kTileK, k - k0);
    __syncthreads();  // the previous tile has been consumed
    if (t < ncols) {
      const int8_t* src = compat + k0 + t;
#pragma unroll
      for (int w = 0; w < NW; ++w) {
        uint32_t bits = 0u;
#pragma unroll
        for (int jj = 0; jj < 32; ++jj) {
          const int j = w * 32 + jj;
          if (j < wl) bits |= (uint32_t)(src[(int64_t)j * k_pad] != 0) << jj;
        }
        tile[t][w] = bits;
      }
    }
    __syncthreads();
    if (valid) {
      for (int c = g; c < ncols; c += ksplit) {
        int cnt = 0;
#pragma unroll
        for (int w = 0; w < NW; ++w) cnt += __popc(onehot[w] & tile[c][w]);
        const int32_t key = (cnt << shift) | (k0 + c);
        m2 = min(m2, max(m1, key));
        m1 = min(m1, key);
      }
    }
  }

  if (ksplit > 1) {
    part[0][t] = m1;
    part[1][t] = m2;
    __syncthreads();
    if (g == 0) {
      for (int q = 1; q < ksplit; ++q) {
        const int32_t a1 = part[0][q * rows_per_cta + r];
        const int32_t a2 = part[1][q * rows_per_cta + r];
        m2 = min(min(m2, a2), max(m1, a1));
        m1 = min(m1, a1);
      }
    }
  }
  if (valid && g == 0) {
    best_out[row] = min(m1 >> shift, kMaxCount);
    idx_out[row] = m1 & ((1 << shift) - 1);
    next_out[row] = min(m2 >> shift, kMaxCount);
  }
}

template <int NW>
void launch(const uint8_t* obs, int64_t b, int width, const int8_t* compat,
            int64_t k_pad, int k, int length, int ksplit, int shift,
            int32_t* best, int32_t* idx, int32_t* next, cudaStream_t stream) {
  const int rows_per_cta = kThreads / ksplit;
  const int64_t grid = (b + rows_per_cta - 1) / rows_per_cta;
  colmerge_top2_kernel<NW><<<(unsigned)grid, kThreads, 0, stream>>>(
      obs, b, width, compat, k_pad, k, length, ksplit, shift, best, idx, next);
}

}  // namespace

extern "C" int fqtk_colmerge_top2(const void* obs, int64_t b, int width,
                                  const void* compat, int64_t k_pad, int k,
                                  int length, int ksplit, void* best,
                                  void* idx, void* next, void* stream) {
  if (b <= 0 || k < 1 || length < 1 || length > 255 ||
      width != (length + 3) / 4 || k_pad < k ||
      (ksplit != 1 && ksplit != 2 && ksplit != 4 && ksplit != 8))
    return -1;
  int shift = 1;
  while ((1LL << shift) < (long long)k) ++shift;  // column bits
  if (shift > 23) return -2;  // count (8 bits) << shift must stay an int32
  const int64_t grid = (b + kThreads / ksplit - 1) / (kThreads / ksplit);
  if (grid > 0x7fffffffLL) return -3;

  const uint8_t* o = static_cast<const uint8_t*>(obs);
  const int8_t* c = static_cast<const int8_t*>(compat);
  int32_t* pb = static_cast<int32_t*>(best);
  int32_t* pi = static_cast<int32_t*>(idx);
  int32_t* pn = static_cast<int32_t*>(next);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nw = (4 * length + 31) / 32;  // one-hot bit words, 1..32
#define FQTK_LAUNCH(N) \
  launch<N>(o, b, width, c, k_pad, k, length, ksplit, shift, pb, pi, pn, s)
  if (nw <= 1) FQTK_LAUNCH(1);
  else if (nw <= 2) FQTK_LAUNCH(2);
  else if (nw <= 3) FQTK_LAUNCH(3);
  else if (nw <= 4) FQTK_LAUNCH(4);
  else if (nw <= 6) FQTK_LAUNCH(6);
  else if (nw <= 8) FQTK_LAUNCH(8);
  else if (nw <= 16) FQTK_LAUNCH(16);
  else FQTK_LAUNCH(32);
#undef FQTK_LAUNCH
  return (int)cudaGetLastError();
}
