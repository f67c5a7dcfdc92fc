// Exact top-2 barcode matcher for Hopper (sm_90a): the column-merge scheme.
//
// Replaces the Pallas TPU kernel `kernel_colmerge` launched by `run_kernel`
// in fqtk_tpu/ops/pallas_matcher.py:373-440 (pl.pallas_call at :462): the
// body the JAX package runs where plan_local_kernel keeps the column-merge
// top-2, up to K = 4,194,304 on the device path.  For every read row b of a
// bit2-packed observation matrix and every whitelist column k < K it counts
// the positions l whose observed base mismatches barcode k, and keeps
//   best = min_k count[b, k]
//   idx  = the FIRST k reaching best   (strict <, barcode_matching.rs:132)
//   next = min over k != idx of count[b, k]   (255 when K == 1)
// bit for bit what the NumPy spec assign_batch_np computes.
//
// Like the TPU body, it counts on the matrix unit and carries the column
// through the key: key = count << shift | GLOBAL column (shift = bits of K,
// so K <= 2^23 keeps the key an int32).  Keys are unique over all of K, so
// the pairs (m1, m2) of two column ranges merge in any order:
//   m2 = min(min(m2, o2), max(m1, o1)); m1 = min(m1, o1).
//
// Inputs (csrc/mma_count.cuh has the layouts): obs [B, ceil(L/4)] uint8
// bit2 rows (classes = 4), or [B, ceil(L/2)] nib4 masks (classes = 16: the
// counterpart of the TPU kernel's 16-class input, packed_masks=True and its
// raw-byte default); table: the [K_pad, KP] int8 mismatch table in the tiled order
// the product reads, packed once when the state is built (the previous
// design re-packed every 256-column tile of a [4L, K_pad] table in every
// CTA: 59 ms per call at K = 737,280 whatever B).
//
// What bounds it on this card: operations, 2 * B * K * KP int8 against
// 1,979 TOP/s; bytes (rows in, the table once, 12 B per row out) are under
// 1% of that.  What the design does about it is the engine of
// csrc/mma_count.cuh: wgmma.m64n128k32 counting from a ring of bulk copies, and a
// top-2 that builds keys only where a three-input-minimum test over the raw
// counts says a key can change the row's pair.
//
// Grid.  CTA = 128 rows x one of `n_chunks` column ranges of `cols_per_cta`
// columns (a multiple of 128; the wrapper picks n_chunks > 1 only where the
// row tiles alone do not fill the SMs, never for a small K: the 96-sample
// demux launches 64 CTAs of one sub-tile each).  With one chunk the CTA
// writes (best, idx, next) itself; otherwise it writes its rows' (m1, m2)
// to `partial` [2, n_chunks, B] int32 and a second pass merges the chunks.
//
// Launch contract: launches on the caller's stream, allocates nothing,
// returns cudaGetLastError() (negative on a rejected argument).

#include "mma_count.cuh"

namespace {

using namespace mmac;

// Pass 1: keys hold the global column; with one chunk a row writes its
// result itself, else its pair for pass 2.
struct ColmergeScheme {
  static constexpr bool kLocalKeys = false;
  static __device__ __forceinline__ void emit(const Pass1Args& a, int64_t chunk,
                                              int64_t row, int32_t m1,
                                              int32_t m2) {
    if (a.n_chunks == 1) {
      a.best[row] = min(m1 >> a.shift, kMaxCount);
      a.idx[row] = m1 & ((1 << a.shift) - 1);
      a.next[row] = min(m2 >> a.shift, kMaxCount);
    } else {
      a.partial[chunk * a.b + row] = m1;
      a.partial[((int64_t)a.n_chunks + chunk) * a.b + row] = m2;
    }
  }
};

__global__ void __launch_bounds__(256)
colmerge_top2_pass2(const int32_t* __restrict__ partial, int64_t b,
                    int n_chunks, int shift, int32_t* __restrict__ best_out,
                    int32_t* __restrict__ idx_out,
                    int32_t* __restrict__ next_out) {
  const int64_t row = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (row >= b) return;
  int32_t m1 = kKeyInit, m2 = kKeyInit;
  for (int c = 0; c < n_chunks; ++c) {
    const int32_t o1 = partial[(int64_t)c * b + row];
    const int32_t o2 = partial[((int64_t)n_chunks + c) * b + row];
    m2 = min(min(m2, o2), max(m1, o1));
    m1 = min(m1, o1);
  }
  best_out[row] = min(m1 >> shift, kMaxCount);
  idx_out[row] = m1 & ((1 << shift) - 1);
  next_out[row] = min(m2 >> shift, kMaxCount);
}

}  // namespace

extern "C" int fqtk_colmerge_top2(const void* obs, int64_t b, int width,
                                  const void* table, int64_t k_pad, int kp,
                                  int64_t k, int length, int classes,
                                  int n_chunks, int64_t cols_per_cta,
                                  void* partial,
                                  void* best, void* idx, void* next,
                                  void* stream) {
  const int bad = check_args(b, width, table, k_pad, kp, k, length, classes,
                             n_chunks, cols_per_cta);
  if (bad != 0) return bad;
  if (n_chunks > 1 && partial == nullptr) return -1;
  int shift = 1;
  while ((1LL << shift) < (long long)k) ++shift;  // column bits
  if (shift > 23) return -2;  // count (8 bits) << shift must stay an int32

  int32_t* pp = static_cast<int32_t*>(partial);
  int32_t* pb = static_cast<int32_t*>(best);
  int32_t* pi = static_cast<int32_t*>(idx);
  int32_t* pn = static_cast<int32_t*>(next);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Pass1Args args{static_cast<const uint8_t*>(obs), b, width, length,
                       static_cast<const uint8_t*>(table), kp, k, cols_per_cta,
                       (b + kRows - 1) / kRows, n_chunks, shift, pp, pb, pi, pn};
  const cudaError_t e = launch_pass1<ColmergeScheme>(args, classes, s);
  if (e != cudaSuccess || n_chunks == 1) return (int)e;
  colmerge_top2_pass2<<<(unsigned)((b + 255) / 256), 256, 0, s>>>(
      pp, b, n_chunks, shift, pb, pi, pn);
  return (int)cudaGetLastError();
}

// What the card makes of the sliced walk's pass-1 instantiation a launch
// at (classes, kp > 128) runs: 6 int32 to `out` (registers, static and
// dynamic shared bytes, CTAs an SM holds, local bytes, ring stages;
// walk_info_at in mma_count.cuh).  0, -1 for a depth the walk does not
// take, else the CUDA error.
extern "C" int fqtk_colmerge_top2_walk_info(int classes, int kp, void* out) {
  return walk_info<ColmergeScheme>(classes, kp, static_cast<int32_t*>(out));
}
