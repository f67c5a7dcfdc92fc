// Shared pieces of the kernel lab's Hopper kernels (sm_90a), counterparts of
// Pallas bodies in scripts/kernel_lab.py:
// * the exact kernels' emit, csrc/clamp16_top2.cu (TPU kernel #5),
//   group_top2.cu (#6) and clamp8_top2.cu (#7): the running (smallest,
//   second smallest) emit keys of a row (Top2Keys), the fold of a quad's
//   keys and the row's partial per slice (emit_top2), and pass 2, which folds
//   the slices of a row (top2_fold).
// The walk of the kernels that count on the tensor cores (#3-#7) is
// csrc/lab_mma.cuh.
//
// Every key of a row's emit is unique (it ends in the column id), so the
// folds are associative and equal the TPU emit over all tile_k positions.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace lab {

constexpr int kThreads = 256;        // threads per CTA
constexpr int32_t kMasked = 1 << 30; // the emit's masked-key sentinel
constexpr int32_t kKeyMax = 0x7fffffff;

// Running (smallest, second smallest capped at kMasked) of a row's emit
// keys, and the smallest second-stream count: what the TPU emit computes
// as g1, min(masked) and m2min.
struct Top2Keys {
  int32_t g1 = kKeyMax, g2 = kMasked, m2c = kKeyMax;
  __device__ __forceinline__ void add(int32_t e) {
    g2 = min(g2, max(g1, e));
    g1 = min(g1, e);
  }
};

// partial [3, n_slices, b] int32: g1, g2, m2c of (slice, row)
__device__ __forceinline__ void store_top2(int32_t* __restrict__ partial,
                                           int n_slices, int slice,
                                           int64_t b, int64_t row,
                                           const Top2Keys& a) {
  partial[((int64_t)0 * n_slices + slice) * b + row] = a.g1;
  partial[((int64_t)1 * n_slices + slice) * b + row] = a.g2;
  partial[((int64_t)2 * n_slices + slice) * b + row] = a.m2c;
}

// The end of pass 1 of an exact kernel on csrc/lab_mma.cuh's walk: the four
// threads of a quad (t = lane & 3) hold disjoint positions of the same two
// rows (k[0]: r_lo, k[1]: r_hi); fold their keys and let t == 0 write the
// rows' partials (rows < b only).
__device__ __forceinline__ void emit_top2(Top2Keys (&k)[2],
                                          int32_t* __restrict__ partial,
                                          int n_slices, int slice, int64_t b,
                                          int64_t r_lo, int64_t r_hi, int t) {
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const int32_t o1 = __shfl_xor_sync(0xffffffffu, k[rr].g1, off);
      const int32_t o2 = __shfl_xor_sync(0xffffffffu, k[rr].g2, off);
      const int32_t om = __shfl_xor_sync(0xffffffffu, k[rr].m2c, off);
      k[rr].g2 = min(min(k[rr].g2, o2), max(k[rr].g1, o1));
      k[rr].g1 = min(k[rr].g1, o1);
      k[rr].m2c = min(k[rr].m2c, om);
    }
  }
  if (t != 0) return;
  if (r_lo < b) store_top2(partial, n_slices, slice, b, r_lo, k[0]);
  if (r_hi < b) store_top2(partial, n_slices, slice, b, r_hi, k[1]);
}

// Pass 2 of the exact kernels: fold the slices of each row, then the TPU
// emit (kernel_lab.py:290-302): best = g1 / (nt * tile_k), idx from the
// tile and column fields of g1, next = min(g2 / (nt * tile_k), m2c).
__global__ void __launch_bounds__(kThreads)
top2_fold(const int32_t* __restrict__ partial, int64_t b, int n_slices,
          int tile_k, int nt_pow2, int32_t* __restrict__ best,
          int32_t* __restrict__ idx, int32_t* __restrict__ next) {
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (row >= b) return;
  Top2Keys acc;
  for (int s = 0; s < n_slices; ++s) {
    const int32_t a1 = partial[(int64_t)s * b + row];
    const int32_t a2 = partial[((int64_t)n_slices + s) * b + row];
    const int32_t am = partial[((int64_t)2 * n_slices + s) * b + row];
    acc.g2 = min(min(acc.g2, a2), max(acc.g1, a1));
    acc.g1 = min(acc.g1, a1);
    acc.m2c = min(acc.m2c, am);
  }
  const int32_t span = nt_pow2 * tile_k;
  best[row] = acc.g1 / span;
  idx[row] = ((acc.g1 / tile_k) & (nt_pow2 - 1)) * tile_k +
             (acc.g1 & (tile_k - 1));
  next[row] = min(acc.g2 / span, acc.m2c);
}

// Launch pass 2 over `b` rows of `n_slices` partials each.
inline int launch_top2_fold(const int32_t* partial, int64_t b, int n_slices,
                            int tile_k, int nt_pow2, void* best, void* idx,
                            void* next, cudaStream_t s) {
  top2_fold<<<(unsigned)((b + kThreads - 1) / kThreads), kThreads, 0, s>>>(
      partial, b, n_slices, tile_k, nt_pow2, static_cast<int32_t*>(best),
      static_cast<int32_t*>(idx), static_cast<int32_t*>(next));
  return (int)cudaGetLastError();
}

}  // namespace lab
}  // namespace
