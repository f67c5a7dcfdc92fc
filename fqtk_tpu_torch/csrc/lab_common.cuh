// Shared pieces of the kernel lab's POPC-counting Hopper kernels (sm_90a):
// csrc/clamp16_top2.cu (TPU kernel #5) and group_top2.cu (#6), counterparts
// of Pallas bodies in scripts/kernel_lab.py.  The lab's other kernels count
// on the tensor cores: csrc/mma_probe.cu (#3) uses only check_args and
// load_onehot from here, csrc/clamp8_top2.cu (#7) only the emit's key fold
// (Top2Keys, store_top2, top2_fold), csrc/lab_probe.cu (#4) nothing; their
// walk is csrc/lab_mma.cuh.
//
// The TPU bodies walk the K tiles of the lab's table in order (the grid's
// second axis) and keep a state per (row, column position p < tile_k) in
// VMEM scratch across them: one to three accumulator streams of the
// variant's width.  Here the walk is a loop inside the CTA and the state
// lives in shared memory at the same widths:
//   CTA = 256 rows (one per thread) x a slice of kSlice column positions
//   [s0, s0 + kSlice) of every K tile.  State element (p, row) sits at
//   p * kThreads + thread, so a warp's access to one p is 32 consecutive
//   elements (no bank conflicts at any width).  Each thread touches only
//   its own row's state, through volatile pointers, so every read and write
//   of the TPU body's streams is issued at every step (nvcc may not keep
//   the state in registers across steps or drop a store that a later step
//   overwrites): the traffic of the streams is what the lab measures.
// Counting is by POPC over the bit-packed table, as in csrc/tile_top2.cu:
// the thread's one-hot (bit c*L + l set iff the row's code at l is c) lives
// in registers; the slice's columns of kChunkTiles K tiles are staged into
// shared memory with 16-byte loads and read as broadcasts.  The table's pad
// columns (all ones, up to n_k_tiles * tile_k) count L and take part, as on
// the TPU.
// Pass 1 ends with the body's emit over the thread's kSlice positions and
// writes one partial per (row, slice); pass 2 folds the slices of a row.
// Every key of a row's emit is unique (it ends in the column id), so the
// fold is associative and equals the TPU emit over all tile_k positions.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace lab {

constexpr int kThreads = 256;        // rows per CTA, one per thread
constexpr int kSlice = 32;           // column positions per CTA
constexpr int kChunkTiles = 16;      // K tiles staged per pair of barriers
constexpr int32_t kMasked = 1 << 30; // the emit's masked-key sentinel
constexpr int32_t kKeyMax = 0x7fffffff;
constexpr int32_t kMaxCount = 255;

// 0, or a negative code for arguments the kernels do not take.
inline int check_args(int64_t b, int width, const void* bits, int nw,
                      int length, int tile_k, int n_k_tiles,
                      int64_t* n_row_tiles) {
  if (b <= 0 || length < 1 || length > 32 || width != (length + 3) / 4 ||
      nw != (4 * length + 31) / 32 || tile_k < kSlice ||
      tile_k % kSlice != 0 || n_k_tiles < 1 ||
      (int64_t)n_k_tiles * tile_k > 0x7fffffffLL)
    return -1;
  if ((reinterpret_cast<uintptr_t>(bits) & 15u) != 0) return -2;
  *n_row_tiles = (b + kThreads - 1) / kThreads;
  if (*n_row_tiles * (tile_k / kSlice) > 0x7fffffffLL) return -3;
  return 0;
}

// The row's bit2 codes as the class-major one-hot bitmask.  The word is
// selected by compare so the array stays in registers.
template <int NW>
__device__ __forceinline__ void load_onehot(const uint8_t* __restrict__ obs,
                                            int64_t row, int width,
                                            int length, uint32_t (&oh)[NW]) {
#pragma unroll
  for (int w = 0; w < NW; ++w) oh[w] = 0u;
  const uint8_t* o = obs + row * (int64_t)width;
  for (int l = 0; l < length; ++l) {
    const int bit = ((o[l >> 2] >> ((l & 3) * 2)) & 3) * length + l;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      oh[w] |= ((bit >> 5) == w) ? (1u << (bit & 31)) : 0u;
  }
}

// Stage the slice's columns of K tiles kb0 .. kb0 + ct - 1: each tile's
// kSlice columns are kSlice * NW contiguous words of `bits` ([k_padded, NW]
// uint32), 16-byte aligned since tile_k and s0 are multiples of kSlice.
template <int NW>
__device__ __forceinline__ void stage_chunk(const uint32_t* __restrict__ bits,
                                            int tile_k, int s0, int kb0,
                                            int ct, uint32_t* stage) {
  constexpr int kPerTile = kSlice * NW / 4;  // uint4 per tile
  for (int q = threadIdx.x; q < ct * kPerTile; q += kThreads) {
    const int j = q / kPerTile;
    const uint4* src = reinterpret_cast<const uint4*>(
        bits + ((int64_t)(kb0 + j) * tile_k + s0) * NW);
    reinterpret_cast<uint4*>(stage)[q] = __ldg(src + (q - j * kPerTile));
  }
}

template <int NW>
__device__ __forceinline__ int count_of(const uint32_t (&oh)[NW],
                                        const uint32_t* col) {
  int c = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) c += __popc(oh[w] & col[w]);
  return c;
}

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

// Launch pass 1 (`kernel`, `smem` bytes of dynamic shared state) on the
// flattened grid (row tile fastest), then pass 2 if `fold`.  Returns the
// first CUDA error.
template <class Kernel, class... Args>
int launch_pass1(Kernel kernel, size_t smem, int64_t n_row_tiles,
                 int n_slices, cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(unsigned)(n_row_tiles * n_slices), kThreads, smem, stream>>>(
      args..., n_row_tiles);
  return (int)cudaGetLastError();
}

}  // namespace lab
}  // namespace
