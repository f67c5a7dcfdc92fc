// The kernel lab's walk on the tensor-core counting engine of
// csrc/mma_count.cuh, for Hopper (sm_90a): what csrc/mma_probe.cu (TPU
// kernel #3), csrc/lab_probe.cu (#4), csrc/clamp16_top2.cu (#5),
// csrc/group_top2.cu (#6) and csrc/clamp8_top2.cu (#7) share.
//
// The TPU bodies of scripts/kernel_lab.py walk the K tiles of the lab's table
// in order (the grid's second axis, pl.program_id(1)) and keep a state per
// (row, column position p < tile_k) in VMEM scratch across them: one to three
// accumulator streams of the design's width.  Here
//   CTA = 128 rows (two warpgroups of 64) x a slice of N column positions
//   [s0, s0 + N) of every K tile; step kb multiplies the rows by columns
//   kb * tile_k + s0 .. + N on the tensor cores (wgmma.m64nNk32.s8) and hands
//   the counts to the design's visitor, which updates the streams.  Two K
//   tiles (four for a design that runs narrower) are staged per CTA barrier,
//   each by its own bulk copy.
// N is the wgmma width: 128 where tile_k is a multiple of 128, else 64, else
// 32 (tile_k is any multiple of 32), at most the design's kMaxWidth (a
// design whose registers hold state across K tiles runs narrower).
//
// Table.  int8, k_padded * KP bytes: the [k_padded, KP] mismatch table (a
// column's 4L entries zero-padded to KP = 32 * ceil(4L / 32) <= 128) as
// [k_padded / 8][KP / 16][8][16]: groups of 8 columns, each KP / 16 "core
// matrices" of 8 columns x 16 depth bytes.  Any run of N consecutive columns
// (N a multiple of 8) is then a contiguous block in wgmma's no-swizzle
// K-major layout of B (LBO 128 bytes, SBO KP * 8 bytes), so a K tile's
// slice is ONE bulk copy of N * KP bytes.  Packed once, when the variant is made
// (lab_kernels.pack_lab_table_i8).  The pad columns up to k_padded =
// n_k_tiles * tile_k are all ones, count L and take part, as on the TPU.
//
// Streams.  They live in shared memory at the TPU body's widths, and every
// step reads and writes them there (ld.shared / st.shared in volatile asm:
// the compiler may neither keep the state in registers across steps nor drop
// a store that a later step overwrites): that traffic is what the lab
// measures.  The layout is the kernel's own.  After a step a thread holds,
// for each of its two rows, the N / 4 counts of positions 8j + 2t + e; it
// keeps those elements of a stream contiguously, in the order
//   i = (rr * (N / 8) + j) * 2 + e      (rr: row g or g + 8)
// cut into 16-byte chunks, chunk c of thread `tid` at byte
//   (c * 256 + tid) * 16
// of the stream, so that one 128-bit access moves 16 positions of a byte
// stream (4 of an int32 stream) and a warp's access is 512 consecutive bytes
// (no bank conflict).  A 32-bit word of a byte stream holds elements
// (ja, e0), (ja, e1), (ja + 1, e0), (ja + 1, e1) of one row, ja even; a
// 32-bit word of a 16-bit stream holds (j, e0) and (j, e1) as 16x2 lanes.
//
// What bounds these kernels on this card.  Operations: 2 * B * k_padded * KP
// int8 against 1,979 TOP/s (59 pairs per clock and SM at KP 64).  Beside it
// the streams: S bytes per (row, column) pair through shared memory plus
// KP / 64 bytes per pair of wgmma's own B reads per 64-row warpgroup, against
// 128 bytes per clock and SM; and the integer lanes (64 per clock and SM)
// for the packed updates.  A warpgroup waits for its product before it
// visits the counts, so products and updates overlap across the four
// warpgroups an SM holds (two CTAs), as in kernels #1 and #2.
//
// Pass 1 ends with the body's emit over the thread's positions, folds the
// four threads of a quad (they hold disjoint positions of the same rows) and
// writes one partial per (row, slice); pass 2 folds the slices of a row
// (mma_probe's output is one column of slice 0: those CTAs write it).

#pragma once

#include "mma_count.cuh"

namespace {
namespace labm {

using namespace mmac;

// The wgmma width the lab runs at `tile_k` (a multiple of 32).
inline int width_of(int tile_k) {
  return tile_k % 128 == 0 ? 128 : (tile_k % 64 == 0 ? 64 : 32);
}

// The width `Design` runs at: width_of(tile_k), at most Design::kMaxWidth.
// A K tile is tile_k / lab_width slices, one CTA column and one partial each.
template <class Design>
inline int lab_width(int tile_k) {
  const int n = width_of(tile_k);
  return n < Design::kMaxWidth ? n : Design::kMaxWidth;
}

// What a pass-1 launch is given.  `partial` is [fields, n_slices, B] int32.
struct LabArgs {
  const uint8_t* obs;
  int64_t b;
  int width, length;
  const uint8_t* table;
  int kp, tile_k, n_k_tiles;
  int64_t n_row_tiles;
  int32_t* partial;
};

// 0, or a negative code for arguments the kernels do not take (-1 a shape,
// -2 the table's alignment, -3 a grid beyond 2^31 - 1 CTAs at `cols` column
// positions per CTA).
inline int check_lab_args(int64_t b, int width, const void* table, int kp,
                          int length, int tile_k, int n_k_tiles, int cols,
                          int64_t* n_row_tiles) {
  if (b <= 0 || length < 1 || length > 32 || width != (length + 3) / 4 ||
      kp != (4 * length + 31) / 32 * 32 || tile_k < 32 || tile_k % 32 != 0 ||
      n_k_tiles < 1 || (int64_t)n_k_tiles * tile_k > 0x7fffffffLL)
    return -1;
  if ((reinterpret_cast<uintptr_t>(table) & 15u) != 0) return -2;
  *n_row_tiles = (b + kRows - 1) / kRows;
  if (*n_row_tiles * (tile_k / cols) > 0x7fffffffLL) return -3;
  return 0;
}

// --- the streams ------------------------------------------------------------

struct Word4 {
  uint32_t w[4];
};

// Byte address (shared window) of chunk c of this thread in a stream.
__device__ __forceinline__ uint32_t chunk_addr(uint32_t stream, int c) {
  return stream + (uint32_t)(c * kThreads + (int)threadIdx.x) * 16u;
}

__device__ __forceinline__ Word4 lds128(uint32_t addr) {
  Word4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.w[0]), "=r"(v.w[1]), "=r"(v.w[2]), "=r"(v.w[3])
               : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, const Word4& v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.w[0]), "r"(v.w[1]), "r"(v.w[2]), "r"(v.w[3]));
}

// Per-lane signed min / max of two 16-bit lanes: the three-input DPX forms
// with one input repeated (CUDA names no two-input 16x2 form without a
// predicate or a relu).
__device__ __forceinline__ uint32_t min16x2(uint32_t a, uint32_t b) {
  return __vimin3_s16x2(a, b, b);
}
__device__ __forceinline__ uint32_t max16x2(uint32_t a, uint32_t b) {
  return __vimax3_s16x2(a, b, b);
}

// Fill the thread's `chunks` chunks of a stream with the 32-bit pattern.
__device__ __forceinline__ void fill_stream(uint32_t stream, int chunks,
                                            uint32_t pattern) {
  const Word4 v{{pattern, pattern, pattern, pattern}};
  for (int c = 0; c < chunks; ++c) sts128(chunk_addr(stream, c), v);
}

// Where word W (of N / 8 per thread and stream-of-bytes, or chunk W of an
// int32 stream) sits: its row rr and its first n8 block ja; its four
// elements are the counts acc[4 * ja + 2 * rr + e] and acc[4 * (ja + 1) +
// 2 * rr + e], e = 0, 1, at positions 8 * ja + 2t + e and 8 * (ja + 1) + 2t
// + e of the slice.
template <int N>
struct WordAt {
  static constexpr int kPerRow = N / 16;
  static __host__ __device__ constexpr int rr(int w) { return w / kPerRow; }
  static __host__ __device__ constexpr int ja(int w) {
    return 2 * (w % kPerRow);
  }
};

// Where word W of a 16-bit stream (N / 8 per row and thread; chunk c holds
// words 4c .. 4c + 3) sits: its row rr and its n8 block j; its low lane is
// the count acc[4 * j + 2 * rr] at position 8 * j + 2t of the slice, its high
// lane acc[4 * j + 2 * rr + 1] at 8 * j + 2t + 1.
template <int N>
struct HalfAt {
  static constexpr int kPerRow = N / 8;
  static __host__ __device__ constexpr int rr(int w) { return w / kPerRow; }
  static __host__ __device__ constexpr int j(int w) { return w % kPerRow; }
};

// The counts acc[i] and acc[i + 1] (below 2^15) as 16x2 lanes, low: acc[i].
__device__ __forceinline__ uint32_t lanes16(int32_t lo, int32_t hi) {
  return __byte_perm((uint32_t)lo, (uint32_t)hi, 0x5410);
}

// --- the walk ---------------------------------------------------------------

// K tiles per step of the lab's product loop (one CTA barrier per step) and
// the steps its ring holds, by the design and the table's depth (NK1 k32
// steps).  The default: two tiles a step in a ring of three, 3 x 16 KB at
// N 128, L 16, so that two CTAs of any design share an SM beside their
// streams.
struct TwoTileSteps {
  __host__ __device__ static constexpr int step_tiles(int) { return 2; }
  __host__ __device__ static constexpr int ring_steps(int) { return 3; }
};

// Source of the lab's product loop: sub-tile j of step s is the slice's N
// columns of K tile STEP * s + j, one bulk copy each.
template <int STEP>
struct TileWalk {
  const uint8_t* base;  // the table at column s0
  int64_t stride;       // tile_k * kp bytes between K tiles
  int n_k_tiles;
  __device__ __forceinline__ int steps() const {
    return (n_k_tiles + STEP - 1) / STEP;
  }
  __device__ __forceinline__ int subs(int s) const {
    return min(STEP, n_k_tiles - s * STEP);
  }
  __device__ __forceinline__ void load(int s, uint32_t dst, uint32_t bar,
                                       uint32_t sub_bytes) const {
    const int n = subs(s);
    mbar_expect(bar, (uint32_t)n * sub_bytes);
    for (int j = 0; j < n; ++j)
      bulk_copy(dst + j * sub_bytes, base + (int64_t)(s * STEP + j) * stride,
                sub_bytes, bar);
  }
};

// Hands the design's visitor each K tile's counts with the tile's index.
template <class Visitor, int STEP>
struct ByKTile {
  Visitor& vis;
  template <int R>
  __device__ __forceinline__ void visit(int32_t (&acc)[R], int s, int j) {
    vis.visit(acc, s * STEP + j);
  }
};

// Bytes of dynamic shared memory of a lab kernel: the ring, then the
// design's streams of kStreamBytes per (row, position).
__host__ __device__ constexpr int ring_bytes(int nk1, int n, int step,
                                             int ring) {
  return ring * step * n * 32 * nk1;
}
template <class Design>
__host__ __device__ constexpr int lab_smem_bytes(int nk1, int n) {
  return ring_bytes(nk1, n, Design::step_tiles(nk1), Design::ring_steps(nk1)) +
         kRows * n * Design::kStreamBytes;
}

// Pass 1 of a lab kernel.  Design:
//   kStreamBytes                bytes of state per (row, position)
//   kMaxWidth                   the widest N it is built for (128, 64, 32)
//   step_tiles(NK1), ring_steps(NK1)   K tiles a step, steps in the ring
//                               (TwoTileSteps: 2 and 3)
//   Params                      the design's own arguments (by value)
//   Visitor<N>(streams, params, s0, tile_k, t)   `streams`: the shared
//                               address of the CTA's state
//     init()                    the body's kb == 0 initialisation
//     visit(acc, kb)            the body's step for K tile kb
//     emit(args, slice, r_lo, r_hi)   the body's emit, the quad's fold and
//                               the row's partials (rows < b only)
// blockIdx runs over the row tiles of one slice first, so the CTAs in flight
// walk the same columns.
template <class Design, int NK1, int N>
__global__ void __launch_bounds__(kThreads, 2)
    lab_pass1(const LabArgs a, const typename Design::Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int64_t row_tile = blockIdx.x % a.n_row_tiles;
  const int slice = (int)(blockIdx.x / a.n_row_tiles);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int64_t r_lo = row_tile * kRows + warp * 16 + g, r_hi = r_lo + 8;

  constexpr int kStep = Design::step_tiles(NK1);
  constexpr int kRing = Design::ring_steps(NK1);
  uint32_t af[NK1][4];
  load_a<NK1>(a.obs, a.b, a.width, a.length, r_lo, r_hi, t, af);
  typename Design::template Visitor<N> vis(
      smem_u32(smem + ring_bytes(NK1, N, kStep, kRing)), p, slice * N,
      a.tile_k, t);
  vis.init();  // each thread touches only its own elements: no barrier
  const TileWalk<kStep> walk{a.table + (int64_t)slice * N * a.kp,
                             (int64_t)a.tile_k * a.kp, a.n_k_tiles};
  ByKTile<decltype(vis), kStep> by_tile{vis};
  product_loop<NK1, N, kStep, kRing>(af, walk, smem, by_tile);
  vis.emit(a, slice, r_lo, r_hi);
}

template <class Design, int NK1, int N>
cudaError_t launch_lab_at(const LabArgs& a, const typename Design::Params& p,
                          cudaStream_t s) {
  constexpr int kSmem = lab_smem_bytes<Design>(NK1, N);
  auto kern = lab_pass1<Design, NK1, N>;
  // the 48 KB a kernel gets unasked hold its static shared memory too (the
  // ring's barriers)
  if (kSmem > 47 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return e;
  }
  kern<<<(unsigned)(a.n_row_tiles * (a.tile_k / N)), kThreads, kSmem, s>>>(a,
                                                                          p);
  return cudaGetLastError();
}

template <class Design, int NK1>
cudaError_t launch_lab_n(const LabArgs& a, const typename Design::Params& p,
                         cudaStream_t s) {
  const int n = lab_width<Design>(a.tile_k);
  if constexpr (Design::kMaxWidth >= 128)
    if (n == 128) return launch_lab_at<Design, NK1, 128>(a, p, s);
  if constexpr (Design::kMaxWidth >= 64)
    if (n == 64) return launch_lab_at<Design, NK1, 64>(a, p, s);
  return launch_lab_at<Design, NK1, 32>(a, p, s);
}

// Pass 1 at the instantiation the table's depth and tile_k ask for.
template <class Design>
cudaError_t launch_lab(const LabArgs& a, const typename Design::Params& p,
                       cudaStream_t s) {
  switch (a.kp) {
    case 32: return launch_lab_n<Design, 1>(a, p, s);
    case 64: return launch_lab_n<Design, 2>(a, p, s);
    case 96: return launch_lab_n<Design, 3>(a, p, s);
    default: return launch_lab_n<Design, 4>(a, p, s);
  }
}

}  // namespace labm
}  // namespace
