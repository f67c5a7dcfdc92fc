// Tensor-core mismatch counting with an exact running top-2, for Hopper
// (sm_90a).  The shared engine of csrc/colmerge_top2.cu (TPU kernel #1,
// `kernel_colmerge`, fqtk_tpu/ops/pallas_matcher.py:373-440) and
// csrc/tile_top2.cu (TPU kernel #2, `kernel`, :285-371): like the TPU bodies
// it multiplies the one-hot of a row tile by a tile of the int8 mismatch
// table on the matrix unit and keeps, per row, the two smallest
// (count, column) keys.
//
// Function.  For read row b and whitelist column k < K,
//   count[b, k] = sum_j onehot[b, j] * table[k, j]
// where, for bit2 input (4 classes, class-major), onehot[b, c*L + l] = (code
// of row b at position l == c) and table[k, c*L + l] = 1 iff code c
// mismatches barcode k at position l; for nib4 input (16 classes,
// position-major), onehot[b, l*16 + c] = (mask of row b at position l == c)
// and table[k, l*16 + c] = 1 iff mask value c has a bit outside barcode k's
// mask at l.  At most one class per position is set, so counts <= L.  Per
// row the engine keeps m1 < m2, the two smallest keys
//   key = count << shift | (column - col_base)
// over the CTA's column range; keys are unique, so the smallest key is (best,
// FIRST column reaching it) and the count of the second is `next`.
//
// Inputs
//   obs   [B, W] uint8, one of two forms (CLASSES):
//         4: W = ceil(L/4), four 2-bit codes per byte, lowest bit pair first
//            (the native engine's "bit2");
//         16: W = ceil(L/2), two 4-bit IUPAC masks per byte, low nibble the
//            even position ("nib4"; raw bytes are converted to it before
//            the launch).
//   table int8, K_pad * KP bytes: the [K_pad, KP] mismatch table (a column's
//         CLASSES * L entries, zero-padded to the depth KP = 32 *
//         ceil(CLASSES * L / 32) up to 128, a multiple of 128 above;
//         depth_of) stored in the order the product
//         reads it from shared memory, so that a stage is one contiguous
//         copy.  As an array: [K_pad/128][KP/SB][16][SB/16][8][16] bytes,
//         i.e. per sub-tile of 128 columns and depth slice of SB bytes (SB =
//         KP up to 128, else 128), 16 groups of 8 columns, each group SB/16
//         "core matrices" of 8 columns x 16 depth bytes (128 contiguous
//         bytes).  That is wgmma's no-swizzle K-major layout of B with
//         LBO = 128 bytes between depth-adjacent core matrices and SBO =
//         SB/16 * 128 bytes between 8-column groups.  Packed once, when the
//         state is built (hopper_matcher.pack_table_i8).  K_pad is a
//         multiple of 128; columns >= K are all-ones pad columns, read but
//         never taking part: the exact update masks columns >= K.
//
// What bounds it on this card, and the design's answer.
// * Operations.  B x K x KP int8 MACs against 1,979 TOP/s dense: 59 (row,
//   column) pairs per clock and SM at KP = 64, reached only by wgmma.  A CTA
//   is two warpgroups of 64 rows; each runs
//   wgmma.mma_async.m64n128k32.s32.s8.s8 with A (the one-hot, built once per
//   CTA from the bit2 rows) in registers and B (128 columns x 32 bytes of the
//   table) from shared memory.
// * The top-2 must not eat the product's rate: at 59 pairs/clk/SM the 64
//   integer lanes of an SM have about one operation per pair.  A key update
//   (`m2 = min(m2, max(m1, key)); m1 = min(m1, key)` plus the key build) is
//   five.  So the update runs behind a test: a thread holds 32 counts of a
//   row per sub-tile, in four groups of 8; the minimum of each group and of
//   the row by three-input minima (__vimin3_s32, 18 instructions) is
//   compared with `thr`, the count of the row's running second key.
//   Columns are visited in ascending order, so a count >= thr can never
//   change m1 or m2 (its key is larger than m2's, whose column came
//   earlier): the test is exact, not a heuristic.  Only when it fires does
//   the thread build keys, and only for the groups whose own minimum
//   passed.  A warpgroup waits for its product before it tests the counts
//   (ptxas serializes wgmma when other instructions read one accumulator
//   set while a product into a second set is in flight), so the overlap of
//   products and tests comes from the four warpgroups an SM holds: two CTAs
//   of under 128 registers a thread.
// * Bytes.  The table is read once per CTA: 64 bytes per column per 128
//   rows at KP = 64, from L2 (blockIdx runs over row tiles first, so the
//   CTAs in flight walk the same columns).  Staged with 16-byte cp.async
//   requests this traffic, not the product, set the kernel's time (about
//   2 TB/s whatever the table's size).  So a stage is ONE bulk copy
//   (cp.async.bulk, the 1-D form of TMA) started by one thread, which
//   completes on an mbarrier: a ring of three or four stages of 256
//   columns, the copies of the next stages in flight while stage s is
//   multiplied.
// * Depth above 128 bytes (16-class rows at L >= 9, bit2 rows at L 33-255):
//   the sliced walk of count_top2 stages a sub-tile's depth 256 bytes at a
//   time in a ring of three 32 KB stages beside the rows' one-hot words
//   (two CTAs an SM still), multiplies a sub-tile's whole depth into one
//   accumulator set, and frees a slot by the last warp through it (no
//   CTA-wide barrier), so the CTA's two warpgroups run apart.
// * Fill.  The wrapper splits K into `n_chunks` column ranges (multiples of
//   128 columns) where the row tiles alone do not fill the SMs; each (row
//   tile, chunk) is a CTA and the chunks of a row meet in a second pass.
//
// The 4 threads of a quad hold disjoint columns of the same row; their
// (m1, m2) pairs meet at the end by shuffles with the key merge
// `m2 = min(min(m2, o2), max(m1, o1)); m1 = min(m1, o1)`.
//
// The engine is in three parts (below, "the engine"): the one-hot A
// fragments, the product loop over a source of table blocks, and a visitor
// of each sub-tile's counts.  Kernels #1 and #2 use them through count_top2
// (consecutive 256-column stages, the running top-2); the kernel lab's
// kernels (TPU kernels #3-#7) through csrc/lab_mma.cuh.
// The header also holds what the two top-2 kernels' first passes share: the
// pass-1 kernel over a (row tile, chunk) grid, which differs per scheme only
// in the key's column base and in what a row writes (a `Scheme`), its launch
// by table depth, and the argument checks.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace mmac {

constexpr int kThreads = 256;    // two warpgroups
constexpr int kRows = 128;       // rows per CTA, 64 per warpgroup
constexpr int kSub = 128;        // columns per wgmma (n128)
constexpr int kStageSubs = 2;    // sub-tiles per stage of the main loop
constexpr int kMaxRing = 8;      // mbarriers a CTA holds
constexpr int32_t kMaxCount = 255;
constexpr int32_t kKeyInit = 0x7fffffff;

// The sliced walk (KP above 128; count_top2's MULTI): a stage is one
// sub-tile's 128 columns x kWalkSlices depth slices of 128 bytes (32 KB, one
// copy), kWalkRing stages beside the rows' one-hot words at kBitStride words
// a row: 112.5 KB, so that two CTAs share an SM's 228 KB.
constexpr int kSliceBytes = kSub * 128;  // one depth slice of a sub-tile
constexpr int kWalkSlices = 2;
constexpr int kWalkRing = 3;
constexpr int kBitStride = 33;
constexpr int kWarps = kThreads / 32;

// Ring depth of the main loop: 96 KB of stages at most, so that two CTAs
// share an SM's shared memory at every depth.
__host__ __device__ constexpr int ring_stages(int nk1) {
  return nk1 <= 3 ? 4 : 3;
}

// Bytes of dynamic shared memory a kernel instantiation needs.
__host__ __device__ constexpr int smem_bytes(int nk1, bool multi) {
  return multi ? kWalkRing * kWalkSlices * kSliceBytes + kRows * kBitStride * 4
               : ring_stages(nk1) * kStageSubs * kSub * 32 * nk1;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// --- mbarriers and the bulk copy that completes on one ---------------------

__device__ __forceinline__ void mbar_init(uint64_t* bars, int n) {
  for (int i = 0; i < n; ++i)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
        smem_u32(bars + i)));
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival at `bar`, whose current phase then completes when `bytes` more
// bytes of bulk copies have landed.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, counted at `bar`.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// One copy that completes `bar`'s current phase when it has landed.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  mbar_expect(bar, bytes);
  bulk_copy(dst, src, bytes, bar);
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE_%=;\nbra WAIT_%=;\nDONE_%=:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The sliced walk's release of a slot, without a branch (a branch between
// products makes ptxas serialize them, C7520): lane 0 counts its warp in at
// `done`, and the count before it reaches the whole warp.
__device__ __forceinline__ uint32_t count_in(uint32_t* done, int lane) {
  uint32_t before = 0u;
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.s32 p, %1, 0;\n"
      "@p atom.shared.add.u32 %0, [%2], 1;\n}\n"
      : "+r"(before)
      : "r"(lane), "r"(smem_u32(done))
      : "memory");
  return __shfl_sync(0xffffffffu, before, 0);
}

// bulk_load where `pred` is non-zero, under a predicate, not a branch.
__device__ __forceinline__ void bulk_load_if(int pred, uint32_t dst,
                                             const void* src, uint32_t bytes,
                                             uint32_t bar) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.s32 p, %4, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%3], %2;\n"
      "@p cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n}\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar), "r"(pred)
      : "memory");
}

// --- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of an accumulator across a wait.
template <int R>
__device__ __forceinline__ void fence_acc(int32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a B sub-tile in the no-swizzle K-major
// layout: start address, LBO = 128 bytes between depth-adjacent core
// matrices, SBO = `sbo` bytes between 8-column groups (16-byte units).
__device__ __forceinline__ uint64_t b_desc(uint32_t addr, uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3fffu) | ((uint64_t)(128u >> 4) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fffu) << 32);
}

// d (+)= a[64 x 32] * b[32 x N], N = 128, 64 or 32 columns: a from registers
// (rows g, g + 8 of the warp's 16; depth t*4.. and 16 + t*4..), b by
// descriptor.  scale_d = 0 overwrites d.  A thread holds N/2 sums: d[4j + 2rr
// + e] is row g + 8rr, column 8j + 2t + e of the sub-tile.
template <int N>
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[N / 2],
                                         const uint32_t (&a)[4], uint64_t desc,
                                         int scale_d) {
  static_assert(N == 128 || N == 64 || N == 32, "instantiated widths");
  if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
        "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
        "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
        "%62, %63}, {%64, %65, %66, %67}, %68, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
          "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
          "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
          "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
          "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
          "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
          "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
        "%26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
          "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
          "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
          "+r"(d[30]), "+r"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, {%16, %17, %18, %19}, %20, p;\n}\n"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
          "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
          "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
          "+r"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
}

// --- the one-hot (A) -------------------------------------------------------

// Bits j0 .. j0 + 3 of a one-hot bit word (j0 a multiple of 4) as four int8
// 0/1 values in one register, lowest byte first.
__device__ __forceinline__ uint32_t onehot_bytes(uint32_t word, int j0) {
  const uint32_t nib = (word >> (j0 & 31)) & 0xFu;
  return (nib & 1u) | ((nib & 2u) << 7) | ((nib & 4u) << 14) |
         ((nib & 8u) << 21);
}

// The A fragment of one k32 step from the one-hot bit words of the thread's
// two rows (lo: row g, hi: row g + 8), t = lane & 3.
__device__ __forceinline__ void a_frag(uint32_t (&a)[4], uint32_t lo,
                                       uint32_t hi, int t) {
  a[0] = onehot_bytes(lo, t * 4);
  a[1] = onehot_bytes(hi, t * 4);
  a[2] = onehot_bytes(lo, 16 + t * 4);
  a[3] = onehot_bytes(hi, 16 + t * 4);
}

// Bit word w of the class-major one-hot (bit c*L + l) of a bit2 row.
__device__ __forceinline__ uint32_t onehot_word(const uint8_t* __restrict__ o,
                                                int length, int w) {
  uint32_t word = 0u;
  for (int l = 0; l < length; ++l) {
    const int bit = ((o[l >> 2] >> ((l & 3) * 2)) & 3) * length + l;
    word |= ((bit >> 5) == w) ? (1u << (bit & 31)) : 0u;
  }
  return word;
}

// The NW <= 4 bit words of a bit2 row of at most 8 bytes (L <= 32), read
// once; the word is selected by compare so the array stays in registers.
template <int NW>
__device__ __forceinline__ void onehot_words(const uint8_t* __restrict__ o,
                                             int width, int length,
                                             uint32_t (&words)[NW]) {
  uint64_t codes = 0;
  for (int i = 0; i < width; ++i) codes |= (uint64_t)o[i] << (8 * i);
#pragma unroll
  for (int w = 0; w < NW; ++w) words[w] = 0u;
  for (int l = 0; l < length; ++l) {
    const int bit = (int)((codes >> (2 * l)) & 3) * length + l;
#pragma unroll
    for (int w = 0; w < NW; ++w)
      words[w] |= ((bit >> 5) == w) ? (1u << (bit & 31)) : 0u;
  }
}

// The 16-class input.  The table's depth is position-major (l*16 + c), so
// the k32 step over positions 2i and 2i + 1 needs nib4 byte i alone: depth
// bytes t*4 .. t*4 + 3 of the step are classes 4t .. 4t + 3 of position 2i,
// bytes 16 + t*4 .. those of position 2i + 1 (a_frag's layout).  A 128-byte
// depth slice is 8 positions: one 32-bit word of the nib4 row.  The depth
// past 16L is zero in the table, so what A holds there never counts.

// The int8 one-hot bytes of classes 4t .. 4t + 3 for mask m (0 .. 15).
__device__ __forceinline__ uint32_t class_bytes(uint32_t m, int t) {
  return (m >> 2) == (uint32_t)t ? 1u << (8u * (m & 3u)) : 0u;
}

// The A fragment of the k32 step over the two positions of nib4 bytes lo
// (row g) and hi (row g + 8); only their low 8 bits are read.
__device__ __forceinline__ void a_frag16(uint32_t (&a)[4], uint32_t lo,
                                         uint32_t hi, int t) {
  a[0] = class_bytes(lo & 15u, t);
  a[1] = class_bytes(hi & 15u, t);
  a[2] = class_bytes((lo >> 4) & 15u, t);
  a[3] = class_bytes((hi >> 4) & 15u, t);
}

// Bytes 4w .. 4w + 3 of a nib4 row of `width` bytes as one word, lowest
// first; bytes past the row are 0.
__device__ __forceinline__ uint32_t nib4_word(const uint8_t* __restrict__ o,
                                              int width, int w) {
  uint32_t word = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (4 * w + i < width) word |= (uint32_t)o[4 * w + i] << (8 * i);
  return word;
}

// The sliced walk's A fragments: a_frag's and a_frag16's values, in fewer
// instructions, since the walk may build them once per stage.

// Four 0/1 bits as four int8 bytes, lowest first: the copies of `nib` at
// bits 0, 7, 14 and 21 do not overlap, so the product has no carries.
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  return (nib * 0x00204081u) & 0x01010101u;
}

// class_bytes(m, t): shl.b32 clamps a count above 31 to 32 and so gives 0
// unless 0 <= m - 4t < 4 (the difference taken unsigned).
__device__ __forceinline__ uint32_t walk_class_bytes(uint32_t m, int t) {
  uint32_t r;
  asm("shl.b32 %0, %1, %2;" : "=r"(r) : "r"(1u), "r"(8u * (m - 4u * t)));
  return r;
}

// The fragments of the eight k32 steps of depth slices s0 and s0 + 1 (step
// 4h + ks is step ks of slice s0 + h) from the words of the thread's rows
// (lo: row g, hi: row g + 8; a slice's words from [slice * 4] at 4 classes,
// its nib4 word [slice] at 16).  A slice at or past n_slices gives zeros:
// that half of the stage holds no table.
template <int CLASSES>
__device__ __forceinline__ void walk_frags(uint32_t (&a)[2 * 4][4],
                                           const uint32_t* __restrict__ lo,
                                           const uint32_t* __restrict__ hi,
                                           int s0, int n_slices, int t) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool live = s0 + h < n_slices;
    const int sl = live ? s0 + h : s0;  // never a word past the row's
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      uint32_t f[4];
      if constexpr (CLASSES == 16) {
        const uint32_t wl = lo[sl] >> (8 * ks), wh = hi[sl] >> (8 * ks);
        f[0] = walk_class_bytes(wl & 15u, t);
        f[1] = walk_class_bytes(wh & 15u, t);
        f[2] = walk_class_bytes((wl >> 4) & 15u, t);
        f[3] = walk_class_bytes((wh >> 4) & 15u, t);
      } else {
        const uint32_t wl = lo[sl * 4 + ks], wh = hi[sl * 4 + ks];
        f[0] = spread4((wl >> (4 * t)) & 15u);
        f[1] = spread4((wh >> (4 * t)) & 15u);
        f[2] = spread4((wl >> (16 + 4 * t)) & 15u);
        f[3] = spread4((wh >> (16 + 4 * t)) & 15u);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) a[4 * h + ks][e] = live ? f[e] : 0u;
    }
  }
}

// --- the running top-2 -----------------------------------------------------

// The two smallest keys of the thread's two rows over its columns.
struct RowTop2 {
  int32_t m1[2], m2[2], thr[2];
  const int shift;
  const int64_t col_base, k;

  __device__ RowTop2(int shift_, int64_t col_base_, int64_t k_)
      : shift(shift_), col_base(col_base_), k(k_) {
    m1[0] = m1[1] = m2[0] = m2[1] = kKeyInit;
    thr[0] = thr[1] = kKeyInit;  // above any count: the first sub-tile updates
  }

  // Exact update of row RR (0: row g, 1: row g + 8) from group Q of the 32
  // counts the thread holds of a sub-tile whose first column is cb: the 8
  // counts of n8 blocks 4Q .. 4Q + 3.  t = lane & 3.
  template <int RR, int Q>
  __device__ __forceinline__ void update(const int32_t (&d)[64], int64_t cb,
                                         int t) {
#pragma unroll
    for (int j = 4 * Q; j < 4 * Q + 4; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int32_t cnt = d[4 * j + 2 * RR + e];
        const int64_t col = cb + 8 * j + 2 * t + e;
        if (cnt < thr[RR] && col < k) {
          const int32_t key = (cnt << shift) | (int32_t)(col - col_base);
          m2[RR] = min(m2[RR], max(m1[RR], key));
          m1[RR] = min(m1[RR], key);
        }
      }
    }
    // a stale (larger) thr inside the group only lets more counts in: the
    // key update itself is exact
    thr[RR] = m2[RR] == kKeyInit ? kKeyInit : (m2[RR] >> shift);
  }

  template <int RR>
  __device__ __forceinline__ void visit_row(const int32_t (&d)[64], int64_t cb,
                                            int t) {
    int32_t g[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int o = 16 * q + 2 * RR;
      g[q] = __vimin3_s32(__vimin3_s32(d[o], d[o + 1], d[o + 4]),
                          __vimin3_s32(d[o + 5], d[o + 8], d[o + 9]),
                          min(d[o + 12], d[o + 13]));
    }
    if (min(__vimin3_s32(g[0], g[1], g[2]), g[3]) < thr[RR]) {
      if (g[0] < thr[RR]) update<RR, 0>(d, cb, t);
      if (g[1] < thr[RR]) update<RR, 1>(d, cb, t);
      if (g[2] < thr[RR]) update<RR, 2>(d, cb, t);
      if (g[3] < thr[RR]) update<RR, 3>(d, cb, t);
    }
  }

  // The sub-tile's counts against the rows' running second count.
  __device__ __forceinline__ void visit(int32_t (&d)[64], int64_t cb, int t) {
    fence_acc(d);
    visit_row<0>(d, cb, t);
    visit_row<1>(d, cb, t);
  }

  // Fold the quad's four column subsets: afterwards every lane of the quad
  // holds the rows' (m1, m2) over all of the CTA's columns.
  __device__ __forceinline__ void fold_quad() {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const int32_t o1 = __shfl_xor_sync(0xffffffffu, m1[rr], off);
        const int32_t o2 = __shfl_xor_sync(0xffffffffu, m2[rr], off);
        m2[rr] = min(min(m2[rr], o2), max(m1[rr], o1));
        m1[rr] = min(m1[rr], o1);
      }
    }
  }
};

// --- the engine ------------------------------------------------------------
//
// Three parts, each usable alone: the one-hot A fragments of the thread's two
// rows (load_a), the product loop over a ring of bulk copies (product_loop),
// and what is done with each sub-tile's counts (a visitor).  count_top2 puts
// them together for kernels #1 and #2; the kernel lab's kernels
// (csrc/lab_mma.cuh) walk the table differently and visit with their own
// stream updates.

// The A fragments of the whole depth KP = 32 * NK1 (at most 128: L <= 32 at
// 4 classes, L <= 8 at 16) for rows r_lo and r_hi = r_lo + 8.  A row >= b
// reads as codes or masks of 0; its counts are never written.
template <int NK1, int CLASSES = 4>
__device__ __forceinline__ void load_a(const uint8_t* __restrict__ obs,
                                       int64_t b, int width, int length,
                                       int64_t r_lo, int64_t r_hi, int t,
                                       uint32_t (&a)[NK1][4]) {
  if constexpr (CLASSES == 16) {
    // one nib4 byte per k32 step, NK1 <= 4 bytes
    const uint32_t lo = r_lo < b ? nib4_word(obs + r_lo * width, width, 0) : 0u;
    const uint32_t hi = r_hi < b ? nib4_word(obs + r_hi * width, width, 0) : 0u;
#pragma unroll
    for (int ks = 0; ks < NK1; ++ks)
      a_frag16(a[ks], lo >> (8 * ks), hi >> (8 * ks), t);
    return;
  }
  uint32_t lo[NK1], hi[NK1];
#pragma unroll
  for (int ks = 0; ks < NK1; ++ks) lo[ks] = hi[ks] = 0u;
  if (r_lo < b) onehot_words<NK1>(obs + r_lo * width, width, length, lo);
  if (r_hi < b) onehot_words<NK1>(obs + r_hi * width, width, length, hi);
#pragma unroll
  for (int ks = 0; ks < NK1; ++ks) a_frag(a[ks], lo[ks], hi[ks], t);
}

// The product loop: for every step s of `src` and every sub-tile j of the
// step, the counts of the CTA's 128 rows against the sub-tile's N columns at
// depth KP = 32 * NK1, handed to `vis`.
//
//   Source   which blocks of the tiled table step s is:
//            int steps();
//            int subs(int s): the sub-tiles of N columns x KP bytes of step
//            s, 1 .. STAGE_SUBS;
//            void load(int s, uint32_t dst, uint32_t bar, uint32_t
//            sub_bytes): start the bulk copies of step s's sub-tiles to
//            consecutive `sub_bytes` at shared address `dst`, counted at
//            `bar` (one mbar_expect of their bytes).
//   Visitor  void visit(int32_t (&acc)[N / 2], int s, int j): the thread's
//            counts (rows g and g + 8 of its warp's 16, columns 8jj + 2t + e
//            of the sub-tile; wgmma_s8 has the order) after the product has
//            completed.  It must read `acc` behind fence_acc.
//
// `ring` is RING * STAGE_SUBS * N * KP bytes of shared memory, 128-byte
// aligned.  Thread 0 starts a step's copies, those of the next steps in
// flight while step s is multiplied; the CTA meets at a barrier once per
// step, which frees the slot of step s - 1.
template <int NK1, int N, int STAGE_SUBS, int RING, class Source,
          class Visitor>
__device__ __forceinline__ void product_loop(const uint32_t (&a)[NK1][4],
                                             const Source& src, uint8_t* ring,
                                             Visitor& vis) {
  static_assert(RING >= 2 && RING <= kMaxRing, "one mbarrier per slot");
  constexpr int kSubBytes = N * 32 * NK1;
  constexpr int kStageBytes = STAGE_SUBS * kSubBytes;
  constexpr int kRing = RING;
  constexpr uint32_t kSbo = 2 * NK1 * 128;
  __shared__ __align__(8) uint64_t bars[kMaxRing];
  const uint32_t sbase = smem_u32(ring);
  if (threadIdx.x == 0) mbar_init(bars, kMaxRing);
  __syncthreads();  // the mbarriers are initialized
  const int n_steps = src.steps();
  auto fill = [&](int s) {  // thread 0
    src.load(s, sbase + (s % kRing) * kStageBytes, smem_u32(bars + s % kRing),
             kSubBytes);
  };
  if (threadIdx.x == 0)
    for (int s = 0; s < kRing - 1 && s < n_steps; ++s) fill(s);
  int32_t acc[N / 2];
  for (int s = 0; s < n_steps; ++s) {
    mbar_wait(smem_u32(bars + s % kRing), (s / kRing) & 1);
    __syncthreads();  // step s has landed; step s - 1 has been multiplied
    if (threadIdx.x == 0 && s + kRing - 1 < n_steps) fill(s + kRing - 1);
    const int nsub = src.subs(s);
    const uint32_t st = sbase + (s % kRing) * kStageBytes;
    // not unrolled: a product under a branch of its own makes ptxas
    // serialize it (C7520)
#pragma unroll 1
    for (int j = 0; j < nsub; ++j) {
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < NK1; ++ks)
        wgmma_s8<N>(acc, a[ks], b_desc(st + j * kSubBytes + ks * 256, kSbo),
                    ks);
      wgmma_commit();
      wgmma_wait<0>();
      vis.visit(acc, s, j);
    }
  }
}

// Source of kernels #1 and #2: consecutive stages of kStageSubs sub-tiles of
// the `n_cols` columns from `base` on (the table at column c_begin; K_pad <
// 2^31 keeps the offsets in an int); a stage is one contiguous copy.
struct ColumnStages {
  static constexpr int kStageCols = kStageSubs * kSub;
  const uint8_t* base;
  int kp, n_cols;
  __device__ __forceinline__ int steps() const {
    return (n_cols + kStageCols - 1) / kStageCols;
  }
  __device__ __forceinline__ int subs(int s) const {
    return min(kStageCols, n_cols - s * kStageCols) / kSub;
  }
  __device__ __forceinline__ void load(int s, uint32_t dst, uint32_t bar,
                                       uint32_t sub_bytes) const {
    bulk_load(dst, base + (int64_t)s * kStageCols * kp,
              (uint32_t)subs(s) * sub_bytes, bar);
  }
};

// Visitor of kernels #1 and #2: the running top-2 over ColumnStages' columns.
struct Top2Visitor {
  RowTop2& top;
  const int64_t c_begin;
  const int t;
  __device__ __forceinline__ void visit(int32_t (&acc)[64], int s, int j) {
    top.visit(acc, c_begin + (s * kStageSubs + j) * kSub, t);
  }
};

// The two smallest keys of each of the CTA's 128 rows over columns
// [c_begin, c_end) (multiples of 128, c_end <= K_pad; columns >= k masked).
// `smem` is the kernel's dynamic shared memory, 128-byte aligned.  On return
// every lane holds its rows' folded pairs in `top`; rows are row0 +
// warp_in_cta * 16 + (lane >> 2) and that + 8.
//
// MULTI = false: NK1 k32 steps, the whole depth (KP = 32 * NK1 <= 128) is
// one slice and A stays in registers.  MULTI = true: KP is a multiple of 128
// above 128, stored in slices of 128 bytes, and walked in stages of
// kWalkSlices slices (a 32 KB copy; a sub-tile's last stage holds one slice
// where KP / 128 is odd) with each row's A source in shared memory at
// kBitStride words a row: at 4 classes the one-hot bit words (four a slice),
// at 16 the nib4 words (one a slice), at most 32 words at L <= 255 (KP <=
// 1,024 or 4,096).  NK1 = 8: KP is 256, one stage a sub-tile, and the A
// fragments are built once for the CTA; NK1 = 4: deeper, they are built for
// every stage.  A sub-tile's stages multiply into one accumulator set, each
// waited for once (its slot is then free).  No CTA-wide barrier in the
// walk: the warp that finishes a stage last starts the copy of the stage
// kWalkRing on into its slot, so the two warpgroups drift apart.
template <int NK1, bool MULTI, int CLASSES>
__device__ __forceinline__ void count_top2(const uint8_t* __restrict__ obs,
                                           int64_t b, int width, int length,
                                           const uint8_t* __restrict__ table,
                                           int kp, int64_t c_begin,
                                           int64_t c_end, int64_t row0,
                                           uint8_t* smem, RowTop2& top) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  if constexpr (!MULTI) {
    const int64_t r_lo = row0 + warp * 16 + g;
    uint32_t a[NK1][4];
    load_a<NK1, CLASSES>(obs, b, width, length, r_lo, r_lo + 8, t, a);
    const ColumnStages src{table + c_begin * kp, kp, (int)(c_end - c_begin)};
    Top2Visitor vis{top, c_begin, t};
    product_loop<NK1, kSub, kStageSubs, ring_stages(NK1)>(a, src, smem, vis);
  } else {
    static_assert(NK1 == 4 || NK1 == 8, "the walk's two instantiations");
    constexpr bool kKeepA = NK1 == 8;
    constexpr int kStageBytes = kWalkSlices * kSliceBytes;
    constexpr uint32_t kSbo = 8 * 128;  // a slice's 8 core matrices
    __shared__ __align__(8) uint64_t full[kWalkRing];
    __shared__ uint32_t done[kWalkRing];  // warps through the slot, all uses
    const uint32_t sbase = smem_u32(smem);
    if (threadIdx.x == 0) {
      mbar_init(full, kWalkRing);
      for (int i = 0; i < kWalkRing; ++i) done[i] = 0u;
    }
    int32_t acc[64];
    const int n_slices = kKeepA ? 2 : kp / 128;
    const int n_groups = kKeepA ? 1 : (n_slices + kWalkSlices - 1) / kWalkSlices;
    // words per row, <= 32: one-hot bit words, or nib4 words
    const int nw = CLASSES == 16 ? n_slices : n_slices * 4;
    uint32_t* bits =
        reinterpret_cast<uint32_t*>(smem + kWalkRing * kStageBytes);
    for (int q = threadIdx.x; q < kRows * nw; q += kThreads) {
      const int r = q / nw, w = q - r * nw;
      const uint8_t* o = obs + (row0 + r) * width;
      if constexpr (CLASSES == 16)
        bits[r * kBitStride + w] = row0 + r < b ? nib4_word(o, width, w) : 0u;
      else
        bits[r * kBitStride + w] = row0 + r < b ? onehot_word(o, length, w) : 0u;
    }
    __syncthreads();  // the mbarriers are initialized, the bit words written
    // stage u = (sub-tile u / n_groups, slices 2 (u % n_groups) ..): the
    // sub-tile's slices are consecutive 16 KB blocks of the table; a CTA's
    // stages fit an int (2^23 / 128 sub-tiles x 16 stages at most)
    const int n_stages = (int)((c_end - c_begin) / kSub) * n_groups;
    // the copy of stage u into `slot`, where `pred`
    auto fill_if = [&](int pred, int u, int slot) {
      const int sub = u / n_groups;
      const int s0 = (u - sub * n_groups) * kWalkSlices;
      bulk_load_if(pred, sbase + slot * kStageBytes,
                   table + c_begin * kp +
                       ((int64_t)sub * n_slices + s0) * kSliceBytes,
                   (uint32_t)min(kWalkSlices, n_slices - s0) * kSliceBytes,
                   smem_u32(full + slot));
    };
    if (threadIdx.x == 0)
      for (int s = 0; s < kWalkRing && s < n_stages; ++s) fill_if(1, s, s);
    const uint32_t* lo_bits = bits + (warp * 16 + g) * kBitStride;
    const uint32_t* hi_bits = lo_bits + 8 * kBitStride;
    uint32_t a[2 * 4][4];
    if constexpr (kKeepA) walk_frags<CLASSES>(a, lo_bits, hi_bits, 0, 2, t);
    int slot = 0, gi = 0, off = 0;
    uint32_t parity = 0u;
    // not unrolled: a product under a branch of its own makes ptxas
    // serialize it (C7520)
#pragma unroll 1
    for (int u = 0; u < n_stages; ++u) {
      if constexpr (!kKeepA)
        walk_frags<CLASSES>(a, lo_bits, hi_bits, gi * kWalkSlices, n_slices, t);
      mbar_wait(smem_u32(full + slot), parity);
      const uint32_t st = sbase + slot * kStageBytes;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 2 * 4; ++ks)
        wgmma_s8<kSub>(acc, a[ks],
                       b_desc(st + (ks >> 2) * kSliceBytes + (ks & 3) * 256, kSbo),
                       (gi | ks) != 0);
      wgmma_commit();
      wgmma_wait<0>();
      // the warp's products have read the stage: the warp through the slot
      // last starts the copy of the stage kWalkRing on into it
      const uint32_t before = count_in(done + slot, lane);
      fill_if(lane == 0 && before % kWarps == kWarps - 1 &&
                  u + kWalkRing < n_stages,
              u + kWalkRing, slot);
      if (++gi == n_groups) {
        top.visit(acc, c_begin + off, t);
        gi = 0;
        off += kSub;
      }
      if (++slot == kWalkRing) {
        slot = 0;
        parity ^= 1u;
      }
    }
  }
  top.fold_quad();
}

// The depth KP the table carries for barcode length `length` at `classes`
// one-hot classes per position.
inline int depth_of(int length, int classes) {
  const int d = (classes * length + 31) / 32 * 32;
  return d <= 128 ? d : (d + 127) / 128 * 128;
}

// --- pass 1 of both kernels -------------------------------------------------

// What a pass-1 launch is given.  `partial` is [2, n_chunks, B] int32; the
// three outputs are written by pass 1 only where the scheme says so.
struct Pass1Args {
  const uint8_t* obs;
  int64_t b;
  int width, length;
  const uint8_t* table;
  int kp;
  int64_t k, cols_per_cta, n_row_tiles;
  int n_chunks, shift;
  int32_t *partial, *best, *idx, *next;
};

// CTA = 128 rows x one of `n_chunks` column ranges of `cols_per_cta` columns.
// blockIdx runs over the row tiles of one chunk first, so the CTAs in flight
// walk the same columns.  Scheme::kLocalKeys: keys hold the column inside
// the chunk (else the global column); Scheme::emit(args, chunk, row, m1, m2)
// writes a row's pair.  CLASSES: the input form (4 bit2, 16 nib4).
template <class Scheme, int NK1, bool MULTI, int CLASSES>
__global__ void __launch_bounds__(kThreads, 2) top2_pass1(const Pass1Args a) {
  extern __shared__ __align__(128) uint8_t smem[];
  const int64_t row_tile = blockIdx.x % a.n_row_tiles;
  const int64_t chunk = blockIdx.x / a.n_row_tiles;
  const int64_t k_sub = (a.k + kSub - 1) / kSub * kSub;
  const int64_t c_begin = chunk * a.cols_per_cta;
  const int64_t c_end = min(k_sub, c_begin + a.cols_per_cta);
  const int64_t row0 = row_tile * kRows;

  RowTop2 top(a.shift, Scheme::kLocalKeys ? c_begin : 0, a.k);
  count_top2<NK1, MULTI, CLASSES>(a.obs, a.b, a.width, a.length, a.table,
                                  a.kp, c_begin, c_end, row0, smem, top);

  const int lane = threadIdx.x & 31;
  if ((lane & 3) != 0) return;
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int64_t row = row0 + (threadIdx.x >> 5) * 16 + (lane >> 2) + 8 * rr;
    if (row < a.b) Scheme::emit(a, chunk, row, top.m1[rr], top.m2[rr]);
  }
}

// The attributes a pass-1 instantiation launches with: dynamic shared memory
// above 48 KB and, for the walk's two CTAs an SM, the largest shared-memory
// carveout.
template <class Kernel>
cudaError_t pass1_attributes(Kernel kern, int smem, bool multi) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
  }
  if (!multi) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <class Scheme, int NK1, bool MULTI, int CLASSES>
cudaError_t launch_pass1_at(const Pass1Args& a, cudaStream_t s) {
  constexpr int kSmem = smem_bytes(NK1, MULTI);
  auto kern = top2_pass1<Scheme, NK1, MULTI, CLASSES>;
  const cudaError_t e = pass1_attributes(kern, kSmem, MULTI);
  if (e != cudaSuccess) return e;
  kern<<<(unsigned)(a.n_row_tiles * a.n_chunks), kThreads, kSmem, s>>>(a);
  return cudaGetLastError();
}

template <class Scheme, int CLASSES>
cudaError_t launch_pass1_depth(const Pass1Args& a, cudaStream_t s) {
  switch (a.kp) {
    case 32: return launch_pass1_at<Scheme, 1, false, CLASSES>(a, s);
    case 64: return launch_pass1_at<Scheme, 2, false, CLASSES>(a, s);
    case 96: return launch_pass1_at<Scheme, 3, false, CLASSES>(a, s);
    case 128: return launch_pass1_at<Scheme, 4, false, CLASSES>(a, s);
    case 256: return launch_pass1_at<Scheme, 8, true, CLASSES>(a, s);
    default: return launch_pass1_at<Scheme, 4, true, CLASSES>(a, s);
  }
}

// Pass 1 at the instantiation the input form and the table's depth ask for.
template <class Scheme>
cudaError_t launch_pass1(const Pass1Args& a, int classes, cudaStream_t s) {
  return classes == 16 ? launch_pass1_depth<Scheme, 16>(a, s)
                       : launch_pass1_depth<Scheme, 4>(a, s);
}

// What the card makes of the sliced walk's pass-1 instantiation at depth
// KP (> 128), with the attributes it launches with: out[0] registers a
// thread, [1] static and [2] dynamic shared bytes, [3] CTAs an SM holds at
// once (cudaOccupancyMaxActiveBlocksPerMultiprocessor), [4] local (spill)
// bytes a thread, [5] the stages of its ring.
template <class Scheme, int NK1, int CLASSES>
cudaError_t walk_info_at(int32_t* out) {
  constexpr int kSmem = smem_bytes(NK1, true);
  auto kern = top2_pass1<Scheme, NK1, true, CLASSES>;
  cudaError_t e = pass1_attributes(kern, kSmem, true);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, kern);
  if (e != cudaSuccess) return e;
  int ctas = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kern, kThreads,
                                                    kSmem);
  if (e != cudaSuccess) return e;
  out[0] = fa.numRegs;
  out[1] = (int32_t)fa.sharedSizeBytes;
  out[2] = kSmem;
  out[3] = ctas;
  out[4] = (int32_t)fa.localSizeBytes;
  out[5] = kWalkRing;
  return cudaSuccess;
}

// walk_info_at of the instantiation a launch at (classes, kp) runs, as
// launch_pass1_depth picks it; -1 for a depth the walk does not take.
template <class Scheme>
int walk_info(int classes, int kp, int32_t* out) {
  if ((classes != 4 && classes != 16) || kp <= 128 ||
      kp > depth_of(255, classes) || kp % 128 != 0)
    return -1;
  if (classes == 16)
    return (int)(kp == 256 ? walk_info_at<Scheme, 8, 16>(out)
                           : walk_info_at<Scheme, 4, 16>(out));
  return (int)(kp == 256 ? walk_info_at<Scheme, 8, 4>(out)
                         : walk_info_at<Scheme, 4, 4>(out));
}

// The checks both entry points make of their arguments: 0, or the negative
// code the entry point returns (-1 a shape, -2 the table's alignment, -3 a
// grid beyond 2^31 - 1 CTAs).  `classes`: 4 (bit2 rows) or 16 (nib4 rows).
inline int check_args(int64_t b, int width, const void* table, int64_t k_pad,
                      int kp, int64_t k, int length, int classes, int n_chunks,
                      int64_t cols_per_cta) {
  if (classes != 4 && classes != 16) return -1;
  const int row_bytes = classes == 16 ? (length + 1) / 2 : (length + 3) / 4;
  if (b <= 0 || k < 1 || length < 1 || length > 255 || width != row_bytes ||
      kp != depth_of(length, classes) || k_pad < k ||
      k_pad % kSub != 0 || n_chunks < 1 || cols_per_cta < kSub ||
      cols_per_cta % kSub != 0 || n_chunks * cols_per_cta < k ||
      (n_chunks - 1) * cols_per_cta >= k)
    return -1;
  if ((reinterpret_cast<uintptr_t>(table) & 15u) != 0) return -2;
  if ((b + kRows - 1) / kRows * n_chunks > 0x7fffffffLL) return -3;
  return 0;
}

}  // namespace mmac
}  // namespace
