// Exact-for-gating top-2 over int8 clamped counts for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel #7 of scripts/kernel_lab.py: the
// v3_clamp8 / v3w_clamp8 body `kern` at :453-508 that `make_variant` ->
// `go_raw` launches (pl.pallas_call at :515).  For every read row, K tile
// kb and column position p, with count = mismatches against column
// kb * tile_k + p of the lab's table (pad columns count L):
//   c8 = min(count, W)   (W = max_mm + max(delta, 1) + 1)
//   prev = m1[p]; better = c8 < prev
//   m1[p] = better ? c8 : prev; t1[p] = better ? kb : t1[p]
//   m2[p] = min(m2[p], max(prev, c8))
// over two int8 streams initialised to W and a uint8 first-tile stream
// initialised to 0 (at most 255 K tiles); then the emit of :484-508 over
// ext1 = (m1[p] * nt_pow2 + t1[p]) * tile_k + p: best, idx and next with
// counts clamped at W, bit for bit (lab_kernels.clamp8_top2_reference is
// the plain version).  v3w_clamp8 differs from v3_clamp8 on the TPU only in
// the MXU's output type (int8 instead of int32); wgmma's s8 product
// accumulates in s32 only, so both names run this kernel.
//
// Design (csrc/lab_mma.cuh has the walk, the table and the streams' layout).
// Counts come from the tensor-core engine of csrc/mma_count.cuh: CTA = 128
// rows x N = 128 column positions, one wgmma group per K tile.  The three
// byte streams take 3 x 16 KB of shared memory beside a ring of three steps
// of two 8 KB K tiles (L 16): 96 KB, two CTAs (four warpgroups) per SM.
// Every step reads and writes all three streams, 16 positions per 128-bit
// access.
//
// The update runs in packed 16-bit lanes (DPX min / max, one instruction
// per two positions), not one position at a time.  Since kb ascends and a
// tie keeps the first tile, the pair (m1, t1) under `better = c8 < prev` is
// the minimum of the lexicographic key c8 * 256 + kb (W <= 127 and kb <= 255
// keep it a positive int16; the initial (W, 0) is the key W * 256): one
// 16x2 min updates both streams, which stay one int8 and one uint8 stream
// in shared memory.  Likewise max(prev, c8) is the high byte of the max of
// the two keys, and m2 (<= W <= 127) compares as m2 * 256 + anything.  Per
// word of four positions: 2 PRMT (counts * 256 into lanes), 2 adds (+ kb), 2
// PRMT (m1, t1 bytes -> keys), 1 shift (m2), 6 DPX min / max (the clamp at
// W * 256 + kb rides the three-input min), 3 PRMT (keys -> bytes): 16
// integer instructions, beside 6 B of stream traffic per position.
//
// What bounds it on this card: the operations bound is that of the product
// (2 * B * k_padded * KP int8 at 1,979 TOP/s); the streams (6 B per pair
// through shared memory at 128 B per clock and SM, plus wgmma's B reads) and
// the packed update (4 integer instructions per pair on 64 lanes per clock
// and SM) both sit at about a third of that rate, so the design's cost shows.
//
// Launch contract: launches on the caller's stream, allocates nothing,
// returns cudaGetLastError() (negative on a rejected argument).

#include "lab_common.cuh"
#include "lab_mma.cuh"

namespace {

using namespace labm;

struct Clamp8 : TwoTileSteps {
  static constexpr int kStreamBytes = 3;  // m1, m2 int8 and t1 uint8
  static constexpr int kMaxWidth = 128;
  struct Params {
    int w_clamp, nt_pow2;
  };

  template <int N>
  struct Visitor {
    static constexpr int kChunks = N / 32;      // per thread and stream
    static constexpr int kStream = kRows * N;   // bytes of one stream
    const uint32_t m1s, m2s, t1s;
    const Params p;
    const int s0, tile_k, t;

    __device__ Visitor(uint32_t streams, const Params& p_, int s0_,
                       int tile_k_, int t_)
        : m1s(streams), m2s(streams + kStream), t1s(streams + 2 * kStream),
          p(p_), s0(s0_), tile_k(tile_k_), t(t_) {}

    __device__ __forceinline__ void init() {
      const uint32_t w4 = (uint32_t)p.w_clamp * 0x01010101u;
      fill_stream(m1s, kChunks, w4);
      fill_stream(m2s, kChunks, w4);
      fill_stream(t1s, kChunks, 0u);
    }

    __device__ __forceinline__ void visit(int32_t (&acc)[N / 2], int kb) {
      fence_acc(acc);
      const uint32_t kb2 = (uint32_t)kb * 0x00010001u;
      const uint32_t wkb = (uint32_t)p.w_clamp * 0x01000100u + kb2;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        Word4 m1 = lds128(chunk_addr(m1s, c));
        Word4 t1 = lds128(chunk_addr(t1s, c));
        Word4 m2 = lds128(chunk_addr(m2s, c));
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int rr = WordAt<N>::rr(4 * c + w);
          const int ja = WordAt<N>::ja(4 * c + w);
          const int ia = 4 * ja + 2 * rr, ib = 4 * (ja + 1) + 2 * rr;
          // lanes of "0": bytes 0 and 2 of the word, positions (ja, e0) and
          // (ja + 1, e0); of "1": bytes 1 and 3, (ja, e1) and (ja + 1, e1).
          // count * 256 per lane (byte 3 of a count is 0) + kb: this step's
          // key before its clamp at W * 256 + kb
          const uint32_t x0 = __byte_perm(acc[ia], acc[ib], 0x4703) + kb2;
          const uint32_t x1 =
              __byte_perm(acc[ia + 1], acc[ib + 1], 0x4703) + kb2;
          // the running keys m1 * 256 + t1 from the two byte streams, and
          // their minimum with the clamped key
          const uint32_t p0 = __byte_perm(m1.w[w], t1.w[w], 0x2604);
          const uint32_t p1 = __byte_perm(m1.w[w], t1.w[w], 0x3715);
          const uint32_t n0 = __vimin3_s16x2(p0, x0, wkb);
          const uint32_t n1 = __vimin3_s16x2(p1, x1, wkb);
          // m2 in the high byte of each lane (the low byte does not matter)
          // against max(prev, count), the high byte of the larger key: m2
          // never exceeds W, so the count needs no clamp here
          const uint32_t s0_ = min16x2(m2.w[w] << 8, max16x2(p0, x0));
          const uint32_t s1_ = min16x2(m2.w[w], max16x2(p1, x1));
          m1.w[w] = __byte_perm(n0, n1, 0x7351);
          t1.w[w] = __byte_perm(n0, n1, 0x6240);
          m2.w[w] = __byte_perm(s0_, s1_, 0x7351);
        }
        sts128(chunk_addr(m1s, c), m1);
        sts128(chunk_addr(t1s, c), t1);
        sts128(chunk_addr(m2s, c), m2);
      }
    }

    // The body's emit over the thread's positions, the quad's fold, and the
    // rows' partials.
    __device__ __forceinline__ void emit(const LabArgs& a, int slice,
                                         int64_t r_lo, int64_t r_hi) {
      lab::Top2Keys k[2];
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const Word4 m1 = lds128(chunk_addr(m1s, c));
        const Word4 t1 = lds128(chunk_addr(t1s, c));
        const Word4 m2 = lds128(chunk_addr(m2s, c));
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int rr = WordAt<N>::rr(4 * c + w);
          const int ja = WordAt<N>::ja(4 * c + w);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int32_t v1 = (int8_t)(m1.w[w] >> (8 * q));
            const int32_t tt = (uint8_t)(t1.w[w] >> (8 * q));
            const int32_t v2 = (int8_t)(m2.w[w] >> (8 * q));
            const int pos = s0 + 8 * (ja + (q >> 1)) + 2 * t + (q & 1);
            k[rr].add((v1 * p.nt_pow2 + tt) * tile_k + pos);
            k[rr].m2c = min(k[rr].m2c, v2);
          }
        }
      }
      lab::emit_top2(k, a.partial, a.tile_k / N, slice, a.b, r_lo, r_hi, t);
    }
  };
};

}  // namespace

extern "C" int fqtk_clamp8_top2(const void* obs, int64_t b, int width,
                                const void* table, int kp, int length,
                                int tile_k, int n_k_tiles, int w_clamp,
                                int nt_pow2, void* partial, void* best,
                                void* idx, void* next, void* stream) {
  int64_t n_row_tiles = 0;
  const int rc = check_lab_args(b, width, table, kp, length, tile_k, n_k_tiles,
                                lab_width<Clamp8>(tile_k), &n_row_tiles);
  if (rc != 0) return rc;
  if (w_clamp < 1 || w_clamp > 127 || n_k_tiles > 255 ||
      nt_pow2 < n_k_tiles || (nt_pow2 & (nt_pow2 - 1)))
    return -1;
  int32_t* part = static_cast<int32_t*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LabArgs args{static_cast<const uint8_t*>(obs), b, width, length,
                     static_cast<const uint8_t*>(table), kp, tile_k,
                     n_k_tiles, n_row_tiles, part};
  const cudaError_t e =
      launch_lab<Clamp8>(args, Clamp8::Params{w_clamp, nt_pow2}, s);
  if (e != cudaSuccess) return (int)e;
  return lab::launch_top2_fold(part, b, tile_k / lab_width<Clamp8>(tile_k),
                               tile_k, nt_pow2, best, idx, next, s);
}
