// Exact-for-gating top-2 over int16 clamped keys for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel #5 of scripts/kernel_lab.py: the
// v5_clamp16 body `kern` at :263-307 that `make_variant` -> `go_raw`
// launches (pl.pallas_call at :314).  For every read row, K tile kb and
// column position p, with count = mismatches against column kb * tile_k + p
// of the lab's table (pad columns count L):
//   key = min(count, W) * nt_pow2 + kb        (int16; W = max_mm +
//         max(delta, 1) + 1, nt_pow2 = 2^max(1, bitlen(n_k_tiles - 1)))
//   prev = m1[p]; m1[p] = min(prev, key); m2[p] = min(m2[p], max(prev, key))
// over two int16 streams initialised to W * nt_pow2 + nt_pow2 - 1; then the
// emit of :290-307 over ext1 = m1[p] * tile_k + p: best, idx and next with
// counts clamped at W, bit for bit (lab_kernels.clamp16_top2_reference is
// the plain version).  Clamping never changes a gate decision or the
// winning index (docs/DESIGN.md).
//
// Design (csrc/lab_mma.cuh has the walk, the table and the streams' layout).
// Counts come from the tensor-core engine of csrc/mma_count.cuh: CTA = 128
// rows x N = 128 column positions, one wgmma group per K tile.  The two
// int16 streams take 2 x 32 KB of shared memory beside a ring of three steps
// of two 8 KB K tiles (L 16): 112 KB, two CTAs (four warpgroups) per SM.
// Every step reads and writes both streams, 8 positions per 128-bit access.
//
// The update runs in 16x2 lanes.  A thread's counts of one row come in
// pairs of positions (8j + 2t, 8j + 2t + 1), acc[4j + 2rr] and acc[4j + 2rr
// + 1]: one 32-bit word of each stream holds that pair (lab_mma.cuh
// HalfAt).  Per word: 1 PRMT packs the two counts into lanes, a DPX min
// clamps them at W (before the scale: count * nt_pow2 may pass 16 bits, the
// clamped key never does, W * nt_pow2 + nt_pow2 - 1 < 2^15), 1 IMAD gives
// key = c * nt_pow2 + kb in both lanes (no carry between them), and three
// DPX min / max update m1 and m2: 6 integer instructions per 2 positions.
//
// What bounds it on this card: the operations bound is that of the product
// (2 * B * k_padded * KP int8 at 1,979 TOP/s); the streams are 8 B per pair
// through shared memory (128 B per clock and SM) beside wgmma's own B reads,
// the same as lab_probe's v1_m1only, and they bind before the integer lanes
// (3 instructions per pair on 64 lanes per clock and SM).
//
// Launch contract: launches on the caller's stream, allocates nothing,
// returns cudaGetLastError() (negative on a rejected argument).

#include "lab_common.cuh"
#include "lab_mma.cuh"

namespace {

using namespace labm;

struct Clamp16 : TwoTileSteps {
  static constexpr int kStreamBytes = 4;  // m1, m2 int16
  static constexpr int kMaxWidth = 128;
  struct Params {
    int w_clamp, nt_pow2;
  };

  template <int N>
  struct Visitor {
    static constexpr int kChunks = N / 16;         // per thread and stream
    static constexpr int kStream = kRows * N * 2;  // bytes of one stream
    const uint32_t m1s, m2s;
    const Params p;
    const int s0, tile_k, t;

    __device__ Visitor(uint32_t streams, const Params& p_, int s0_,
                       int tile_k_, int t_)
        : m1s(streams), m2s(streams + kStream), p(p_), s0(s0_),
          tile_k(tile_k_), t(t_) {}

    __device__ __forceinline__ void init() {
      const uint32_t kinit =
          (uint32_t)(p.w_clamp * p.nt_pow2 + p.nt_pow2 - 1) * 0x00010001u;
      fill_stream(m1s, kChunks, kinit);
      fill_stream(m2s, kChunks, kinit);
    }

    __device__ __forceinline__ void visit(int32_t (&acc)[N / 2], int kb) {
      fence_acc(acc);
      const uint32_t kb2 = (uint32_t)kb * 0x00010001u;
      const uint32_t w2 = (uint32_t)p.w_clamp * 0x00010001u;
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        Word4 m1 = lds128(chunk_addr(m1s, c));
        Word4 m2 = lds128(chunk_addr(m2s, c));
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int ia = 4 * HalfAt<N>::j(4 * c + w) + 2 * HalfAt<N>::rr(4 * c + w);
          const uint32_t key =
              min16x2(lanes16(acc[ia], acc[ia + 1]), w2) * (uint32_t)p.nt_pow2 + kb2;
          const uint32_t prev = m1.w[w];
          m1.w[w] = min16x2(prev, key);
          m2.w[w] = min16x2(m2.w[w], max16x2(prev, key));
        }
        sts128(chunk_addr(m1s, c), m1);
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
        const Word4 m2 = lds128(chunk_addr(m2s, c));
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int rr = HalfAt<N>::rr(4 * c + w), jj = HalfAt<N>::j(4 * c + w);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int32_t v1 = (int16_t)(m1.w[w] >> (16 * e));
            const int32_t v2 = (int16_t)(m2.w[w] >> (16 * e));
            k[rr].add(v1 * tile_k + s0 + 8 * jj + 2 * t + e);
            k[rr].m2c = min(k[rr].m2c, v2 / p.nt_pow2);
          }
        }
      }
      lab::emit_top2(k, a.partial, a.tile_k / N, slice, a.b, r_lo, r_hi, t);
    }
  };
};

}  // namespace

extern "C" int fqtk_clamp16_top2(const void* obs, int64_t b, int width,
                                 const void* table, int kp, int length,
                                 int tile_k, int n_k_tiles, int w_clamp,
                                 int nt_pow2, void* partial, void* best,
                                 void* idx, void* next, void* stream) {
  int64_t n_row_tiles = 0;
  const int rc = check_lab_args(b, width, table, kp, length, tile_k, n_k_tiles,
                                lab_width<Clamp16>(tile_k), &n_row_tiles);
  if (rc != 0) return rc;
  if (w_clamp < 1 || nt_pow2 < n_k_tiles || (nt_pow2 & (nt_pow2 - 1)) ||
      (int64_t)w_clamp * nt_pow2 + nt_pow2 - 1 >= (1 << 15))
    return -1;
  int32_t* part = static_cast<int32_t*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LabArgs args{static_cast<const uint8_t*>(obs), b, width, length,
                     static_cast<const uint8_t*>(table), kp, tile_k,
                     n_k_tiles, n_row_tiles, part};
  const cudaError_t e =
      launch_lab<Clamp16>(args, Clamp16::Params{w_clamp, nt_pow2}, s);
  if (e != cudaSuccess) return (int)e;
  return lab::launch_top2_fold(part, b, tile_k / lab_width<Clamp16>(tile_k),
                               tile_k, nt_pow2, best, idx, next, s);
}
