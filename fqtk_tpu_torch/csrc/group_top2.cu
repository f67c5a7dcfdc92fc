// Exact top-2 with a register pre-merge over P K tiles, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel #6 of scripts/kernel_lab.py: the
// v6_group{P} body `kern` at :360-412 that `make_variant` -> `go_raw`
// launches (pl.pallas_call at :419).  For every read row and column
// position p, the K tiles are taken P at a time (group jb):
//   key_q = count(tile jb*P + q, p) * nt_pow2 + (jb*P + q),  q < P
//   (lo1, lo2) = the register top-2 of the P keys (a min/max ladder)
//   prev = m1[p]; m1[p] = min(prev, lo1)
//   m2[p] = min(m2[p], min(max(prev, lo1), lo2))
// over two int32 streams initialised to 2^30 (count = mismatches against
// the lab table's column, pad columns counting L; nt_pow2 =
// 2^max(1, bitlen(n_k_tiles - 1))); then the emit of :393-412 over
// ext1 = m1[p] * tile_k + p: the exact (best, idx, next) over all k_padded
// columns in (count, index) order, bit for bit
// (lab_kernels.group_top2_reference is the plain version).  Instantiated
// for P = 2, 4 and 8.
//
// Design (csrc/lab_mma.cuh has the walk, the table and the streams' layout).
// Counts come from the tensor-core engine of csrc/mma_count.cuh, one wgmma
// group per K tile into ONE accumulator set (two sets per warpgroup make
// ptxas serialize the products).  Each K tile's keys are folded into the
// registers (lo1, lo2) as it arrives, by the body's ladder step (hi =
// max(lo1, key); lo1 = min(lo1, key); lo2 = min(lo2, hi), from lo1 = lo2 =
// the largest key value: the first step of a group gives the body's
// min/max of keys 0 and 1, so the pair is the same top-2); the shared
// streams are read and written once per group, after its last K tile (a
// test on kb, uniform across the CTA), and the registers reset.
//
// Registers set the width.  A thread holds N/2 counts of a K tile and N/2
// positions of (lo1, lo2).  Where every key fits 15 bits (L * nt_pow2 +
// nt_pow2 - 1 < 2^15: at the lab's L 16, tile_k 2,048, K 737,280 the largest
// key is 8,703) the pair lives in 16x2 lanes, N/4 words each, at N = 64:
// 32 counts + 32 words.  Otherwise it lives in int32 at N = 32.  The int32
// streams are 8 bytes per (row, position): 64 KB at N 64 beside a ring of
// three steps of four 4 KB K tiles (L 16), so two CTAs (four warpgroups)
// share an SM.  Half-width CTAs pay the CTA barrier per step on half the
// pairs: four K tiles a step instead of the lab's two took 10-12% off P 4
// and 8 at the lab's shape (PERF.md, §6).
//
// Per K tile and word of two positions (16x2 lanes): 1 PRMT packs the two
// counts, 1 IMAD gives count * nt_pow2 + kb in both lanes, 3 DPX min / max
// fold them: 2.5 integer instructions per pair; per group and position, 1
// PRMT unpacks lo1 and lo2 each, then 1 min and 1 max plus a three-input
// min update the streams.  The streams are 16 / P bytes per pair and K tile.
// What bounds it on this card: the product's operations (2 * B * k_padded *
// KP int8 at 1,979 TOP/s) are under both the streams (shared memory, 128 B
// per clock and SM, beside wgmma's own B reads) and the integer lanes (64
// per clock and SM).  A warpgroup waits for its product before it folds,
// and the fold and the group's stream update do not overlap: their costs
// add (t ~ a + b / P at the lab's shape, PERF.md §6).
//
// Launch contract: launches on the caller's stream, allocates nothing,
// returns cudaGetLastError() (negative on a rejected argument).

#include "lab_common.cuh"
#include "lab_mma.cuh"

namespace {

using namespace labm;

template <int P, bool LANES16>
struct Group {
  static constexpr int kStreamBytes = 8;  // m1, m2 int32
  static constexpr int kMaxWidth = LANES16 ? 64 : 32;
  // four K tiles a CTA barrier where the ring still leaves room for two
  // CTAs per SM (at N 64: 3 x 4 x 4 KB at L <= 16, 2 x 4 x 6 KB at L <= 24,
  // beside 64 KB of streams), else two
  __host__ __device__ static constexpr int step_tiles(int nk1) {
    return nk1 <= 3 ? 4 : 2;
  }
  __host__ __device__ static constexpr int ring_steps(int nk1) {
    return nk1 == 3 ? 2 : 3;
  }
  struct Params {
    int nt_pow2;
  };

  template <int N>
  struct Visitor {
    static constexpr int kChunks = N / 8;          // per thread and stream
    static constexpr int kStream = kRows * N * 4;  // bytes of one stream
    // registers of (lo1, lo2): LANES16, word HalfAt<N> (rr, j) holds the
    // positions of acc[4j + 2rr] and acc[4j + 2rr + 1]; else acc's order
    static constexpr int kRegs = LANES16 ? N / 4 : N / 2;
    static constexpr uint32_t kTop = LANES16 ? 0x7fff7fffu : 0x7fffffffu;
    const uint32_t m1s, m2s;
    const Params p;
    const int s0, tile_k, t;
    uint32_t lo1[kRegs], lo2[kRegs];

    __device__ Visitor(uint32_t streams, const Params& p_, int s0_,
                       int tile_k_, int t_)
        : m1s(streams), m2s(streams + kStream), p(p_), s0(s0_),
          tile_k(tile_k_), t(t_) {}

    __device__ __forceinline__ void reset() {
#pragma unroll
      for (int i = 0; i < kRegs; ++i) lo1[i] = lo2[i] = kTop;
    }

    __device__ __forceinline__ void init() {
      fill_stream(m1s, kChunks, (uint32_t)lab::kMasked);
      fill_stream(m2s, kChunks, (uint32_t)lab::kMasked);
      reset();
    }

    // lo1[i], lo2[i] (LANES16: word i) with this tile's key(s) `key`.
    __device__ __forceinline__ void fold(int i, uint32_t key) {
      if constexpr (LANES16) {
        const uint32_t hi = max16x2(lo1[i], key);
        lo1[i] = min16x2(lo1[i], key);
        lo2[i] = min16x2(lo2[i], hi);
      } else {
        const int32_t k = (int32_t)key;
        const int32_t hi = max((int32_t)lo1[i], k);
        lo1[i] = (uint32_t)min((int32_t)lo1[i], k);
        lo2[i] = (uint32_t)min((int32_t)lo2[i], hi);
      }
    }

    // The group's one read-modify-write of both streams, then a new group.
    __device__ __forceinline__ void update_streams() {
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const int rr = WordAt<N>::rr(c), ja = WordAt<N>::ja(c);
        int32_t l1[4], l2[4];
        if constexpr (LANES16) {
          const int wa = rr * HalfAt<N>::kPerRow + ja;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            l1[2 * h] = (int32_t)__byte_perm(lo1[wa + h], 0u, 0x4410);
            l1[2 * h + 1] = (int32_t)__byte_perm(lo1[wa + h], 0u, 0x4432);
            l2[2 * h] = (int32_t)__byte_perm(lo2[wa + h], 0u, 0x4410);
            l2[2 * h + 1] = (int32_t)__byte_perm(lo2[wa + h], 0u, 0x4432);
          }
        } else {
          // acc's order: (ja, e0), (ja, e1) at ia, ia + 1; ja + 1 at ia + 4
          const int ia = 4 * ja + 2 * rr;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            l1[e] = (int32_t)lo1[ia + 4 * (e >> 1) + (e & 1)];
            l2[e] = (int32_t)lo2[ia + 4 * (e >> 1) + (e & 1)];
          }
        }
        Word4 m1 = lds128(chunk_addr(m1s, c));
        Word4 m2 = lds128(chunk_addr(m2s, c));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int32_t prev = (int32_t)m1.w[e];
          m1.w[e] = (uint32_t)min(prev, l1[e]);
          m2.w[e] = (uint32_t)__vimin3_s32((int32_t)m2.w[e], max(prev, l1[e]), l2[e]);
        }
        sts128(chunk_addr(m1s, c), m1);
        sts128(chunk_addr(m2s, c), m2);
      }
      reset();
    }

    __device__ __forceinline__ void visit(int32_t (&acc)[N / 2], int kb) {
      fence_acc(acc);
      if constexpr (LANES16) {
        const uint32_t kb2 = (uint32_t)kb * 0x00010001u;
#pragma unroll
        for (int w = 0; w < kRegs; ++w) {
          const int ia = 4 * HalfAt<N>::j(w) + 2 * HalfAt<N>::rr(w);
          fold(w, lanes16(acc[ia], acc[ia + 1]) * (uint32_t)p.nt_pow2 + kb2);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kRegs; ++i) fold(i, (uint32_t)(acc[i] * p.nt_pow2 + kb));
      }
      if ((kb & (P - 1)) == P - 1) update_streams();
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
        const int rr = WordAt<N>::rr(c), ja = WordAt<N>::ja(c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int pos = s0 + 8 * (ja + (e >> 1)) + 2 * t + (e & 1);
          k[rr].add((int32_t)m1.w[e] * tile_k + pos);
          k[rr].m2c = min(k[rr].m2c, (int32_t)m2.w[e] / p.nt_pow2);
        }
      }
      lab::emit_top2(k, a.partial, a.tile_k / N, slice, a.b, r_lo, r_hi, t);
    }
  };
};

template <int P>
cudaError_t launch_group(const LabArgs& args, int nt_pow2, bool keys16,
                         cudaStream_t s) {
  return keys16 ? launch_lab<Group<P, true>>(args, {nt_pow2}, s)
                : launch_lab<Group<P, false>>(args, {nt_pow2}, s);
}

}  // namespace

extern "C" int fqtk_group_top2(const void* obs, int64_t b, int width,
                               const void* table, int kp, int length,
                               int tile_k, int n_k_tiles, int group,
                               int nt_pow2, void* partial, void* best,
                               void* idx, void* next, void* stream) {
  if ((group != 2 && group != 4 && group != 8) || n_k_tiles % group ||
      nt_pow2 < n_k_tiles || (nt_pow2 & (nt_pow2 - 1)))
    return -1;
  // the largest key count * nt_pow2 + kb, count <= L
  const bool keys16 = (int64_t)length * nt_pow2 + nt_pow2 - 1 < (1 << 15);
  const int cols = keys16 ? lab_width<Group<2, true>>(tile_k)
                          : lab_width<Group<2, false>>(tile_k);
  int64_t n_row_tiles = 0;
  const int rc = check_lab_args(b, width, table, kp, length, tile_k, n_k_tiles,
                                cols, &n_row_tiles);
  if (rc != 0) return rc;
  int32_t* part = static_cast<int32_t*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LabArgs args{static_cast<const uint8_t*>(obs), b, width, length,
                     static_cast<const uint8_t*>(table), kp, tile_k,
                     n_k_tiles, n_row_tiles, part};
  const cudaError_t e =
      group == 2   ? launch_group<2>(args, nt_pow2, keys16, s)
      : group == 4 ? launch_group<4>(args, nt_pow2, keys16, s)
                   : launch_group<8>(args, nt_pow2, keys16, s);
  if (e != cudaSuccess) return (int)e;
  return lab::launch_top2_fold(part, b, tile_k / cols, tile_k, nt_pow2, best,
                               idx, next, s);
}
