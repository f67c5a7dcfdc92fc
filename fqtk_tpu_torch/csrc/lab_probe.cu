// The kernel lab's bound probes for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel #4 of scripts/kernel_lab.py: the body
// `kern` at :172-214 that `make_variant` -> `build` -> `go_raw` launches
// (pl.pallas_call at :222) for the probes v1_m1only, v2_matmul, v2b_store,
// p_i8min and p_i8minmax.  One template, one Mode per probe.  For every read
// row and K tile kb, with count = mismatches of the row against column
// kb * tile_k + p of the lab's table (pad columns count L) and
// counts_ck = count * ck (ck = 2^max(1, bitlen(n_k_tiles - 1))), each probe
// updates one accumulator stream m1[p]:
//   v1_m1only   int32, init 256 * ck: m1 = min(m1, counts_ck + kb)
//   v2_matmul   int32, init 256 * ck: m1[0] = counts_ck of column 0 only
//   v2b_store   int32: m1 = counts_ck (a store, no read)
//   p_i8min     int8, init 127: m1 = min(m1, int8(min(counts_ck, 96)))
//   p_i8minmax  int8: p_i8min's update, then a second read-modify-write
//               m1 = min(m1, max(prev, c8)) (the TPU body's stand-in for
//               a second stream's cost; the value equals p_i8min's)
// and emits, bit for bit as the TPU body, out = min_p(m1[p] * tile_k + p)
// >> 8 (lab_kernels.lab_probe_reference is the plain version).
//
// Design (csrc/lab_mma.cuh has the walk, the table and the stream's layout).
// Every probe counts on the tensor-core engine of csrc/mma_count.cuh: CTA =
// 128 rows x N = 128 column positions, one wgmma group per K tile, the
// stream in shared memory (64 KB of int32 or 16 KB of int8 per CTA) beside
// the ring (three steps of two K tiles), read and written at every step as
// the probe says, four (int32) or sixteen (int8) positions per 128-bit
// access.  The five modes are the
// lab's decomposition of a design's cost: the engine alone (v2_matmul), +
// a store per pair (v2b_store, 4 B), + load / min / store at 32 bits
// (v1_m1only, 8 B), + one (p_i8min, 2 B) and two (p_i8minmax, 4 B)
// read-modify-writes of a byte stream, updated in packed 16-bit lanes (DPX
// min / max): the clamp at 96 comes before the narrowing, as in the body
// (counts * ck reaches 16 * 512).
//
// Dead code.  v2_matmul's output depends only on column 0 of the last K
// tile.  The products themselves are volatile asm and are all issued; every
// count is still folded into the registers `sink` (four independent sums, so
// that an add does not wait for the one before it) that are stored only when
// the kernel argument `sink_flag` (always 0 from the wrapper) says so, so
// that the accumulators are read after every product, as every other probe
// does.
//
// What bounds it on this card: operations (2 * B * k_padded * KP int8 at
// 1,979 TOP/s) for v2_matmul; for the others the stream's bytes through
// shared memory (128 B per clock and SM, beside wgmma's own B reads) or the
// integer lanes of the packed update, whichever is slower.
//
// Launch contract: launches on the caller's stream, allocates nothing,
// returns cudaGetLastError() (negative on a rejected argument).

#include "lab_mma.cuh"

namespace {

using namespace labm;

enum Mode { kM1Only = 0, kMatmul = 1, kStore = 2, kI8Min = 3, kI8MinMax = 4 };

// A 32-bit store to shared memory under a predicate, not a branch: a
// divergent branch between two products makes ptxas serialize them (C7520).
__device__ __forceinline__ void sts32_if(bool on, uint32_t addr, uint32_t v) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"
      "@p st.shared.u32 [%0], %1;\n}\n" ::"r"(addr),
      "r"(v), "r"((int)on));
}

template <int MODE>
struct Probe : TwoTileSteps {
  static constexpr bool kBytes = MODE >= kI8Min;
  static constexpr int kStreamBytes = kBytes ? 1 : 4;
  static constexpr int kMaxWidth = 128;
  struct Params {
    int ck, sink_flag;
  };

  template <int N>
  struct Visitor {
    // 16-byte chunks per thread: 16 positions of a byte stream, 4 of int32
    static constexpr int kChunks = kBytes ? N / 32 : N / 8;
    const uint32_t m1s;
    const Params p;
    const int s0, tile_k, t;
    uint32_t sink[4] = {0, 0, 0, 0};

    __device__ Visitor(uint32_t streams, const Params& p_, int s0_,
                       int tile_k_, int t_)
        : m1s(streams), p(p_), s0(s0_), tile_k(tile_k_), t(t_) {}

    __device__ __forceinline__ void init() {
      fill_stream(m1s, kChunks,
                  kBytes ? 0x7f7f7f7fu : (uint32_t)((kMaxCount + 1) * p.ck));
    }

    __device__ __forceinline__ void visit(int32_t (&acc)[N / 2], int kb) {
      fence_acc(acc);
      if constexpr (MODE == kMatmul) {
#pragma unroll
        for (int i = 0; i < N / 2; ++i) sink[i & 3] += (uint32_t)acc[i];
        // the [TB, 1] copy of column 0, no merge: the thread that holds it
        const bool col0 = s0 == 0 && t == 0;
        sts32_if(col0, chunk_addr(m1s, 0), (uint32_t)(acc[0] * p.ck));
        sts32_if(col0, chunk_addr(m1s, N / 16), (uint32_t)(acc[2] * p.ck));
      } else if constexpr (!kBytes) {
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          const int rr = WordAt<N>::rr(c), ja = WordAt<N>::ja(c);
          const int ia = 4 * ja + 2 * rr, ib = 4 * (ja + 1) + 2 * rr;
          const int32_t cck[4] = {acc[ia] * p.ck, acc[ia + 1] * p.ck,
                                  acc[ib] * p.ck, acc[ib + 1] * p.ck};
          Word4 v;
          if constexpr (MODE == kM1Only) {
            v = lds128(chunk_addr(m1s, c));
#pragma unroll
            for (int q = 0; q < 4; ++q)
              v.w[q] = (uint32_t)min((int32_t)v.w[q], cck[q] + kb);
          } else {  // kStore: a store per pair, no read
#pragma unroll
            for (int q = 0; q < 4; ++q) v.w[q] = (uint32_t)cck[q];
          }
          sts128(chunk_addr(m1s, c), v);
        }
      } else {
        // min(count * ck, 96) in 16-bit lanes without leaving them: counts
        // above 96 / ck all give 96, so clamp the count first
        const uint32_t cap = (uint32_t)(96 / p.ck + 1) * 0x00010001u;
        const uint32_t c96 = 96u * 0x00010001u;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          Word4 v = lds128(chunk_addr(m1s, c));
          // y: count * ck before its clamp at 96 (at most 96 + ck)
          uint32_t prev[4][2], y[4][2];
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int rr = WordAt<N>::rr(4 * c + w);
            const int ja = WordAt<N>::ja(4 * c + w);
            const int ia = 4 * ja + 2 * rr, ib = 4 * (ja + 1) + 2 * rr;
            // lanes of [0]: bytes 0, 1 of the word; of [1]: bytes 2, 3
            y[w][0] = min16x2(lanes16(acc[ia], acc[ia + 1]), cap) * (uint32_t)p.ck;
            y[w][1] = min16x2(lanes16(acc[ib], acc[ib + 1]), cap) * (uint32_t)p.ck;
            prev[w][0] = __byte_perm(v.w[w], 0u, 0x4140);
            prev[w][1] = __byte_perm(v.w[w], 0u, 0x4342);
            // min(m1, c8), c8 = min(counts_ck, 96), in one instruction
            v.w[w] = __byte_perm(__vimin3_s16x2(prev[w][0], y[w][0], c96),
                                 __vimin3_s16x2(prev[w][1], y[w][1], c96),
                                 0x6420);
          }
          sts128(chunk_addr(m1s, c), v);
          if constexpr (MODE == kI8MinMax) {
            v = lds128(chunk_addr(m1s, c));  // the second read-modify-write
#pragma unroll
            for (int w = 0; w < 4; ++w)
              // min(m1, max(prev, c8)): m1 <= prev, so c8's clamp at 96 does
              // not change the result and y stands in for it
              v.w[w] = __byte_perm(
                  min16x2(__byte_perm(v.w[w], 0u, 0x4140),
                          max16x2(prev[w][0], y[w][0])),
                  min16x2(__byte_perm(v.w[w], 0u, 0x4342),
                          max16x2(prev[w][1], y[w][1])),
                  0x6420);
            sts128(chunk_addr(m1s, c), v);
          }
        }
      }
    }

    // out's key min_p(m1[p] * tile_k + p) over the thread's positions, the
    // quad's fold, and the rows' partials.
    __device__ __forceinline__ void emit(const LabArgs& a, int slice,
                                         int64_t r_lo, int64_t r_hi) {
      int32_t g[2] = {kKeyInit, kKeyInit};
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const Word4 v = lds128(chunk_addr(m1s, c));
        if constexpr (!kBytes) {
          const int rr = WordAt<N>::rr(c), ja = WordAt<N>::ja(c);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int pos = s0 + 8 * (ja + (q >> 1)) + 2 * t + (q & 1);
            g[rr] = min(g[rr], (int32_t)v.w[q] * tile_k + pos);
          }
        } else {
#pragma unroll
          for (int w = 0; w < 4; ++w) {
            const int rr = WordAt<N>::rr(4 * c + w);
            const int ja = WordAt<N>::ja(4 * c + w);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const int32_t m = (int8_t)(v.w[w] >> (8 * q));
              const int pos = s0 + 8 * (ja + (q >> 1)) + 2 * t + (q & 1);
              g[rr] = min(g[rr], m * tile_k + pos);
            }
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        g[rr] = min(g[rr], __shfl_xor_sync(0xffffffffu, g[rr], 1));
        g[rr] = min(g[rr], __shfl_xor_sync(0xffffffffu, g[rr], 2));
      }
      if (t != 0) return;
      const int32_t folded = (int32_t)(sink[0] + sink[1] + sink[2] + sink[3]);
      if (r_lo < a.b)
        a.partial[(int64_t)slice * a.b + r_lo] = p.sink_flag ? folded : g[0];
      if (r_hi < a.b)
        a.partial[(int64_t)slice * a.b + r_hi] = p.sink_flag ? folded : g[1];
    }
  };
};

__global__ void __launch_bounds__(256)
probe_pass2(const int32_t* __restrict__ partial, int64_t b, int n_slices,
            int32_t* __restrict__ out) {
  const int64_t row = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (row >= b) return;
  int32_t g1 = kKeyInit;
  for (int s = 0; s < n_slices; ++s) g1 = min(g1, partial[(int64_t)s * b + row]);
  out[row] = g1 >> 8;
}

}  // namespace

extern "C" int fqtk_lab_probe(const void* obs, int64_t b, int width,
                              const void* table, int kp, int length,
                              int tile_k, int n_k_tiles, int mode, int ck,
                              int sink_flag, void* partial, void* out,
                              void* stream) {
  int64_t n_row_tiles = 0;
  // every mode runs at the same width
  const int rc = check_lab_args(b, width, table, kp, length, tile_k, n_k_tiles,
                                lab_width<Probe<kM1Only>>(tile_k), &n_row_tiles);
  if (rc != 0) return rc;
  // ck: a power of two whose lanes (96 / ck + 1) * ck stay positive int16
  if (mode < kM1Only || mode > kI8MinMax || ck < 2 || ck > (1 << 14))
    return -1;
  int32_t* part = static_cast<int32_t*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const LabArgs args{static_cast<const uint8_t*>(obs), b, width, length,
                     static_cast<const uint8_t*>(table), kp, tile_k,
                     n_k_tiles, n_row_tiles, part};
  cudaError_t e = cudaSuccess;
  switch (mode) {
    case kM1Only: e = launch_lab<Probe<kM1Only>>(args, {ck, sink_flag}, s); break;
    case kMatmul: e = launch_lab<Probe<kMatmul>>(args, {ck, sink_flag}, s); break;
    case kStore: e = launch_lab<Probe<kStore>>(args, {ck, sink_flag}, s); break;
    case kI8Min: e = launch_lab<Probe<kI8Min>>(args, {ck, sink_flag}, s); break;
    default: e = launch_lab<Probe<kI8MinMax>>(args, {ck, sink_flag}, s); break;
  }
  if (e != cudaSuccess) return (int)e;
  probe_pass2<<<(unsigned)((b + 255) / 256), 256, 0, s>>>(
      part, b, tile_k / lab_width<Probe<kM1Only>>(tile_k),
      static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
