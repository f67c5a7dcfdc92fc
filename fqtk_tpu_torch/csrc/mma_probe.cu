// The kernel lab's tensor-core probe for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel #3 of scripts/kernel_lab.py: the body
// `kern` at :114-132 that `make_variant` -> `go_raw` launches
// (pl.pallas_call at :139) for v4_int4.  The TPU body multiplies the 0/1
// class-major one-hot of a row tile by each K tile of the lab's 0/1 table
// (pad columns all ones) on the MXU in int4 with int32 sums, keeps column 0
// of each K tile's counts and emits that of the last one:
//   out[row] = mismatches of the row against column (n_k_tiles - 1) * tile_k
// (lab_kernels.mma_probe_reference is the plain version).
//
// Type.  Hopper's tensor cores have no int4 product; the nearest is int8,
// exact here (0/1 operands, sums <= 4L <= 128 in int32).
//
// Design: a Design of csrc/lab_mma.cuh's walk, lab_pass1 (the walk, the
// tiled table and its bulk copies are described there), like lab_probe's
// v2_matmul: CTA = 128 rows x a slice of N = 128 column positions of every
// K tile (tile_k / N slices, one CTA column each), one wgmma.m64nNk32.s8
// group per K tile, two K tiles staged per CTA barrier, no stream in shared
// memory.  The visitor keeps, in registers, the counts of column 0 of the
// last K tile (acc[0] and acc[2]: rows g and g + 8 of the thread t == 0 of
// slice 0), taken by a predicated select, not a branch: a divergent branch
// between two products makes ptxas serialize them (C7520).  The output
// needs no pass 2: slice 0's CTAs write `out` themselves, the other slices
// write nothing.
//
// Dead code.  The output depends only on one column, so nvcc could drop
// the reads of the other counts.  The products are volatile asm and all
// issued, and every count is folded into the registers `sink` (four
// independent sums, so that an add does not wait for the one before it)
// that are stored only when the kernel argument `sink_flag` (always 0 from
// the wrapper) says so: the accumulators are read after every product, as
// in every other lab kernel.
//
// What bounds it on this card: operations, 2 * B * k_padded * KP int8 at
// 1,979 TOP/s; bytes (the rows, the table once per 128 rows from L2, 4 B
// per row out) are far below.
//
// Launch contract: launches on the caller's stream, allocates nothing,
// returns cudaGetLastError() (negative on a rejected argument).

#include "lab_mma.cuh"

namespace {

using namespace labm;

// `on ? v : old` by a predicated select, never a branch.
__device__ __forceinline__ int32_t select_if(bool on, int32_t v, int32_t old) {
  int32_t r;
  asm("{\n.reg .pred p;\nsetp.ne.b32 p, %3, 0;\nselp.b32 %0, %1, %2, p;\n}\n"
      : "=r"(r)
      : "r"(v), "r"(old), "r"((int)on));
  return r;
}

struct MmaDesign : TwoTileSteps {
  static constexpr int kStreamBytes = 0;
  static constexpr int kMaxWidth = 128;
  struct Params {
    int n_k_tiles, sink_flag;
  };

  template <int N>
  struct Visitor {
    const Params p;
    const int t;
    uint32_t sink[4] = {0, 0, 0, 0};
    int32_t col0[2] = {0, 0};  // rows g, g + 8 against the slice's column 2t

    __device__ Visitor(uint32_t, const Params& p_, int, int, int t_)
        : p(p_), t(t_) {}

    __device__ __forceinline__ void init() {}

    __device__ __forceinline__ void visit(int32_t (&acc)[N / 2], int kb) {
      fence_acc(acc);
#pragma unroll
      for (int i = 0; i < N / 2; ++i) sink[i & 3] += (uint32_t)acc[i];
      const bool last = kb == p.n_k_tiles - 1;
      col0[0] = select_if(last, acc[0], col0[0]);
      col0[1] = select_if(last, acc[2], col0[1]);
    }

    // Slice 0's thread t == 0 holds column 0 of the last K tile: it writes
    // the rows' outputs (`a.partial` is `out`).
    __device__ __forceinline__ void emit(const LabArgs& a, int slice,
                                         int64_t r_lo, int64_t r_hi) {
      if (slice != 0 || t != 0) return;
      const int32_t folded = (int32_t)(sink[0] + sink[1] + sink[2] + sink[3]);
      if (r_lo < a.b) a.partial[r_lo] = p.sink_flag ? folded : col0[0];
      if (r_hi < a.b) a.partial[r_hi] = p.sink_flag ? folded : col0[1];
    }
  };
};

}  // namespace

extern "C" int fqtk_mma_probe(const void* obs, int64_t b, int width,
                              const void* table, int kp, int length,
                              int tile_k, int n_k_tiles, int sink_flag,
                              void* out, void* stream) {
  int64_t n_row_tiles = 0;
  const int rc = check_lab_args(b, width, table, kp, length, tile_k, n_k_tiles,
                                lab_width<MmaDesign>(tile_k), &n_row_tiles);
  if (rc != 0) return rc;
  const LabArgs args{static_cast<const uint8_t*>(obs), b, width, length,
                     static_cast<const uint8_t*>(table), kp, tile_k,
                     n_k_tiles, n_row_tiles, static_cast<int32_t*>(out)};
  return (int)launch_lab<MmaDesign>(args, {n_k_tiles, sink_flag},
                                    static_cast<cudaStream_t>(stream));
}
