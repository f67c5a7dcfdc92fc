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
// Dead code.  v2_matmul's output depends only on column 0 of the last K
// tile, so nvcc would drop the rest of the counting and the probe would time
// nothing.  Every count of v2_matmul is folded into a register `sink` that
// is stored only when the kernel argument `sink_flag` (always 0 from the
// wrapper) says so: the full B x k_padded POPC work is issued by every
// probe.  The other probes use every count.
//
// Design and bounds: see lab_common.cuh (CTA = 256 rows x 32 column
// positions walking all K tiles; state in shared memory, 32 KB of int32 or
// 8 KB of int8 per CTA).  Per (row, column) pair a thread issues the
// staged column's NW broadcast loads, NW AND + POPC, the scale, and the
// probe's stream access: one shared load and one store (v1, p_i8min), a
// store (v2b), two of each (p_i8minmax), none (v2_matmul).  A model from
// instruction counts, not read from profiler counters: at L = 16 (NW 2)
// the POPC pipe (16/clk/SM, 8 pairs/clk/SM) binds v2_matmul, v2b_store, v1
// and p_i8min; p_i8minmax's four shared accesses per pair put the shared
// pipe (one warp-wide access per clock) near it.  An int8 stream costs the
// same shared-memory instructions as an int32 one here (one element per
// thread per access): narrowing saves bytes, not instructions, unless
// elements are packed per thread (later work).
//
// Launch contract: launches on the caller's stream, allocates nothing,
// returns cudaGetLastError() (negative on a rejected argument).

#include <type_traits>

#include "lab_common.cuh"

namespace {

using namespace lab;

enum Mode { kM1Only = 0, kMatmul = 1, kStore = 2, kI8Min = 3, kI8MinMax = 4 };

template <int MODE>
using ProbeState =
    typename std::conditional<(MODE >= kI8Min), int8_t, int32_t>::type;

template <int MODE, int NW>
__global__ void __launch_bounds__(kThreads)
probe_pass1(const uint8_t* __restrict__ obs, int64_t b, int width,
            const uint32_t* __restrict__ bits, int length, int tile_k,
            int n_k_tiles, int ck, int sink_flag,
            int32_t* __restrict__ partial, int64_t n_row_tiles) {
  using State = ProbeState<MODE>;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ __align__(16) uint32_t stage[kChunkTiles * kSlice * NW];
  volatile State* m1 = reinterpret_cast<volatile State*>(smem);

  const int t = threadIdx.x;
  const int64_t row = (blockIdx.x % n_row_tiles) * kThreads + t;
  const int slice = (int)(blockIdx.x / n_row_tiles);
  const int s0 = slice * kSlice;
  const bool valid = row < b;

  uint32_t oh[NW];
  if (valid) load_onehot<NW>(obs, row, width, length, oh);
  const State init = MODE >= kI8Min ? (State)127 : (State)((kMaxCount + 1) * ck);
#pragma unroll
  for (int p = 0; p < kSlice; ++p) m1[p * kThreads + t] = init;

  uint32_t sink = 0;
  for (int kb0 = 0; kb0 < n_k_tiles; kb0 += kChunkTiles) {
    const int ct = min(kChunkTiles, n_k_tiles - kb0);
    __syncthreads();  // the previous chunk has been consumed
    stage_chunk<NW>(bits, tile_k, s0, kb0, ct, stage);
    __syncthreads();
    if (!valid) continue;
    for (int j = 0; j < ct; ++j) {
      const int kb = kb0 + j;
      const uint32_t* cols = stage + j * kSlice * NW;
#pragma unroll 8
      for (int p = 0; p < kSlice; ++p) {
        const int cnt = count_of<NW>(oh, cols + p * NW);
        const int32_t cck = cnt * ck;
        volatile State& s = m1[p * kThreads + t];
        if constexpr (MODE == kM1Only) {
          s = min((int32_t)s, cck + kb);
        } else if constexpr (MODE == kMatmul) {
          if (s0 + p == 0) s = cck;  // the [TB, 1] copy, no merge
          sink += (uint32_t)cnt;
        } else if constexpr (MODE == kStore) {
          s = cck;
        } else {
          const int32_t c8 = min(cck, 96);  // the clamp before the int8 cast
          const int32_t prev = s;
          s = (int8_t)min(prev, c8);
          if constexpr (MODE == kI8MinMax)
            s = (int8_t)min((int32_t)s, max(prev, c8));
        }
      }
    }
  }
  if (!valid) return;
  int32_t g1 = kKeyMax;
#pragma unroll 8
  for (int p = 0; p < kSlice; ++p)
    g1 = min(g1, (int32_t)m1[p * kThreads + t] * tile_k + s0 + p);
  partial[(int64_t)slice * b + row] = sink_flag ? (int32_t)sink : g1;
}

__global__ void __launch_bounds__(kThreads)
probe_pass2(const int32_t* __restrict__ partial, int64_t b, int n_slices,
            int32_t* __restrict__ out) {
  const int64_t row = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (row >= b) return;
  int32_t g1 = kKeyMax;
  for (int s = 0; s < n_slices; ++s) g1 = min(g1, partial[(int64_t)s * b + row]);
  out[row] = g1 >> 8;
}

template <int MODE, int NW>
int launch_probe(const uint8_t* obs, int64_t b, int width,
                 const uint32_t* bits, int length, int tile_k, int n_k_tiles,
                 int ck, int sink_flag, int32_t* partial, int64_t n_row_tiles,
                 cudaStream_t s) {
  return launch_pass1(probe_pass1<MODE, NW>,
                      sizeof(ProbeState<MODE>) * kSlice * kThreads,
                      n_row_tiles, tile_k / kSlice, s, obs, b, width, bits,
                      length, tile_k, n_k_tiles, ck, sink_flag, partial);
}

template <int MODE>
int launch_mode(int nw, const uint8_t* obs, int64_t b, int width,
                const uint32_t* bits, int length, int tile_k, int n_k_tiles,
                int ck, int sink_flag, int32_t* partial, int64_t n_row_tiles,
                cudaStream_t s) {
#define FQTK_PROBE(N)                                                       \
  return launch_probe<MODE, N>(obs, b, width, bits, length, tile_k,         \
                               n_k_tiles, ck, sink_flag, partial,           \
                               n_row_tiles, s)
  switch (nw) {
    case 1: FQTK_PROBE(1);
    case 2: FQTK_PROBE(2);
    case 3: FQTK_PROBE(3);
    default: FQTK_PROBE(4);
  }
#undef FQTK_PROBE
}

}  // namespace

extern "C" int fqtk_lab_probe(const void* obs, int64_t b, int width,
                              const void* bits, int nw, int length,
                              int tile_k, int n_k_tiles, int mode, int ck,
                              int sink_flag, void* partial, void* out,
                              void* stream) {
  int64_t n_row_tiles = 0;
  const int rc = check_args(b, width, bits, nw, length, tile_k, n_k_tiles,
                            &n_row_tiles);
  if (rc != 0) return rc;
  if (mode < kM1Only || mode > kI8MinMax || ck < 2) return -1;
  const uint8_t* o = static_cast<const uint8_t*>(obs);
  const uint32_t* w = static_cast<const uint32_t*>(bits);
  int32_t* part = static_cast<int32_t*>(partial);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int e = 0;
#define FQTK_MODE(M)                                                        \
  e = launch_mode<M>(nw, o, b, width, w, length, tile_k, n_k_tiles, ck,     \
                     sink_flag, part, n_row_tiles, s)
  switch (mode) {
    case kM1Only: FQTK_MODE(kM1Only); break;
    case kMatmul: FQTK_MODE(kMatmul); break;
    case kStore: FQTK_MODE(kStore); break;
    case kI8Min: FQTK_MODE(kI8Min); break;
    default: FQTK_MODE(kI8MinMax); break;
  }
#undef FQTK_MODE
  if (e != 0) return e;
  probe_pass2<<<(unsigned)n_row_tiles, kThreads, 0, s>>>(
      part, b, tile_k / kSlice, static_cast<int32_t*>(out));
  return (int)cudaGetLastError();
}
