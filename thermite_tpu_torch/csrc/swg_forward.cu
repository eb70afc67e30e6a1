// Banded SWG extension scores as sub-warp groups whose shape each warp
// chooses for its own rows, for Hopper (sm_90a).
//
// Replaces the reference's make_forward_kernel (swg_pallas.py, behind
// make_forward_gather_kernel): per problem it gathers the x and y windows
// from the nibble-packed read block and text, runs the banded affine-gap
// SWG with X-drop, and writes (N, 4) int32 rows [score, max_i, max_j, 0]
// - the best score and the first cell reaching it.  No directions, no
// walk, no certificate.  It scores every nontrivial problem of a chunk
// when the batch pipeline runs without the C++ engine.
//
// What bounds it on this card: operations, not bytes (a problem reads
// ~0.2 KB and writes 16 B): the serial chain of columns, about 12 integer
// operations a band cell and a few warp shuffles a column.  A problem
// computes only min(2*band + 1, xlen + 1) band slots, so a shape sized for
// the launch's widest problem leaves most lane-slots of a short problem
// without a cell.
//
// What the design does about it: the DP core of swg_dp.cuh without
// directions or certificate (shared memory holds only the x and y codes,
// ~0.3 KB a problem, so occupancy is set by registers).  Where 128 slots
// cover the launch (min(2*band_max + 1, XMAX + 1): band 60 at XMAX 96, and
// every band at or under 63) a warp owns four consecutive rows, reads
// their metas and takes the narrowest of 8, 16 and 32 lanes x 4 slots that
// covers the widest of them (warp_lanes in swg_stream.cuh): all four side
// by side, two passes of two, or four passes of one.  One launch and one
// grid whatever the rows need; the choice reads nothing on the host.  The
// shuffles of a column are shared by the problems of a pass, and a short
// problem no longer pays for lanes it cannot use.  Rows ordered by ylen, as
// the batch pipeline submits them, need about the same slots as their
// neighbours and end at about the same column; blocks take the rows from
// the last to the first, so such a launch starts its longest warps first
// and ends on its shortest.  Rows in no order lose that: a warp then waits
// on its longest row.  Above 128 slots a launch takes one warp a problem
// at 8, 16 or 32 slots a lane.

#include "swg_dp.cuh"

namespace {

using swg::Args;

constexpr int WARPS = 4;  // warps per block

// One problem's scores: `win` is its shared memory, the padded x codes
// then the y codes.  Every lane of the warp calls it; the group of a row
// past the launch's last takes part in the warp's loop and writes nothing.
template <int LANES, int SLOTS>
__device__ __forceinline__ void score_problem(const Args& a, int64_t p,
                                              uint32_t* win) {
  const bool valid = p < a.n;
  uint8_t* xs = reinterpret_cast<uint8_t*>(win);
  uint8_t* ys = xs + swg::x_window_bytes(a.xmax);
  const swg::Meta m =
      valid ? swg::unpack_meta(a.meta + p * a.meta_cols, a.meta_cols)
            : swg::empty_problem();
  swg::gather_windows<LANES>(m, a, xs, ys);
  __syncwarp();
  const swg::Best b =
      swg::dp<LANES, SLOTS, false>(m, xs, ys, nullptr, a.xmax, a.ymax);
  if (valid && swg::group_lane<LANES>() == 0)
    *reinterpret_cast<int4*>(a.hdr + 4 * p) = make_int4(b.ms, b.mi, b.mj, 0);
}

// A warp's rows [p0, p0 + ROWS_PER_WARP) at LANES lanes a problem: 32 /
// LANES of them a pass, row r's windows at r's place in the warp's shared
// memory.
template <int LANES>
__device__ __forceinline__ void score_rows(const Args& a, int64_t p0,
                                           uint32_t* win, int words) {
  constexpr int G = 32 / LANES;
  const int g = (threadIdx.x & 31) / LANES;
#pragma unroll 1
  for (int t = 0; t < swg::ROWS_PER_WARP && p0 + t < a.n; t += G)
    score_problem<LANES, swg::ROWS_SLOTS>(a, p0 + t + g,
                                          win + (t + g) * words);
}

__global__ void __launch_bounds__(WARPS * 32)
    swg_forward_rows_kernel(const Args a) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  // the last rows first: a caller that orders rows by ylen has its longest
  // problems there, and the launch then ends on its shortest warps
  const int64_t p0 = ((int64_t)(gridDim.x - 1 - blockIdx.x) * WARPS + warp) *
                     swg::ROWS_PER_WARP;
  if (p0 >= a.n) return;  // whole warps only; no block barrier follows
  const int words = swg::problem_smem_words(a.xmax, a.ymax, 0, 0, 0);
  uint32_t* win = smem + warp * swg::ROWS_PER_WARP * words;
  switch (swg::warp_lanes(a.meta, a.meta_cols, false, p0, a.n)) {
    case 8: score_rows<8>(a, p0, win, words); break;
    case 16: score_rows<16>(a, p0, win, words); break;
    default: score_rows<32>(a, p0, win, words);
  }
}

// Above 128 slots a launch: one warp a problem, SLOTS slots a lane.
template <int SLOTS>
__global__ void __launch_bounds__(WARPS * 32)
    swg_forward_kernel(const Args a) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int64_t p = (int64_t)blockIdx.x * WARPS + warp;
  if (p >= a.n) return;  // whole warps only; no block barrier follows
  score_problem<32, SLOTS>(
      a, p, smem + warp * swg::problem_smem_words(a.xmax, a.ymax, 0, 0, 0));
}

// Launch `kernel`, each warp of which takes `per_warp` rows.
int launch(void (*kernel)(const Args), const Args& a, int per_warp,
           cudaStream_t stream) {
  const size_t smem = (size_t)WARPS * per_warp *
                      swg::problem_smem_words(a.xmax, a.ymax, 0, 0, 0) * 4;
  const int64_t per_block = (int64_t)WARPS * per_warp;
  const int64_t blocks = (a.n + per_block - 1) / per_block;
  kernel<<<(unsigned)blocks, WARPS * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` for problems with band <= band_max and xlen <= xmax;
// out is (n, 4) int32, 16-byte aligned.  Returns the cudaError_t of the
// launch (0 = ok), or -1 for a shape the kernel does not take (nothing is
// launched then).
extern "C" int thermite_swg_forward_launch(
    const int32_t* ref, int64_t ref_lw, const int32_t* reads,
    int64_t reads_lw, const int32_t* meta, int meta_cols, int64_t n,
    int xmax, int ymax, int band_max, int32_t* out, void* stream) {
  if (n <= 0) return 0;
  const Args a{ref, ref_lw, reads, reads_lw, meta, meta_cols, n,
               xmax, ymax, 16, out, nullptr};
  const cudaStream_t s = (cudaStream_t)stream;
  if (swg::rows_launch(band_max, xmax))
    return launch(swg_forward_rows_kernel, a, swg::ROWS_PER_WARP, s);
  switch (swg::slots_for(band_max, xmax)) {
    case 8: return launch(swg_forward_kernel<8>, a, 1, s);
    case 16: return launch(swg_forward_kernel<16>, a, 1, s);
    case 32: return launch(swg_forward_kernel<32>, a, 1, s);
    default: return swg::ERR_ARGS;
  }
}
