// Banded SWG extension scores, one warp per problem, for Hopper
// (sm_90a).
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
// operations a band cell and a few warp shuffles a column.
//
// What the design does about it: the DP core of swg_dp.cuh without
// directions at 32 lanes a problem (shared memory holds only the x and y
// codes, ~0.3 KB per problem, so occupancy is set by registers), compiled
// for SLOTS in
// {1, 2, 4, 8, 16, 32}; a launch takes the smallest class covering
// min(2*band_max + 1, XMAX + 1) slots.

#include "swg_dp.cuh"

namespace {

using swg::Args;

constexpr int WARPS = 4;      // problems per block

template <int SLOTS>
__global__ void __launch_bounds__(WARPS * 32)
    swg_forward_kernel(const Args a) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t p = (int64_t)blockIdx.x * WARPS + warp;
  if (p >= a.n) return;  // whole warps only; no block barrier follows
  uint8_t* xs = reinterpret_cast<uint8_t*>(
      smem + warp * swg::problem_smem_words(a.xmax, a.ymax, 0, 0, 0));
  uint8_t* ys = xs + swg::x_window_bytes(a.xmax);

  const swg::Meta m = swg::unpack_meta(a.meta + p * a.meta_cols, a.meta_cols);
  swg::gather_windows<32>(m, a, xs, ys);
  __syncwarp();
  const swg::Best b = swg::dp<32, SLOTS, false>(m, xs, ys, nullptr, a.xmax,
                                                a.ymax);
  if (lane == 0) {
    int32_t* out = a.hdr + 4 * p;
    out[0] = b.ms;
    out[1] = b.mi;
    out[2] = b.mj;
    out[3] = 0;
  }
}

template <int SLOTS>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem =
      (size_t)WARPS * swg::problem_smem_words(a.xmax, a.ymax, 0, 0, 0) * 4;
  const int64_t blocks = (a.n + WARPS - 1) / WARPS;
  swg_forward_kernel<SLOTS>
      <<<(unsigned)blocks, WARPS * 32, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` for problems with band <= band_max and xlen <= xmax;
// out is (n, 4) int32.  Returns the cudaError_t of the launch (0 = ok),
// or -1 for a shape the kernel does not take (nothing is launched then).
extern "C" int thermite_swg_forward_launch(
    const int32_t* ref, int64_t ref_lw, const int32_t* reads,
    int64_t reads_lw, const int32_t* meta, int meta_cols, int64_t n,
    int xmax, int ymax, int band_max, int32_t* out, void* stream) {
  if (n <= 0) return 0;
  const Args a{ref, ref_lw, reads, reads_lw, meta, meta_cols, n,
               xmax, ymax, 16, out, nullptr};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (swg::slots_for(band_max, xmax)) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 4: return launch<4>(a, s);
    case 8: return launch<8>(a, s);
    case 16: return launch<16>(a, s);
    case 32: return launch<32>(a, s);
    default: return swg::ERR_ARGS;
  }
}
