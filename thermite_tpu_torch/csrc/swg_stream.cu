// Banded SWG extension + traceback op stream, one warp per problem, for
// Hopper (sm_90a).
//
// Replaces thermite_tpu/ops/swg_pallas_packed.py::make_packed_stream_call
// (behind make_packed_stream_gather_kernel(split=True)): per problem it
// gathers the x window from the nibble-packed read block and the y
// window from the nibble-packed text, runs banded affine-gap SWG with
// X-drop, keeps the best score and the first cell reaching it, computes
// the band-exactness certificate, and walks the traceback into 2-bit
// codes (backward order, 16 per int32).  Outputs are written in meta row
// order: hdr (N, 2) int16 halves, streams (N, SMAX/16).
//
// What bounds it on this card: not bytes.  A problem reads ~0.1 KB of
// text and reads and writes 60 B; the DP is a serial chain of columns
// (up to YMAX), each a dependent sequence of integer ops, warp shuffles
// (neighbour slots, a 5-step prefix-max scan for the insertion chain,
// a max reduce and a ballot arg-min) and ballots, so it is bound by
// integer ALU and shuffle latency per column.  The text gather is random
// 4-byte reads.  The walk is a serial chain of shared-memory reads.
//
// What the design does about it: one warp per problem, band slot t on
// lane t (two slots per lane for bands 16..31), so no problem waits for
// another's columns and the TPU's lane packing of problems is not
// needed; many warps per SM hide the per-column latency.  Each warp
// gathers its x and y codes into shared memory once, so the DP loop
// reads no global memory.  Directions are kept as two ballots per
// column in shared memory (~1 KB per problem at YMAX 128).  The walk is
// per problem, on one lane, with no column synchronisation, and packs
// codes with uint32 shifts.  The DP core and the walk are shared with the
// general-band and forward kernels (swg_dp.cuh).

#include "swg_dp.cuh"

namespace {

using swg::Args;

constexpr int WARPS = 4;  // problems per block
constexpr int SLOTS_MAX = 2;  // band <= 31: 2b+1 <= 63 slots

__global__ void __launch_bounds__(WARPS * 32)
    swg_stream_kernel(const Args a) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int64_t p = (int64_t)blockIdx.x * WARPS + warp;
  if (p >= a.n) return;  // whole warps only; no block barrier follows
  const int pw = a.smax / 16;
  uint32_t* planes =
      smem + warp * swg::warp_smem_words(a.xmax, a.ymax, pw, SLOTS_MAX);
  uint32_t* words = planes + (a.ymax + 1) * 2 * SLOTS_MAX;
  uint8_t* xs = reinterpret_cast<uint8_t*>(words + pw);
  uint8_t* ys = xs + 4 * ((a.xmax + 3) / 4);

  const swg::Meta m = swg::unpack_meta(a.meta + p * a.meta_cols, a.meta_cols);
  swg::gather_windows(m, a, xs, ys);
  __syncwarp();
  // the wrapper routes launches with a band above 31 to the general
  // kernel (swg_stream_wide.cu)
  if (m.band <= 15) {
    swg::stream_problem<1>(m, xs, ys, planes, words, a, a.hdr + 2 * p,
                           a.streams + p * pw);
  } else {
    swg::stream_problem<2>(m, xs, ys, planes, words, a, a.hdr + 2 * p,
                           a.streams + p * pw);
  }
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 = ok).
extern "C" int thermite_swg_stream_launch(
    const int32_t* ref, int64_t ref_lw, const int32_t* reads,
    int64_t reads_lw, const int32_t* meta, int meta_cols, int64_t n,
    int xmax, int ymax, int smax, int32_t* hdr, int32_t* streams,
    void* stream) {
  if (n <= 0) return 0;
  const Args a{ref, ref_lw, reads, reads_lw, meta, meta_cols, n,
               xmax, ymax, smax, hdr, streams};
  const size_t smem = (size_t)WARPS *
                      swg::warp_smem_words(xmax, ymax, smax / 16, SLOTS_MAX) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        swg_stream_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = (n + WARPS - 1) / WARPS;
  swg_stream_kernel<<<(unsigned)blocks, WARPS * 32, smem,
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
