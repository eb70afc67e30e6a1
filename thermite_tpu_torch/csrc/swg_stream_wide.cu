// Banded SWG extension + traceback op stream at any band, one warp per
// problem, for Hopper (sm_90a).
//
// Replaces thermite_tpu/ops/swg_pallas.py::make_stream_traceback_kernel
// (behind make_stream_traceback_gather_call): the same outputs as the
// packed kernel of swg_stream.cu (hdr (N, 2) int16 halves, streams
// (N, SMAX/16)) for bands above 31, where the reference rounds the band
// to W = roundup(2b+1, 128) lanes per problem.  The wrapper assembles
// the reference's fused (N, 4 + SMAX/16) rows from these two outputs.
//
// What bounds it on this card: as for swg_stream.cu, the serial chain of
// columns (integer ALU and shuffle latency per column) - here with SLOTS
// band slots per lane, so a column costs about SLOTS times the per-slot
// work plus one 5-step shuffle scan - and shared memory: the direction
// planes take 2*SLOTS words per column (at SLOTS 32 and YMAX 512 about
// 131 KB per problem), which caps the warps per block and per SM.
//
// What the design does about it: the DP core of swg_dp.cuh, compiled for
// SLOTS in {4, 8, 16, 32} (128 to 1024 slots); a launch takes the
// smallest class that covers min(2*band_max + 1, XMAX + 1) slots, since
// slots past row xlen are never computed.  Warps per block follow from
// the per-warp shared memory so that every shape the reference accepts
// (XMAX, YMAX <= 512) fits the opt-in limit.  At SLOTS 16 and 32 the
// per-slot arrays exceed the register budget and spill (see the build
// log); correctness first.

#include "swg_dp.cuh"

namespace {

using swg::Args;

constexpr int MAX_WARPS = 4;  // problems per block, at most
constexpr int ERR_ARGS = -1;  // shapes the kernel does not take

template <int SLOTS>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    swg_stream_wide_kernel(const Args a, int warps) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int64_t p = (int64_t)blockIdx.x * warps + warp;
  if (p >= a.n) return;  // whole warps only; no block barrier follows
  const int pw = a.smax / 16;
  uint32_t* planes =
      smem + warp * swg::warp_smem_words(a.xmax, a.ymax, pw, SLOTS);
  uint32_t* words = planes + (a.ymax + 1) * 2 * SLOTS;
  uint8_t* xs = reinterpret_cast<uint8_t*>(words + pw);
  uint8_t* ys = xs + 4 * ((a.xmax + 3) / 4);

  const swg::Meta m = swg::unpack_meta(a.meta + p * a.meta_cols, a.meta_cols);
  swg::gather_windows(m, a, xs, ys);
  __syncwarp();
  swg::stream_problem<SLOTS>(m, xs, ys, planes, words, a, a.hdr + 2 * p,
                             a.streams + p * pw);
}

template <int SLOTS>
int launch(const Args& a, cudaStream_t stream) {
  const int words = swg::warp_smem_words(a.xmax, a.ymax, a.smax / 16, SLOTS);
  const int warps = swg::warps_per_block(words, MAX_WARPS);
  if (warps < 1) return ERR_ARGS;
  const size_t smem = (size_t)warps * words * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        swg_stream_wide_kernel<SLOTS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = (a.n + warps - 1) / warps;
  swg_stream_wide_kernel<SLOTS>
      <<<(unsigned)blocks, warps * 32, smem, stream>>>(a, warps);
  return (int)cudaGetLastError();
}

}  // namespace

// Launch on `stream` for problems with band <= band_max and xlen <= xmax;
// returns the cudaError_t of the launch (0 = ok), or -1 for a shape the
// kernel does not take (nothing is launched then).
extern "C" int thermite_swg_stream_wide_launch(
    const int32_t* ref, int64_t ref_lw, const int32_t* reads,
    int64_t reads_lw, const int32_t* meta, int meta_cols, int64_t n,
    int xmax, int ymax, int smax, int band_max, int32_t* hdr,
    int32_t* streams, void* stream) {
  if (n <= 0) return 0;
  const Args a{ref, ref_lw, reads, reads_lw, meta, meta_cols, n,
               xmax, ymax, smax, hdr, streams};
  const cudaStream_t s = (cudaStream_t)stream;
  // the narrowest class is 4: bands up to 31 go to swg_stream.cu
  const int slots = swg::slots_for(band_max, xmax);
  if (slots == 0) return ERR_ARGS;
  if (slots <= 4) return launch<4>(a, s);
  if (slots == 8) return launch<8>(a, s);
  if (slots == 16) return launch<16>(a, s);
  return launch<32>(a, s);
}
