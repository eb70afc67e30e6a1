// Banded SWG extension with a run-length traceback, one warp per problem,
// for Hopper (sm_90a).
//
// Replaces thermite_tpu/ops/swg_pallas.py::make_traceback_kernel and its
// gather front end make_traceback_gather_kernel: per problem the forward
// pass with directions, then a scalar walk from the best cell that emits
// run-length runs (op << 28) | len (op 0-3 = M, S, D, I) in backward walk
// order.  Outputs meta (n, 4) int32 [score, max_i, max_j, nruns] and runs
// (n, rmax) int32; nruns is -1 when the walk needed more than rmax runs or
// did not reach the origin within XMAX + YMAX + 2 steps.  Runs past the
// written ones are zero (the reference leaves them unwritten).
//
// Two input forms, one template parameter:
// - gather (DENSE false): nibble-packed text and read block with (n, 9|4)
//   meta, windows gathered as in the stream kernels (read bytes outside
//   ACGTN are code 15 and never match);
// - dense (DENSE true): the reference kernel's own inputs, x (n, XW) uint8
//   pre-shifted rows [0, x...], y (n, YMAX) uint8, params (n, 4) int32
//   [xlen, ylen, band, x_drop]; raw bytes are compared.
//
// What bounds it on this card: as for the stream kernels, the serial
// chain of columns (integer ALU and shuffle latency per column), then the
// scalar walk on one lane (at most XMAX + YMAX + 2 steps, each a shared-
// memory read).  Shared memory per problem: the direction planes,
// 2*SLOTS words per column, plus rmax run words and the windows.
//
// What the design does about it: the DP core of swg_dp.cuh with
// directions, compiled for SLOTS in {1, 2, 4, 8, 16, 32}; a launch takes
// the smallest class that covers min(2*band_max + 1, XMAX + 1) slots.  The
// runs are staged in shared memory and copied out by the whole warp, so
// each problem writes one contiguous zero-filled row.  Warps per block
// follow from the per-warp shared memory; a shape whose one warp does not
// fit the 227 KB opt-in limit is refused before launch.  It is the
// reference's differential-testing kernel: a simple kernel, not tuned.

#include "swg_dp.cuh"

namespace {

using swg::Args;

constexpr int MAX_WARPS = 4;  // problems per block, at most
constexpr int ERR_ARGS = -1;  // shapes the kernel does not take

struct TbArgs {
  Args g;                 // n, xmax, ymax; the gather form's inputs
  const uint8_t* x;       // dense: (n, x_stride) rows [0, x...]
  const uint8_t* y;       // dense: (n, y_stride) rows
  const int32_t* params;  // dense: (n, 4) [xlen, ylen, band, x_drop]
  int64_t x_stride, y_stride;
  int rmax;
  int32_t* meta_out;  // (n, 4) [score, max_i, max_j, nruns]
  int32_t* runs_out;  // (n, rmax)
};

// The dense form's windows into shared memory: x from column 1 of its
// pre-shifted row, y as it is; one lane per position.
__device__ __forceinline__ void dense_windows(const swg::Meta& m,
                                              const TbArgs& a, int64_t p,
                                              uint8_t* xs, uint8_t* ys) {
  const int lane = threadIdx.x & 31;
  const int nx = min(m.xlen, a.g.xmax), ny = min(m.ylen, a.g.ymax);
  const uint8_t* xr = a.x + p * a.x_stride + 1;
  const uint8_t* yr = a.y + p * a.y_stride;
  for (int k = lane; k < nx; k += 32) xs[k] = xr[k];
  for (int k = lane; k < ny; k += 32) ys[k] = yr[k];
}

template <int SLOTS, bool DENSE>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    swg_traceback_kernel(const TbArgs a, int warps) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t p = (int64_t)blockIdx.x * warps + warp;
  if (p >= a.g.n) return;  // whole warps only; no block barrier follows
  const int xmax = a.g.xmax, ymax = a.g.ymax;
  uint32_t* planes =
      smem + warp * swg::warp_smem_words(xmax, ymax, a.rmax, SLOTS);
  int32_t* runs = reinterpret_cast<int32_t*>(planes + (ymax + 1) * 2 * SLOTS);
  uint8_t* xs = reinterpret_cast<uint8_t*>(runs + a.rmax);
  uint8_t* ys = xs + 4 * ((xmax + 3) / 4);

  swg::Meta m;
  if (DENSE) {
    const int32_t* pr = a.params + 4 * p;
    m.y_anchor = m.x_anchor = 0;
    m.y_dir = m.x_dir = 1;
    m.xlen = pr[0];
    m.ylen = pr[1];
    m.band = pr[2];
    m.xdrop = pr[3];
    dense_windows(m, a, p, xs, ys);
  } else {
    m = swg::unpack_meta(a.g.meta + p * a.g.meta_cols, a.g.meta_cols);
    swg::gather_windows(m, a.g, xs, ys);
  }
  for (int k = lane; k < a.rmax; k += 32) runs[k] = 0;
  __syncwarp();
  const swg::Best b = swg::dp<SLOTS, true>(m, xs, ys, planes, xmax, ymax);
  if (lane == 0) {
    const int nr = swg::walk_runs<SLOTS>(planes, b.mi, b.mj, m.band,
                                         xmax + ymax + 2, a.rmax, runs);
    int32_t* out = a.meta_out + 4 * p;
    out[0] = b.ms;
    out[1] = b.mi;
    out[2] = b.mj;
    out[3] = nr;
  }
  __syncwarp();
  int32_t* row = a.runs_out + p * a.rmax;
  for (int k = lane; k < a.rmax; k += 32) row[k] = runs[k];
}

template <int SLOTS, bool DENSE>
int launch(const TbArgs& a, cudaStream_t stream) {
  const int words = swg::warp_smem_words(a.g.xmax, a.g.ymax, a.rmax, SLOTS);
  const int warps = swg::warps_per_block(words, MAX_WARPS);
  if (warps < 1) return ERR_ARGS;
  const size_t smem = (size_t)warps * words * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        swg_traceback_kernel<SLOTS, DENSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = (a.g.n + warps - 1) / warps;
  swg_traceback_kernel<SLOTS, DENSE>
      <<<(unsigned)blocks, warps * 32, smem, stream>>>(a, warps);
  return (int)cudaGetLastError();
}

template <bool DENSE>
int dispatch(const TbArgs& a, int band_max, cudaStream_t s) {
  if (a.rmax < 1) return ERR_ARGS;
  switch (swg::slots_for(band_max, a.g.xmax)) {
    case 1: return launch<1, DENSE>(a, s);
    case 2: return launch<2, DENSE>(a, s);
    case 4: return launch<4, DENSE>(a, s);
    case 8: return launch<8, DENSE>(a, s);
    case 16: return launch<16, DENSE>(a, s);
    case 32: return launch<32, DENSE>(a, s);
    default: return ERR_ARGS;
  }
}

}  // namespace

// Both launches run on `stream` for problems with band <= band_max and
// xlen <= xmax, and return the cudaError_t of the launch (0 = ok), or -1
// for a shape the kernel does not take (nothing is launched then).

// The gather form: text and read block nibble-packed, meta (n, 9|4).
extern "C" int thermite_swg_traceback_launch(
    const int32_t* ref, int64_t ref_lw, const int32_t* reads,
    int64_t reads_lw, const int32_t* meta, int meta_cols, int64_t n,
    int xmax, int ymax, int rmax, int band_max, int32_t* meta_out,
    int32_t* runs_out, void* stream) {
  if (n <= 0) return 0;
  TbArgs a{};
  a.g = Args{ref, ref_lw, reads, reads_lw, meta, meta_cols, n,
             xmax, ymax, 16, nullptr, nullptr};
  a.rmax = rmax;
  a.meta_out = meta_out;
  a.runs_out = runs_out;
  return dispatch<false>(a, band_max, (cudaStream_t)stream);
}

// The dense form: x (n, x_stride) pre-shifted uint8 rows, y (n, y_stride)
// uint8 rows, params (n, 4) int32.
extern "C" int thermite_swg_traceback_dense_launch(
    const uint8_t* x, int64_t x_stride, const uint8_t* y, int64_t y_stride,
    const int32_t* params, int64_t n, int xmax, int ymax, int rmax,
    int band_max, int32_t* meta_out, int32_t* runs_out, void* stream) {
  if (n <= 0) return 0;
  TbArgs a{};
  a.g.n = n;
  a.g.xmax = xmax;
  a.g.ymax = ymax;
  a.x = x;
  a.y = y;
  a.params = params;
  a.x_stride = x_stride;
  a.y_stride = y_stride;
  a.rmax = rmax;
  a.meta_out = meta_out;
  a.runs_out = runs_out;
  return dispatch<true>(a, band_max, (cudaStream_t)stream);
}
