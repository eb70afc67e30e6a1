// Banded SWG extension with a run-length traceback, as sub-warp groups
// whose shape each warp chooses for its own rows, for Hopper (sm_90a).
//
// Replaces the reference's make_traceback_kernel (swg_pallas.py) and its
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
// What bounds it on this card: operations, as for the stream kernels (the
// serial chain of columns, about 15 integer operations a band cell), then
// the scalar walk (at most XMAX + YMAX + 2 steps, each a shared-memory
// read), during which the other lanes of a problem wait.  A problem
// computes only min(2*band + 1, xlen + 1) band slots, so a shape sized for
// the launch's widest problem leaves most lane-slots of a short problem
// without a cell, and one walk a warp leaves 31 lanes waiting.
//
// What the design does about it: the DP core of swg_dp.cuh with
// directions (each lane stores the directions of its own slots, no
// ballots).  Where 128 slots cover the launch (min(2*band_max + 1,
// XMAX + 1)) a warp owns four consecutive rows, reads their metas or
// params and takes the narrowest of 8, 16 and 32 lanes x 4 slots that
// covers the widest of them (warp_lanes in swg_stream.cuh): all four side
// by side, two passes of two, or four passes of one, in one launch and one
// grid, with nothing read on the host.  The first lane of every group walks
// its own problem, so up to four walks run at once.  A warp's direction
// planes take 32 bytes a column in all three shapes; its shared memory is
// sized for four problems at 8 lanes (planes, rmax run words and windows
// each), which covers the other two.  The runs are staged in shared memory
// and copied out by the problem's lanes, so each problem writes one
// contiguous zero-filled row.  Blocks take the rows from the last to the
// first, so a launch whose rows are ordered by ylen starts its longest
// warps first and ends on its shortest.  Above 128 slots a launch takes
// one warp a problem at 8, 16 or 32 slots a lane.  Warps per block follow
// from the per-warp shared memory; a shape whose one warp does not fit the
// 227 KB opt-in limit is refused before launch.  It is the reference's
// differential-testing kernel: no pipeline calls it.

#include "swg_dp.cuh"

namespace {

using swg::Args;

constexpr int MAX_WARPS = 4;  // warps per block, at most
using swg::ERR_ARGS;

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
// pre-shifted row (padded as gather_windows pads it), y as it is; one
// group lane per position.
template <int LANES>
__device__ __forceinline__ void dense_windows(const swg::Meta& m,
                                              const TbArgs& a, int64_t p,
                                              uint8_t* xs, uint8_t* ys) {
  const int gl = swg::group_lane<LANES>();
  const int nx = min(m.xlen, a.g.xmax), ny = min(m.ylen, a.g.ymax);
  const uint8_t* xr = a.x + p * a.x_stride + 1;
  const uint8_t* yr = a.y + p * a.y_stride;
  if (gl == 0) xs[0] = xs[nx + 1] = 0;  // the padded window of swg_dp.cuh
  for (int k = gl; k < nx; k += LANES) xs[k + 1] = xr[k];
  for (int k = gl; k < ny; k += LANES) ys[k] = yr[k];
}

// One problem: forward pass with directions, the walk on the group's
// first lane, the outputs.  `base` is the problem's shared memory
// (problem_smem_words at this shape).  Every lane of the warp calls it;
// the group of a row past the launch's last takes part in the warp's loop
// and writes nothing.
template <int LANES, int SLOTS, bool DENSE>
__device__ __forceinline__ void trace_problem(const TbArgs& a, int64_t p,
                                              uint32_t* base) {
  const int gl = swg::group_lane<LANES>();
  const int xmax = a.g.xmax, ymax = a.g.ymax;
  const bool valid = p < a.g.n;
  const swg::ProblemSmem sm =
      swg::problem_smem<LANES, SLOTS>(base, xmax, ymax, a.rmax);
  int32_t* runs = reinterpret_cast<int32_t*>(sm.words);

  const swg::Meta m =
      !valid ? swg::empty_problem()
      : DENSE ? swg::unpack_params(a.params + 4 * p)
              : swg::unpack_meta(a.g.meta + p * a.g.meta_cols, a.g.meta_cols);
  if (DENSE)
    dense_windows<LANES>(m, a, p, sm.xs, sm.ys);
  else
    swg::gather_windows<LANES>(m, a.g, sm.xs, sm.ys);
  for (int k = gl; k < a.rmax; k += LANES) runs[k] = 0;
  __syncwarp();
  const swg::Best b =
      swg::dp<LANES, SLOTS, true>(m, sm.xs, sm.ys, sm.planes, xmax, ymax);
  __syncwarp();
  if (gl == 0 && valid) {
    const int nr = swg::walk_runs<LANES, SLOTS>(
        sm.planes, b.mi, b.mj, m.band, xmax + ymax + 2, a.rmax, runs);
    *reinterpret_cast<int4*>(a.meta_out + 4 * p) =
        make_int4(b.ms, b.mi, b.mj, nr);
  }
  __syncwarp();
  if (valid) {
    int32_t* row = a.runs_out + p * a.rmax;
    for (int k = gl; k < a.rmax; k += LANES) row[k] = runs[k];
  }
}

// A warp's rows [p0, p0 + ROWS_PER_WARP) at LANES lanes a problem: 32 /
// LANES of them a pass, each pass in the same shared memory.
template <int LANES, bool DENSE>
__device__ __forceinline__ void trace_rows(const TbArgs& a, int64_t p0,
                                           uint32_t* base) {
  constexpr int G = 32 / LANES;
  const int g = (threadIdx.x & 31) / LANES;
  base += g * swg::problem_smem_words(a.g.xmax, a.g.ymax, a.rmax, LANES,
                                      swg::ROWS_SLOTS);
#pragma unroll 1
  for (int t = 0; t < swg::ROWS_PER_WARP && p0 + t < a.g.n; t += G) {
    trace_problem<LANES, swg::ROWS_SLOTS, DENSE>(a, p0 + t + g, base);
    __syncwarp();  // the next pass writes where this one read
  }
}

template <bool DENSE>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    swg_traceback_rows_kernel(const TbArgs a, int warps) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  // the last rows first: a caller that orders rows by ylen has its longest
  // problems there, and the launch then ends on its shortest warps
  const int64_t p0 = ((int64_t)(gridDim.x - 1 - blockIdx.x) * warps + warp) *
                     swg::ROWS_PER_WARP;
  if (p0 >= a.g.n) return;  // whole warps only; no block barrier follows
  uint32_t* base = smem + warp * swg::rows_warp_words(a.g.xmax, a.g.ymax,
                                                      a.rmax);
  const int32_t* rows = DENSE ? a.params : a.g.meta;
  switch (swg::warp_lanes(rows, a.g.meta_cols, DENSE, p0, a.g.n)) {
    case 8: trace_rows<8, DENSE>(a, p0, base); break;
    case 16: trace_rows<16, DENSE>(a, p0, base); break;
    default: trace_rows<32, DENSE>(a, p0, base);
  }
}

// Above 128 slots a launch: one warp a problem, SLOTS slots a lane.
template <int SLOTS, bool DENSE>
__global__ void __launch_bounds__(MAX_WARPS * 32)
    swg_traceback_kernel(const TbArgs a, int warps) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int64_t p = (int64_t)blockIdx.x * warps + warp;
  if (p >= a.g.n) return;  // whole warps only; no block barrier follows
  trace_problem<32, SLOTS, DENSE>(
      a, p,
      smem + warp * swg::problem_smem_words(a.g.xmax, a.g.ymax, a.rmax, 32,
                                            SLOTS));
}

// Launch `kernel`, each warp of which takes `per_warp` rows and `words`
// words of shared memory.
int launch(void (*kernel)(const TbArgs, int), const TbArgs& a, int words,
           int per_warp, cudaStream_t stream) {
  const int warps = swg::warps_per_block(words, MAX_WARPS);
  if (warps < 1) return ERR_ARGS;
  const size_t smem = (size_t)warps * words * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t per_block = (int64_t)warps * per_warp;
  const int64_t blocks = (a.g.n + per_block - 1) / per_block;
  kernel<<<(unsigned)blocks, warps * 32, smem, stream>>>(a, warps);
  return (int)cudaGetLastError();
}

template <int SLOTS, bool DENSE>
int launch_wide(const TbArgs& a, cudaStream_t s) {
  return launch(swg_traceback_kernel<SLOTS, DENSE>, a,
                swg::problem_smem_words(a.g.xmax, a.g.ymax, a.rmax, 32, SLOTS),
                1, s);
}

template <bool DENSE>
int dispatch(const TbArgs& a, int band_max, cudaStream_t s) {
  if (a.rmax < 1) return ERR_ARGS;
  if (swg::rows_launch(band_max, a.g.xmax))
    return launch(swg_traceback_rows_kernel<DENSE>, a,
                  swg::rows_warp_words(a.g.xmax, a.g.ymax, a.rmax),
                  swg::ROWS_PER_WARP, s);
  switch (swg::slots_for(band_max, a.g.xmax)) {
    case 8: return launch_wide<8, DENSE>(a, s);
    case 16: return launch_wide<16, DENSE>(a, s);
    case 32: return launch_wide<32, DENSE>(a, s);
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
