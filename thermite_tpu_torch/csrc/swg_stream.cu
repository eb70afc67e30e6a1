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
// codes with uint32 shifts.

#include <cuda_runtime.h>

#include "swg_stream.cuh"

namespace {

constexpr int WARPS = 4;  // problems per block
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Args {
  const int32_t* ref;
  int64_t ref_lw;
  const int32_t* reads;
  int64_t reads_lw;
  const int32_t* meta;
  int meta_cols;
  int64_t n;
  int xmax, ymax, smax;
  int32_t* hdr;
  int32_t* streams;
};

// per-warp shared memory in 32-bit words: direction planes sized for
// two slots per lane, the packed stream, then x and y codes as bytes
__host__ __device__ inline int warp_smem_words(int xmax, int ymax, int pw) {
  return (ymax + 1) * 4 + pw + (xmax + 3) / 4 + (ymax + 3) / 4;
}

template <int SLOTS>
__device__ void solve(const swg::Meta& m, const uint8_t* xs,
                      const uint8_t* ys, uint32_t* planes, uint32_t* words,
                      const Args& a, int32_t* hdr_out) {
  using namespace swg;
  const int lane = threadIdx.x & 31;
  const int pw = a.smax / 16;
  const int b2 = 2 * m.band;
  const int nx = min(m.xlen, a.xmax);
  int32_t D[SLOTS], C[SLOTS];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int s = lane * SLOTS + k;
    D[k] = s == 0 ? 0 : (s <= b2 ? s * GAP_EXTEND + GAP_OPEN : MIN_SCORE);
    C[k] = s == 0 ? 0 : MIN_SCORE;
    const unsigned ins = __ballot_sync(FULL, s <= b2);  // column 0: Ins
    if (lane == 0) planes[2 * k] = planes[2 * k + 1] = ins;
  }
  int32_t ms = 0, mi = 0, mj = 0;
  int32_t cmin = 1 << 30;
  const int32_t e_ladder = GAP_OPEN + (m.band + 1) * GAP_EXTEND;
  const int32_t ub_final = m.xlen * MATCH + e_ladder;
  int32_t ecap = ub_final;
  bool rstop = false;
  const int ncols = min(m.ylen, a.ymax);

  for (int j = 1; j <= ncols; ++j) {
    const bool in_p1 = j <= m.band;  // band anchored at row 0
    const int row0 = in_p1 ? 0 : j - m.band;
    const int yj = ys[j - 1];
    const int32_t d_next = __shfl_down_sync(FULL, D[0], 1);
    const int32_t c_next = __shfl_down_sync(FULL, C[0], 1);
    const int32_t d_prev = __shfl_up_sync(FULL, D[SLOTS - 1], 1);

    int32_t dval[SLOTS], cval[SLOTS], aval[SLOTS], incl[SLOTS];
    bool match[SLOTS], comp[SLOTS];
    int32_t run = PAD;
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int s = lane * SLOTS + k;
      // previous column at slots s+1 (left, after the band slides) and
      // s-1 (diagonal while the band is anchored)
      const int32_t dl = k + 1 < SLOTS ? D[(k + 1) % SLOTS]
                                       : (lane == 31 ? MIN_SCORE : d_next);
      const int32_t cl = k + 1 < SLOTS ? C[(k + 1) % SLOTS]
                                       : (lane == 31 ? MIN_SCORE : c_next);
      const int32_t dr = k > 0 ? D[(k + SLOTS - 1) % SLOTS]
                               : (lane == 0 ? MIN_SCORE : d_prev);
      const int32_t dp = in_p1 ? D[k] : dl;
      const int32_t cp = in_p1 ? C[k] : cl;
      const int32_t dm = in_p1 ? dr : D[k];
      comp[k] = s <= b2 && s <= m.xlen - row0;
      const int xi = row0 + s - 1;
      const int xc = (xi >= 0 && xi < nx) ? xs[xi] : 0;
      int32_t cv = max(cp + GAP_EXTEND, dp + GAP_EXTEND + GAP_OPEN);
      if (!in_p1 && s == b2) cv = MIN_SCORE;
      const bool row_is0 = s == 0 && in_p1;
      match[k] = xc == yj && !row_is0;
      dval[k] = row_is0 ? MIN_SCORE : dm + (match[k] ? MATCH : MISMATCH);
      cval[k] = cv;
      aval[k] = max(dval[k], cv);
      run = max(run, (comp[k] ? aval[k] : MIN_SCORE) - s * GAP_EXTEND);
      incl[k] = run;
    }
    // insertion chain: exclusive prefix max of (A - s*e) over lower slots
    int32_t ex = __shfl_up_sync(FULL, run, 1);
    if (lane == 0) ex = PAD;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int32_t v = __shfl_up_sync(FULL, ex, off);
      if (lane >= off) ex = max(ex, v);
    }

    int32_t dfm[SLOTS];
    int32_t lmax = MIN_SCORE;
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int s = lane * SLOTS + k;
      const int32_t pm = k == 0 ? ex : max(ex, incl[(k + SLOTS - 1) % SLOTS]);
      const int32_t rv = s == 0 ? MIN_SCORE : GAP_OPEN + s * GAP_EXTEND + pm;
      const int32_t dn = max(aval[k], rv);
      int dir = dn == dval[k] ? (match[k] ? DIR_MATCH : DIR_SUBST)
                              : (dn == cval[k] ? DIR_DEL : DIR_INS);
      if (comp[k]) {
        D[k] = dn;
        C[k] = cval[k];
      } else {
        dir = DIR_MATCH;
      }
      dfm[k] = comp[k] ? dn : MIN_SCORE;
      lmax = k == 0 ? dfm[0] : max(lmax, dfm[k]);
      const unsigned b0 = __ballot_sync(FULL, dir & 1);
      const unsigned b1 = __ballot_sync(FULL, dir >> 1);
      if (lane == 0) {
        planes[(int64_t)j * 2 * SLOTS + 2 * k] = b0;
        planes[(int64_t)j * 2 * SLOTS + 2 * k + 1] = b1;
      }
    }
    // column max and the lowest slot reaching it
    const int32_t band_max = __reduce_max_sync(FULL, lmax);
    int lk = SLOTS;
#pragma unroll
    for (int k = SLOTS - 1; k >= 0; --k)
      if (dfm[k] == band_max) lk = k;
    const int fl = __ffs(__ballot_sync(FULL, lk < SLOTS)) - 1;
    const int col_arg = fl * SLOTS + __shfl_sync(FULL, lk, fl);
    if (band_max > ms) {  // strict: the first cell reaching the max wins
      ms = band_max;
      mi = row0 + col_arg;
      mj = j;
    }
    const bool dropped = band_max < ms - m.xdrop;
    const int32_t ej = min(j, m.xlen) * MATCH + e_ladder;
    if (!dropped) {
      cmin = min(cmin, band_max - ej);
    } else {
      // a real x-drop, not band exhaustion past row xlen
      if (band_max > MIN_SCORE) {
        ecap = ej;
        rstop = true;
      }
      break;
    }
  }
  const int32_t cert_ub = rstop ? ecap + m.xdrop : ub_final;
  const bool cert = cmin > -m.xdrop && ms > cert_ub;

  for (int w = lane; w < pw; w += 32) words[w] = 0;
  __syncwarp();
  if (lane == 0) {
    const WalkEnd we = walk<SLOTS>(planes, mi, mj, m.band, a.smax, words, pw);
    pack_hdr(ms, mi, mj, nsteps_code(we, cert), hdr_out);
  }
  __syncwarp();
}

__global__ void __launch_bounds__(WARPS * 32)
    swg_stream_kernel(const Args a) {
  extern __shared__ uint32_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t p = (int64_t)blockIdx.x * WARPS + warp;
  if (p >= a.n) return;  // whole warps only; no block barrier follows
  const int pw = a.smax / 16;
  uint32_t* planes = smem + warp * warp_smem_words(a.xmax, a.ymax, pw);
  uint32_t* words = planes + (a.ymax + 1) * 4;
  uint8_t* xs = reinterpret_cast<uint8_t*>(words + pw);
  uint8_t* ys = xs + 4 * ((a.xmax + 3) / 4);

  const swg::Meta m = swg::unpack_meta(a.meta + p * a.meta_cols, a.meta_cols);
  const int nx = min(m.xlen, a.xmax), ny = min(m.ylen, a.ymax);
  for (int k = lane; k < nx; k += 32)
    xs[k] = (uint8_t)swg::nib_at(a.reads, a.reads_lw,
                                 m.x_anchor + (int64_t)m.x_dir * k);
  for (int k = lane; k < ny; k += 32)
    ys[k] = (uint8_t)swg::nib_at(a.ref, a.ref_lw,
                                 m.y_anchor + (int64_t)m.y_dir * k);
  __syncwarp();

  int32_t* hdr_out = a.hdr + 2 * p;
  if (m.band <= 15) {
    solve<1>(m, xs, ys, planes, words, a, hdr_out);
  } else if (m.band <= 31) {
    solve<2>(m, xs, ys, planes, words, a, hdr_out);
  } else {
    __trap();  // callers check bands on the host; kernel #2 serves wider
  }
  int32_t* out = a.streams + p * pw;
  for (int w = lane; w < pw; w += 32) out[w] = (int32_t)words[w];
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
  const size_t smem =
      (size_t)WARPS * warp_smem_words(xmax, ymax, smax / 16) * 4;
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
