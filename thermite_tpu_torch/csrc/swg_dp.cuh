// The banded SWG DP core shared by the three kernels (swg_stream.cu,
// swg_stream_wide.cu, swg_forward.cu): one warp per problem, band slot
// s = lane*SLOTS + k on lane `lane`, register k.  Device code only; the
// scalar pieces it calls are in swg_stream.cuh.
//
// Semantics are the reference's DP column step (thermite_tpu/ops/
// swg_pallas.py::_dp_column_step): the running max moves only on a
// strict increase, the lowest slot wins a column tie, an X-drop stop in
// either phase ends the problem, and band exhaustion past row xlen is
// not an X-drop for the certificate.
#pragma once

#include <cuda_runtime.h>

#include "swg_stream.cuh"

namespace swg {

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
  int32_t* hdr;      // stream kernels: (n, 2) int16 halves; forward: (n, 4)
  int32_t* streams;  // stream kernels: (n, smax/16); forward: unused
};

// The problem's x and y codes into shared memory (bytes), one lane per
// position; the caller syncs the warp.
__device__ __forceinline__ void gather_windows(const Meta& m, const Args& a,
                                               uint8_t* xs, uint8_t* ys) {
  const int lane = threadIdx.x & 31;
  const int nx = min(m.xlen, a.xmax), ny = min(m.ylen, a.ymax);
  for (int k = lane; k < nx; k += 32)
    xs[k] = (uint8_t)nib_at(a.reads, a.reads_lw,
                            m.x_anchor + (int64_t)m.x_dir * k);
  for (int k = lane; k < ny; k += 32)
    ys[k] = (uint8_t)nib_at(a.ref, a.ref_lw,
                            m.y_anchor + (int64_t)m.y_dir * k);
}

struct Best {
  int32_t ms, mi, mj;
  bool cert;  // band-exactness certificate (WALK only)
};

// The forward pass of one problem.  With WALK, every column's
// directions go to `planes` (2*SLOTS ballot words per column, lane 0
// stores) and the certificate is computed; without, neither.  Needs
// 32*SLOTS >= min(2b+1, xlen+1) (slots_for).
template <int SLOTS, bool WALK>
__device__ __forceinline__ Best dp(const Meta& m, const uint8_t* xs,
                                   const uint8_t* ys, uint32_t* planes,
                                   int xmax, int ymax) {
  const int lane = threadIdx.x & 31;
  const int b2 = 2 * m.band;
  const int nx = min(m.xlen, xmax);
  int32_t D[SLOTS], C[SLOTS];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int s = lane * SLOTS + k;
    D[k] = s == 0 ? 0 : (s <= b2 ? s * GAP_EXTEND + GAP_OPEN : MIN_SCORE);
    C[k] = s == 0 ? 0 : MIN_SCORE;
    if (WALK) {
      const unsigned ins = __ballot_sync(FULL, s <= b2);  // column 0: Ins
      if (lane == 0) planes[2 * k] = planes[2 * k + 1] = ins;
    }
  }
  int32_t ms = 0, mi = 0, mj = 0;
  int32_t cmin = 1 << 30;
  const int32_t e_ladder = GAP_OPEN + (m.band + 1) * GAP_EXTEND;
  const int32_t ub_final = m.xlen * MATCH + e_ladder;
  int32_t ecap = ub_final;
  bool rstop = false;
  const int ncols = min(m.ylen, ymax);

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
      if (comp[k]) {
        D[k] = dn;
        C[k] = cval[k];
      }
      dfm[k] = comp[k] ? dn : MIN_SCORE;
      lmax = k == 0 ? dfm[0] : max(lmax, dfm[k]);
      if (WALK) {
        int dir = dn == dval[k] ? (match[k] ? DIR_MATCH : DIR_SUBST)
                                : (dn == cval[k] ? DIR_DEL : DIR_INS);
        if (!comp[k]) dir = DIR_MATCH;
        const unsigned b0 = __ballot_sync(FULL, dir & 1);
        const unsigned b1 = __ballot_sync(FULL, dir >> 1);
        if (lane == 0) {
          planes[(int64_t)j * 2 * SLOTS + 2 * k] = b0;
          planes[(int64_t)j * 2 * SLOTS + 2 * k + 1] = b1;
        }
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
  Best r{ms, mi, mj, false};
  if (WALK) {
    const int32_t cert_ub = rstop ? ecap + m.xdrop : ub_final;
    r.cert = cmin > -m.xdrop && ms > cert_ub;
  }
  return r;
}

// One problem of a stream kernel: the forward pass with directions,
// then the walk on lane 0 into `words` (pw words of shared memory), the
// header to hdr_out and the codes to out_streams.
template <int SLOTS>
__device__ __forceinline__ void stream_problem(const Meta& m, const uint8_t* xs,
                                               const uint8_t* ys,
                                               uint32_t* planes,
                                               uint32_t* words, const Args& a,
                                               int32_t* hdr_out,
                                               int32_t* out_streams) {
  const int lane = threadIdx.x & 31;
  const int pw = a.smax / 16;
  const Best b = dp<SLOTS, true>(m, xs, ys, planes, a.xmax, a.ymax);
  for (int w = lane; w < pw; w += 32) words[w] = 0;
  __syncwarp();
  if (lane == 0) {
    const WalkEnd we = walk<SLOTS>(planes, b.mi, b.mj, m.band, a.smax, words,
                                   pw);
    pack_hdr(b.ms, b.mi, b.mj, nsteps_code(we, b.cert), hdr_out);
  }
  __syncwarp();
  for (int w = lane; w < pw; w += 32) out_streams[w] = (int32_t)words[w];
}

}  // namespace swg
