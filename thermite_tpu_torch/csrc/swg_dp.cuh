// The banded SWG DP core shared by the four kernels (swg_stream.cu for
// both stream kernels, swg_forward.cu, swg_traceback.cu), as sub-warp
// groups: a problem takes LANES lanes of a warp (8, 16 or 32) with SLOTS
// band slots each in registers (band slot s on group lane s / SLOTS,
// register s % SLOTS), and a warp carries 32 / LANES problems side by
// side.  Device code only; the scalar pieces it calls are in
// swg_stream.cuh.
//
// What a column costs, and what the groups do about it.  An SM issues
// far fewer shuffle/vote instructions a clock than integer ones, and a
// column needs, whatever LANES is: two neighbour shuffles, the insertion
// chain's exclusive prefix max (1 + log2(LANES) shuffles), one redux for
// the column max and one for its lowest slot.  With 32 / LANES problems
// in the warp those instructions are shared by all of them, so at 8
// lanes a problem pays a quarter of 7 instead of the 14 that one warp per
// problem paid at one slot a lane (3 neighbour shuffles, 6 for the scan,
// a redux, a ballot and a shuffle for the arg-min, two direction
// ballots).  Within a lane the chain over its SLOTS slots is a serial
// running max.  Directions need no ballot: each lane packs the 2-bit
// directions of its own slots and stores them itself.
//
// The groups of a warp stay converged: every lane runs the columns of the
// warp's longest problem, a group whose problem has ended (ylen reached,
// or X-drop) computes on without changing its state, and every eighth
// column one vote ends the loop once all groups are done.
//
// Semantics are the reference's DP column step (its _dp_column_step): the
// running max moves only on a strict increase, the lowest slot wins a
// column tie, an X-drop stop in either phase ends the problem, and band
// exhaustion past row xlen is not an X-drop for the certificate.
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

// This lane's index in its group, and the warp mask of the group.
template <int LANES>
__device__ __forceinline__ int group_lane() {
  return threadIdx.x & (LANES - 1);
}

template <int LANES>
__device__ __forceinline__ unsigned group_mask() {
  if constexpr (LANES == 32) {
    return FULL;
  } else {
    return ((1u << LANES) - 1u) << (threadIdx.x & 31 & ~(LANES - 1));
  }
}

// A problem that does not exist (past the launch's n): no columns, no
// cells, so its group idles through the warp's loop.
__device__ __forceinline__ Meta empty_problem() {
  Meta m;
  m.y_anchor = m.x_anchor = 0;
  m.y_dir = m.x_dir = 1;
  m.ylen = m.xlen = 0;
  m.band = m.xdrop = 1;
  return m;
}

// The problem's x and y codes into shared memory (bytes), one group lane
// per position; the caller syncs the warp.  The x window is padded: xs[t]
// is x[t - 1], and xs[0] and xs[nx + 1] are zero (the code read before
// and past the window).
template <int LANES>
__device__ __forceinline__ void gather_windows(const Meta& m, const Args& a,
                                               uint8_t* xs, uint8_t* ys) {
  const int gl = group_lane<LANES>();
  const int nx = min(m.xlen, a.xmax), ny = min(m.ylen, a.ymax);
  if (gl == 0) xs[0] = xs[nx + 1] = 0;
  for (int k = gl; k < nx; k += LANES)
    xs[k + 1] = (uint8_t)nib_at(a.reads, a.reads_lw,
                                m.x_anchor + (int64_t)m.x_dir * k);
  for (int k = gl; k < ny; k += LANES)
    ys[k] = (uint8_t)nib_at(a.ref, a.ref_lw,
                            m.y_anchor + (int64_t)m.y_dir * k);
}

// One lane's directions of one column (2 bits a slot, slot k at bits 2k)
// into its cell `idx` = j * LANES + group lane of the planes.
template <int SLOTS>
__device__ __forceinline__ void store_dirs(uint8_t* planes, int idx,
                                           const uint32_t* bits) {
  constexpr int BPL = dir_bytes(SLOTS);
  if (BPL == 1) {
    planes[idx] = (uint8_t)bits[0];
  } else if (BPL == 2) {
    reinterpret_cast<uint16_t*>(planes)[idx] = (uint16_t)bits[0];
  } else if (BPL == 4) {
    reinterpret_cast<uint32_t*>(planes)[idx] = bits[0];
  } else {
    reinterpret_cast<uint2*>(planes)[idx] =
        make_uint2(bits[0], bits[(SLOTS > 16) ? 1 : 0]);
  }
}

struct Best {
  int32_t ms, mi, mj;
  bool cert;  // band-exactness certificate (WALK only)
};

// max(a + b, c) in one instruction (Hopper's DPX VIADDMNMX).
__device__ __forceinline__ int32_t add_max(int32_t a, int32_t b, int32_t c) {
  return __viaddmax_s32(a, b, c);
}

// One lane's state of the forward pass: SLOTS band slots of the previous
// column (D best score, C best score ending in a deletion), the x code
// each slot reads in the current column, and the group's running result.
template <int SLOTS>
struct LaneState {
  int32_t D[SLOTS], C[SLOTS], xr[SLOTS];
  int32_t ms, mi, mj, cmin, ecap;
  bool rstop, live;
};

// One column j of the forward pass for every group of the warp.  SLIDE:
// every group of the warp is past its anchored phase (j > band), so the
// band slides one row a column; else each group tells by its own band.
// `xs` is the padded x window: xs[t] is x[t - 1], zero at t = 0 and past
// the window.
template <int LANES, int SLOTS, bool WALK, bool SLIDE>
__device__ __forceinline__ void dp_column(LaneState<SLOTS>& st, const Meta& m,
                                          int j, int ncols, int nx,
                                          const uint8_t* xs, const uint8_t* ys,
                                          uint8_t* planes, int32_t e_ladder) {
  const int gl = group_lane<LANES>();
  const int s0 = gl * SLOTS;
  const unsigned gmask = group_mask<LANES>();
  const bool act = st.live && j <= ncols;
  const bool in_p1 = SLIDE ? false : j <= m.band;  // band anchored at row 0
  const int row0 = in_p1 ? 0 : j - m.band;
  const int yj = ys[j - 1];
  // slots this column computes: s <= 2b and row0 + s <= xlen; none once
  // the problem has ended
  const int lim = act ? min(2 * m.band, m.xlen - row0) : -1;
  if (!in_p1) {  // the band slid one row: every slot reads the next x
#pragma unroll
    for (int k = 0; k + 1 < SLOTS; ++k) st.xr[k] = st.xr[k + 1];
    st.xr[SLOTS - 1] = xs[min(row0 + s0 + SLOTS - 1, nx + 1)];
  }
  // the neighbour lane's edge slot of the previous column: slot s - 1
  // (diagonal) while the band is anchored, slot s + 1 (left) once it
  // slides
  const int32_t d_nb =
      SLIDE ? __shfl_down_sync(FULL, st.D[0], 1, LANES)
            : __shfl_sync(FULL, in_p1 ? st.D[SLOTS - 1] : st.D[0],
                          in_p1 ? gl - 1 : gl + 1, LANES);
  const int32_t c_next = __shfl_down_sync(FULL, st.C[0], 1, LANES);

  int32_t dval[SLOTS], cval[SLOTS], aval[SLOTS], incl[SLOTS];
  bool match[SLOTS], comp[SLOTS];
  int32_t run = PAD;
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int s = s0 + k;
    const int32_t dl = k + 1 < SLOTS ? st.D[(k + 1) % SLOTS]
                                     : (gl == LANES - 1 ? MIN_SCORE : d_nb);
    const int32_t cl = k + 1 < SLOTS ? st.C[(k + 1) % SLOTS]
                                     : (gl == LANES - 1 ? MIN_SCORE : c_next);
    const int32_t dr = k > 0 ? st.D[(k + SLOTS - 1) % SLOTS]
                             : (gl == 0 ? MIN_SCORE : d_nb);
    const int32_t dp = in_p1 ? st.D[k] : dl;
    const int32_t cp = in_p1 ? st.C[k] : cl;
    const int32_t dm = in_p1 ? dr : st.D[k];
    comp[k] = s <= lim;
    // at slot 2b of a sliding band the left cell is outside the band: it
    // is slot 2b + 1, which is never computed and holds MIN_SCORE + 1 in D
    // and C from the start, so this is MIN_SCORE there with no test
    const int32_t cv = add_max(cp, GAP_EXTEND, dp + GAP_EXTEND + GAP_OPEN);
    const bool row_is0 = !SLIDE && s == 0 && in_p1;
    match[k] = st.xr[k] == yj && !row_is0;
    dval[k] = row_is0 ? MIN_SCORE : dm + (match[k] ? MATCH : MISMATCH);
    cval[k] = cv;
    aval[k] = max(dval[k], cv);
    run = add_max(comp[k] ? aval[k] : MIN_SCORE, -s * GAP_EXTEND, run);
    incl[k] = run;
  }
  // insertion chain: exclusive prefix max of (A - s*e) over lower slots
  int32_t ex = __shfl_up_sync(FULL, run, 1, LANES);
  if (gl == 0) ex = PAD;
#pragma unroll
  for (int off = 1; off < LANES; off <<= 1) {
    const int32_t v = __shfl_up_sync(FULL, ex, off, LANES);
    if (gl >= off) ex = max(ex, v);
  }

  int32_t dfm[SLOTS];
  int32_t lmax = MIN_SCORE;
  uint32_t bits[2] = {0u, 0u};
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int s = s0 + k;
    const int32_t pm = k == 0 ? ex : max(ex, incl[(k + SLOTS - 1) % SLOTS]);
    // R = o + s*e + prefix; at slot 0 the prefix is PAD, far below every
    // computed cell, which stands for the reference's MIN_SCORE there
    const int32_t dn = add_max(pm, GAP_OPEN + s * GAP_EXTEND, aval[k]);
    if (comp[k]) {
      st.D[k] = dn;
      st.C[k] = cval[k];
    }
    dfm[k] = comp[k] ? dn : MIN_SCORE;
    lmax = k == 0 ? dfm[0] : max(lmax, dfm[k]);
    if (WALK) {
      int dir = dn == dval[k] ? (match[k] ? DIR_MATCH : DIR_SUBST)
                              : (dn == cval[k] ? DIR_DEL : DIR_INS);
      if (!comp[k]) dir = DIR_MATCH;
      bits[k >> 4] |= (uint32_t)dir << (2 * (k & 15));
    }
  }
  if (WALK && act) store_dirs<SLOTS>(planes, j * LANES + gl, bits);
  // column max and the lowest slot reaching it
  const int32_t band_max = __reduce_max_sync(gmask, lmax);
  int lk = SLOTS;
#pragma unroll
  for (int k = SLOTS - 1; k >= 0; --k)
    if (dfm[k] == band_max) lk = k;
  const int col_arg = (int)__reduce_min_sync(
      gmask, lk < SLOTS ? (unsigned)(s0 + lk) : 0xFFFFu);
  if (act) {
    if (band_max > st.ms) {  // strict: the first cell reaching the max wins
      st.ms = band_max;
      st.mi = row0 + col_arg;
      st.mj = j;
    }
    const int32_t ej = min(j, m.xlen) * MATCH + e_ladder;
    if (band_max >= st.ms - m.xdrop) {
      st.cmin = min(st.cmin, band_max - ej);
    } else {
      // a real x-drop, not band exhaustion past row xlen
      if (band_max > MIN_SCORE) {
        st.ecap = ej;
        st.rstop = true;
      }
      st.live = false;
    }
  }
}

// The forward pass of this lane's group's problem; every lane of the
// warp calls it together.  `xs` is the padded x window (see dp_column).
// With WALK, every column's directions go to `planes` (8-byte aligned)
// and the certificate is computed; without, neither.  Needs LANES * SLOTS
// >= min(2b+1, xlen+1).  All lanes of a group return the same Best.
template <int LANES, int SLOTS, bool WALK>
__device__ __forceinline__ Best dp(const Meta& m, const uint8_t* xs,
                                   const uint8_t* ys, uint8_t* planes,
                                   int xmax, int ymax) {
  const int gl = group_lane<LANES>();
  const int b2 = 2 * m.band;
  const int nx = min(m.xlen, xmax);
  LaneState<SLOTS> st;
  {
    uint32_t bits[2] = {0u, 0u};  // column 0: Ins along the band
#pragma unroll
    for (int k = 0; k < SLOTS; ++k) {
      const int s = gl * SLOTS + k;
      // slots past 2b are never computed; MIN_SCORE + 1 there makes the
      // deletion score of slot 2b come out MIN_SCORE (see dp_column)
      st.D[k] = s == 0 ? 0 : (s <= b2 ? s * GAP_EXTEND + GAP_OPEN
                                      : MIN_SCORE + 1);
      st.C[k] = s == 0 ? 0 : (s <= b2 ? MIN_SCORE : MIN_SCORE + 1);
      st.xr[k] = xs[min(s, nx + 1)];
      if (WALK && s <= b2) bits[k >> 4] |= (uint32_t)DIR_INS << (2 * (k & 15));
    }
    if (WALK) store_dirs<SLOTS>(planes, gl, bits);
  }
  st.ms = st.mi = st.mj = 0;
  st.cmin = 1 << 30;
  const int32_t e_ladder = GAP_OPEN + (m.band + 1) * GAP_EXTEND;
  const int32_t ub_final = m.xlen * MATCH + e_ladder;
  st.ecap = ub_final;
  st.rstop = false;
  st.live = true;  // this group's problem has not ended
  const int ncols = min(m.ylen, ymax);
  // the warp runs the columns of its longest problem, and the sliding
  // form of the column once its widest band is anchored no more
  const int wcols = LANES == 32 ? ncols : __reduce_max_sync(FULL, ncols);
  const int wband = LANES == 32 ? m.band : __reduce_max_sync(FULL, m.band);

  for (int j = 1; j <= wcols; ++j) {
    if (LANES == 32) {
      if (!st.live) break;
    } else if ((j & 7) == 0 && !__any_sync(FULL, st.live && j <= ncols)) {
      break;
    }
    if (j > wband)
      dp_column<LANES, SLOTS, WALK, true>(st, m, j, ncols, nx, xs, ys, planes,
                                          e_ladder);
    else
      dp_column<LANES, SLOTS, WALK, false>(st, m, j, ncols, nx, xs, ys, planes,
                                           e_ladder);
  }
  Best r{st.ms, st.mi, st.mj, false};
  if (WALK) {
    const int32_t cert_ub = st.rstop ? st.ecap + m.xdrop : ub_final;
    r.cert = st.cmin > -m.xdrop && st.ms > cert_ub;
  }
  return r;
}

// One problem of a stream kernel: the forward pass with directions, then
// the walk on the group's first lane (the warp's groups walk side by
// side) into `words` (pw words of shared memory), the header to hdr_out
// and the codes to out_streams.  `valid` is false for a group past the
// launch's last problem: it takes part in the warp's loop and writes
// nothing.
template <int LANES, int SLOTS>
__device__ __forceinline__ void stream_problem(const Meta& m, bool valid,
                                               const uint8_t* xs,
                                               const uint8_t* ys,
                                               uint8_t* planes,
                                               uint32_t* words, const Args& a,
                                               int32_t* hdr_out,
                                               int32_t* out_streams) {
  const int gl = group_lane<LANES>();
  const int pw = a.smax / 16;
  const Best b = dp<LANES, SLOTS, true>(m, xs, ys, planes, a.xmax, a.ymax);
  for (int w = gl; w < pw; w += LANES) words[w] = 0;
  __syncwarp();
  if (gl == 0 && valid) {
    const WalkEnd we = walk<LANES, SLOTS>(planes, b.mi, b.mj, m.band, a.smax,
                                          words, pw);
    pack_hdr(b.ms, b.mi, b.mj, nsteps_code(we, b.cert), hdr_out);
  }
  __syncwarp();
  if (valid)
    for (int w = gl; w < pw; w += LANES) out_streams[w] = (int32_t)words[w];
}

// The stream kernels' body: `warps` warps a block, 32 / LANES problems a
// warp, problem p's shared memory at p's index in the block.
template <int LANES, int SLOTS>
__global__ void __launch_bounds__(128)
    stream_kernel(const Args a, int warps) {
  extern __shared__ uint32_t smem[];
  constexpr int G = 32 / LANES;
  // this lane's problem: its index in the block, then in the launch
  const int q = (threadIdx.x >> 5) * G + (threadIdx.x & 31) / LANES;
  const int64_t p = ((int64_t)blockIdx.x * warps) * G + q;
  const bool valid = p < a.n;
  const int pw = a.smax / 16;
  uint32_t* base =
      smem + (int64_t)q * problem_smem_words(a.xmax, a.ymax, pw, LANES, SLOTS);
  uint8_t* planes = reinterpret_cast<uint8_t*>(base);
  uint32_t* words =
      base + ((a.ymax + 1) * LANES * dir_bytes(SLOTS) + 3) / 4;
  uint8_t* xs = reinterpret_cast<uint8_t*>(words + pw);
  uint8_t* ys = xs + x_window_bytes(a.xmax);

  const Meta m = valid ? unpack_meta(a.meta + p * a.meta_cols, a.meta_cols)
                       : empty_problem();
  gather_windows<LANES>(m, a, xs, ys);
  __syncwarp();
  stream_problem<LANES, SLOTS>(m, valid, xs, ys, planes, words, a,
                               a.hdr + 2 * p, a.streams + p * pw);
}

constexpr int ERR_ARGS = -1;  // shapes a kernel does not take

// Launch stream_kernel<LANES, SLOTS> on `stream`, at most 4 warps a block
// and as many as the opt-in shared memory holds; -> the cudaError_t of the
// launch, or ERR_ARGS when one warp's problems do not fit.
template <int LANES, int SLOTS>
int launch_stream(const Args& a, cudaStream_t stream) {
  constexpr int G = 32 / LANES;
  const int words =
      G * problem_smem_words(a.xmax, a.ymax, a.smax / 16, LANES, SLOTS);
  const int warps = warps_per_block(words, 4);
  if (warps < 1) return ERR_ARGS;
  const size_t smem = (size_t)warps * words * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stream_kernel<LANES, SLOTS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t per_block = (int64_t)warps * G;
  const int64_t blocks = (a.n + per_block - 1) / per_block;
  stream_kernel<LANES, SLOTS>
      <<<(unsigned)blocks, warps * 32, smem, stream>>>(a, warps);
  return (int)cudaGetLastError();
}

}  // namespace swg
