// Scalar pieces of the SWG kernels (swg_stream.cu, swg_forward.cu,
// swg_traceback.cu) that run the same on the host and the
// device: meta unpacking, the nibble gather, the group shape (lanes and
// slots) of a launch or of one warp's rows, shared-memory sizing, the
// direction-plane layout, the
// per-problem traceback walks (2-bit code packing, run-length runs), and
// the header packing.  Compiled
// by nvcc for the kernels and by g++ for the host test harness
// (swg_stream_host.cpp), so this logic is tested on a machine without a
// GPU.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __host__
#define __device__
#define __forceinline__ inline
#endif

namespace swg {

// Unit scoring (constants.py).
constexpr int32_t MATCH = 1;
constexpr int32_t MISMATCH = -1;
constexpr int32_t GAP_OPEN = -1;
constexpr int32_t GAP_EXTEND = -1;
constexpr int32_t MIN_SCORE = -(1 << 30);
// exclusive prefix-max identity, below every reachable score
constexpr int32_t PAD = (int32_t)(-2147483647 - 1) + (1 << 21);

constexpr int DIR_MATCH = 0;
constexpr int DIR_SUBST = 1;
constexpr int DIR_DEL = 2;
constexpr int DIR_INS = 3;

// zero bytes padding both ends of the nibble-packed text and reads
constexpr int WPAD = 512;

struct Meta {
  int64_t y_anchor;  // nibble position of y[0] in the text words
  int64_t x_anchor;  // nibble position of x[0] in the read words
  int y_dir, x_dir;  // +1 forward, -1 reversed (window ends at anchor)
  int ylen, xlen, band, xdrop;
};

// One problem row, 9 columns [y_word, y_sub, y_dir, ylen, x_base,
// x_dir, xlen, band, x_drop] or the 4-column packed upload form
// (layout.pack_meta_host).
__host__ __device__ __forceinline__ Meta unpack_meta(const int32_t* r,
                                                     int cols) {
  Meta m;
  if (cols == 9) {
    m.y_anchor = 8 * (int64_t)r[0] + r[1];
    m.y_dir = r[2];
    m.ylen = r[3];
    m.x_anchor = (int64_t)r[4] + WPAD;
    m.x_dir = r[5];
    m.xlen = r[6];
    m.band = r[7];
    m.xdrop = r[8];
  } else {
    const uint32_t c2 = (uint32_t)r[2], c3 = (uint32_t)r[3];
    m.y_anchor = 8 * (int64_t)r[0] + (int64_t)(c3 & 7u);
    m.x_anchor = (int64_t)r[1] + WPAD;
    m.ylen = (int)(c2 & 0xFFFFu);
    m.xlen = (int)((c2 >> 16) & 0xFFFFu);
    m.y_dir = 1 - 2 * (int)((c3 >> 3) & 1u);
    m.x_dir = 1 - 2 * (int)((c3 >> 4) & 1u);
    m.band = (int)((c3 >> 5) & 0x3FFu);
    m.xdrop = (int)((c3 >> 15) & 0xFFFu);
  }
  return m;
}

// 4-bit code at nibble position pos (floor division; the word index
// clamps to [0, lw), as the reference's gather does).
__host__ __device__ __forceinline__ int nib_at(const int32_t* words,
                                               int64_t lw, int64_t pos) {
  int64_t w = pos >= 0 ? pos / 8 : -((-pos + 7) / 8);
  const int sub = (int)(pos - 8 * w);
  w = w < 0 ? 0 : (w >= lw ? lw - 1 : w);
  return (int)(((uint32_t)words[w] >> (4 * sub)) & 0xFu);
}

// A problem is carried by a group of LANES lanes of a warp (8, 16 or 32:
// a warp carries 32 / LANES problems) with SLOTS band slots each in
// registers: band slot s lives on group lane s / SLOTS, register
// s % SLOTS.  A launch needs LANES * SLOTS >= min(2*band_max + 1,
// xmax + 1): slots past 2b are never computed, nor are slots past xlen <=
// xmax (a cell needs row <= xlen), and neither is read by a computed slot
// or by the walk, so no problem of the launch needs more.
struct Group {
  int lanes, slots;
};

__host__ __device__ inline int slots_needed(int band_max, int xmax) {
  return 2 * band_max + 1 < xmax + 1 ? 2 * band_max + 1 : xmax + 1;
}

// Band slots per lane at 32 lanes a problem, one warp each (the forward
// and run-length traceback kernels above 128 slots a launch): the fewest (a
// power of two <= 32) that cover the launch.  0 when none suffices.
__host__ __device__ inline int slots_for(int band_max, int xmax) {
  const int need = slots_needed(band_max, xmax);
  for (int s = 1; s <= 32; s *= 2)
    if (32 * s >= need) return s;
  return 0;
}

// The group shape of a stream-kernel launch: the first class of the table
// that covers the launch, four problems a warp while 32 slots do, two
// while 64 do, then one (at 65..128 slots 32 x 4 timed faster than 16 x 8,
// two a warp, on an H100).  {0, 0} when none suffices.
__host__ __device__ inline Group stream_group(int band_max, int xmax) {
  constexpr Group table[] = {{8, 4},  {16, 4},  {32, 4},
                             {32, 8}, {32, 16}, {32, 32}};
  const int need = slots_needed(band_max, xmax);
  for (const Group& g : table)
    if (g.lanes * g.slots >= need) return g;
  return Group{0, 0};
}

// The forward-scores and run-length traceback kernels choose the group
// shape per warp, not per launch.  Where 32 lanes x ROWS_SLOTS slots cover
// the launch (rows_launch), a warp owns ROWS_PER_WARP consecutive rows,
// takes the largest min(2*band + 1, xlen + 1) among them and runs the
// narrowest of 8, 16 and 32 lanes a problem that covers it: all four rows
// side by side, two passes of two, or four passes of one.  Neighbouring
// rows need about the same slots when the caller orders them by ylen, as
// the batch pipeline does, so a warp's shape fits all its rows.
constexpr int ROWS_PER_WARP = 4;
constexpr int ROWS_SLOTS = 4;

__host__ __device__ inline bool rows_launch(int band_max, int xmax) {
  return slots_needed(band_max, xmax) <= 32 * ROWS_SLOTS;
}

// Lanes a problem for a warp whose rows need at most `need` band slots.
__host__ __device__ inline int rows_lanes(int need) {
  return need <= 8 * ROWS_SLOTS ? 8 : (need <= 16 * ROWS_SLOTS ? 16 : 32);
}

// One row of the traceback kernel's dense form, (n, 4) int32 [xlen, ylen,
// band, x_drop]: its windows are rows of bytes, not anchored in a text.
__host__ __device__ __forceinline__ Meta unpack_params(const int32_t* r) {
  Meta m;
  m.y_anchor = m.x_anchor = 0;
  m.y_dir = m.x_dir = 1;
  m.xlen = r[0];
  m.ylen = r[1];
  m.band = r[2];
  m.xdrop = r[3];
  return m;
}

// Lanes a problem of the warp that owns rows [p0, p0 + ROWS_PER_WARP) of a
// launch of n rows (`rows` are meta rows of `cols` columns, or params rows
// of the dense form); rows past n need nothing.
__host__ __device__ inline int warp_lanes(const int32_t* rows, int cols,
                                          bool dense, int64_t p0, int64_t n) {
  int need = 1;
  for (int k = 0; k < ROWS_PER_WARP && p0 + k < n; ++k) {
    const Meta m = dense ? unpack_params(rows + 4 * (p0 + k))
                         : unpack_meta(rows + (p0 + k) * cols, cols);
    const int s = slots_needed(m.band, m.xlen);
    need = s > need ? s : need;
  }
  return rows_lanes(need);
}

// Bytes in which a lane stores the 2-bit directions of its SLOTS slots of
// one column: 1, 2, 4 or 8.
__host__ __device__ constexpr int dir_bytes(int slots) {
  return slots <= 4 ? 1 : (slots <= 8 ? 2 : (slots <= 16 ? 4 : 8));
}

// Bytes of the padded x window in shared memory: a zero before x[0] and
// one after x[xmax - 1], rounded to words.
__host__ __device__ constexpr int x_window_bytes(int xmax) {
  return 4 * ((xmax + 2 + 3) / 4);
}

// Shared memory of one problem in 32-bit words, a multiple of two (8-byte
// lane stores stay aligned): direction planes (lanes * dir_bytes(slots)
// bytes per column 0..ymax), the walk's output (pw words: the packed
// stream, or the traceback kernel's rmax runs), then the padded x codes
// and the y codes as bytes.  The forward kernel passes lanes 0 and pw 0:
// codes only.  A warp of the per-warp family holds ROWS_PER_WARP problems
// at 8 lanes, which covers its fewer problems at 16 and 32 lanes: the
// planes of a warp take the same bytes in all three shapes.
__host__ __device__ inline int problem_smem_words(int xmax, int ymax, int pw,
                                                  int lanes, int slots) {
  const int plane = ((ymax + 1) * lanes * dir_bytes(slots) + 3) / 4;
  const int w = plane + pw + x_window_bytes(xmax) / 4 + (ymax + 3) / 4;
  return (w + 1) & ~1;
}

// Shared memory of one warp of the traceback kernel's per-warp family.
__host__ __device__ inline int rows_warp_words(int xmax, int ymax, int pw) {
  return ROWS_PER_WARP * problem_smem_words(xmax, ymax, pw, 8, ROWS_SLOTS);
}

// Shared memory a block may opt into on sm_90 (227 KB).
constexpr int SMEM_OPTIN_BYTES = 232448;

// Warps per block for `words` of shared memory per warp: up to max_warps,
// never more than the opt-in shared memory holds; 0 when one warp's share
// does not fit.
__host__ __device__ inline int warps_per_block(int words, int max_warps) {
  const long long fit = SMEM_OPTIN_BYTES / (4LL * words);
  return (int)(fit < max_warps ? fit : max_warps);
}

// Direction planes of one problem: column j holds LANES cells of
// dir_bytes(SLOTS) bytes, one per group lane, each stored by its own lane
// (neighbouring lanes, neighbouring addresses); the direction of band slot
// s is in cell s / SLOTS at bits 2 * (s % SLOTS), little-endian.
template <int LANES, int SLOTS>
__host__ __device__ __forceinline__ int dir_at(const uint8_t* planes, int j,
                                               int slot) {
  constexpr int BPL = dir_bytes(SLOTS);
  const int k = slot % SLOTS;
  const uint8_t* cell = planes + ((int64_t)j * LANES + slot / SLOTS) * BPL;
  return (cell[k >> 2] >> (2 * (k & 3))) & 3;
}

// Code d of walk step c into the packed stream: word c/16, bits
// 2*(c%16), unsigned shifts (the reference's int32 packing wraps at
// c%16 >= 14 to the same bits).  Steps past the pw words are dropped.
__host__ __device__ __forceinline__ void put_code(uint32_t* words, int pw,
                                                  int c, int d) {
  if (c < 16 * pw) words[c >> 4] |= (uint32_t)d << (2 * (c & 15));
}

struct WalkEnd {
  int steps;
  bool bad;
};

// Traceback from the best cell (mi, mj).  A step reads the direction at
// slot clip(i - row0, 0, 2b) of column j (row0 = max(j - b, 0)), emits
// its code, and moves: M/S consume x and y, I consumes x, D consumes y.
// `words` (pw zeroed words) receives the codes.  A walk that has not
// reached the origin after smax + 1 steps is stopped and flagged bad.
template <int LANES, int SLOTS>
__host__ __device__ inline WalkEnd walk(const uint8_t* planes, int mi, int mj,
                                        int band, int smax, uint32_t* words,
                                        int pw) {
  int i = mi, j = mj, c = 0;
  while ((i > 0 || j > 0) && c <= smax) {
    const int row0 = j > band ? j - band : 0;
    int bi = i - row0;
    bi = bi < 0 ? 0 : (bi > 2 * band ? 2 * band : bi);
    const int d = dir_at<LANES, SLOTS>(planes, j, bi);
    put_code(words, pw, c, d);
    if (d <= DIR_SUBST || d == DIR_INS) --i;
    if (d <= DIR_SUBST || d == DIR_DEL) --j;
    ++c;
  }
  return WalkEnd{c, i > 0 || j > 0 || c > smax};
}

// Run-length encoding of one run: (op << 28) | length.
constexpr int RUN_OP_SHIFT = 28;

// The run-length traceback of kernel 4 (the reference's
// make_traceback_kernel, its walk_pair): the same steps as `walk`, from
// (mi, mj), at most `steps` of them (the kernel shape's XMAX + YMAX + 2).
// A run is emitted on each op change (M and S are different ops) and
// after the last step, into runs[nr] while nr < rmax; runs past rmax are
// counted, not written.  -> nruns, or -1 when more than rmax runs were
// needed or the walk did not reach the origin within `steps`.
template <int LANES, int SLOTS>
__host__ __device__ inline int walk_runs(const uint8_t* planes, int mi, int mj,
                                         int band, int steps, int rmax,
                                         int32_t* runs) {
  int i = mi, j = mj, cur_op = -1, cur_len = 0, nr = 0;
  for (int s = 0; s < steps && (i > 0 || j > 0); ++s) {
    const int row0 = j > band ? j - band : 0;
    int bi = i - row0;
    bi = bi < 0 ? 0 : (bi > 2 * band ? 2 * band : bi);
    const int d = dir_at<LANES, SLOTS>(planes, j, bi);
    if (d != cur_op && cur_len > 0) {
      if (nr < rmax) runs[nr] = (cur_op << RUN_OP_SHIFT) | cur_len;
      ++nr;
      cur_len = 0;
    }
    cur_op = d;
    ++cur_len;
    if (d <= DIR_SUBST || d == DIR_INS) --i;
    if (d <= DIR_SUBST || d == DIR_DEL) --j;
  }
  if (cur_len > 0) {
    if (nr < rmax) runs[nr] = (cur_op << RUN_OP_SHIFT) | cur_len;
    ++nr;
  }
  return (nr > rmax || i > 0 || j > 0) ? -1 : nr;
}

// nsteps field: the step count, -1 for a bad walk, -2-c when the
// band-exactness certificate failed.
__host__ __device__ __forceinline__ int nsteps_code(WalkEnd w, bool cert) {
  return w.bad ? -1 : (cert ? w.steps : -2 - w.steps);
}

// Header of one problem: int16 halves [score | max_i, max_j | nsteps].
__host__ __device__ __forceinline__ void pack_hdr(int ms, int mi, int mj,
                                                  int ns, int32_t* out) {
  out[0] = (int32_t)(((uint32_t)ms & 0xFFFFu) | ((uint32_t)mi << 16));
  out[1] = (int32_t)(((uint32_t)mj & 0xFFFFu) | ((uint32_t)ns << 16));
}

}  // namespace swg
