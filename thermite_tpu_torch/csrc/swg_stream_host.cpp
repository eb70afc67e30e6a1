// Host build of the scalar pieces of swg_stream.cuh, with a plain C
// interface for tests/test_torch_kernel_host.py: g++ compiles the same
// meta unpacking, nibble gather, group shapes (a launch's and a warp's) and
// shared-memory sizing,
// direction-plane reads, traceback walks (packed codes and run-length
// runs), code packing and header packing that the CUDA kernels run, so
// they are held against the plain PyTorch versions without a GPU.
//
//   g++ -std=c++17 -O2 -shared -fPIC -o libswg_host.so swg_stream_host.cpp

#include "swg_stream.cuh"

extern "C" {

// rows (n, cols) -> out (n, 8) int64:
// [y_anchor, x_anchor, y_dir, x_dir, ylen, xlen, band, xdrop]
void thermite_swg_host_unpack_meta(const int32_t* rows, int cols, int64_t n,
                                   int64_t* out) {
  for (int64_t p = 0; p < n; ++p) {
    const swg::Meta m = swg::unpack_meta(rows + p * cols, cols);
    int64_t* o = out + 8 * p;
    o[0] = m.y_anchor;
    o[1] = m.x_anchor;
    o[2] = m.y_dir;
    o[3] = m.x_dir;
    o[4] = m.ylen;
    o[5] = m.xlen;
    o[6] = m.band;
    o[7] = m.xdrop;
  }
}

void thermite_swg_host_nib_at(const int32_t* words, int64_t lw,
                              const int64_t* pos, int64_t n, int32_t* out) {
  for (int64_t k = 0; k < n; ++k) out[k] = swg::nib_at(words, lw, pos[k]);
}

int thermite_swg_host_slots_for(int band_max, int xmax) {
  return swg::slots_for(band_max, xmax);
}

// -> lanes * 100 + slots of the stream kernels' group shape (0: none).
int thermite_swg_host_stream_group(int band_max, int xmax) {
  const swg::Group g = swg::stream_group(band_max, xmax);
  return g.lanes * 100 + g.slots;
}

// -> 1 when a launch of the forward or traceback kernel chooses its group
// shape per warp, else 0.
int thermite_swg_host_rows_launch(int band_max, int xmax) {
  return swg::rows_launch(band_max, xmax) ? 1 : 0;
}

// Lanes a problem of every warp of a per-warp launch: rows (n, cols) meta,
// or (n, 4) params of the dense form -> out (ceil(n / ROWS_PER_WARP),).
void thermite_swg_host_warp_lanes(const int32_t* rows, int cols, int dense,
                                  int64_t n, int32_t* out) {
  for (int64_t p0 = 0; p0 < n; p0 += swg::ROWS_PER_WARP)
    out[p0 / swg::ROWS_PER_WARP] =
        swg::warp_lanes(rows, cols, dense != 0, p0, n);
}

// -> shared-memory words of one warp of the traceback kernel's per-warp
// family.
int thermite_swg_host_rows_warp_words(int xmax, int ymax, int rmax) {
  return swg::rows_warp_words(xmax, ymax, rmax);
}

// -> shared-memory words of one problem; *warps gets the warps per block
// when a warp carries 32 / lanes problems (lanes 0: one, no planes).
int thermite_swg_host_smem(int xmax, int ymax, int pw, int lanes, int slots,
                           int max_warps, int* warps) {
  const int words = swg::problem_smem_words(xmax, ymax, pw, lanes, slots);
  *warps = swg::warps_per_block((lanes ? 32 / lanes : 1) * words, max_warps);
  return words;
}

}  // extern "C"

namespace {

// fn<LANES, SLOTS> for a group shape the kernels instantiate, else null.
#define SWG_GROUP_CASE(L, S) \
  case L * 100 + S: return &Fn::template call<L, S>;
template <class Fn>
typename Fn::type for_group(int lanes, int slots) {
  switch (lanes * 100 + slots) {
    SWG_GROUP_CASE(8, 4)
    SWG_GROUP_CASE(16, 4)
    SWG_GROUP_CASE(32, 4)
    SWG_GROUP_CASE(32, 8)
    SWG_GROUP_CASE(32, 16)
    SWG_GROUP_CASE(32, 32)
    default: return nullptr;
  }
}
#undef SWG_GROUP_CASE

struct DirAt {
  using type = int (*)(const uint8_t*, int, int);
  template <int L, int S>
  static int call(const uint8_t* planes, int j, int slot) {
    return swg::dir_at<L, S>(planes, j, slot);
  }
};

struct Walk {
  using type = swg::WalkEnd (*)(const uint8_t*, int, int, int, int, uint32_t*,
                                int);
  template <int L, int S>
  static swg::WalkEnd call(const uint8_t* planes, int mi, int mj, int band,
                           int smax, uint32_t* words, int pw) {
    return swg::walk<L, S>(planes, mi, mj, band, smax, words, pw);
  }
};

struct WalkRuns {
  using type = int (*)(const uint8_t*, int, int, int, int, int, int32_t*);
  template <int L, int S>
  static int call(const uint8_t* planes, int mi, int mj, int band, int steps,
                  int rmax, int32_t* runs) {
    return swg::walk_runs<L, S>(planes, mi, mj, band, steps, rmax, runs);
  }
};

int64_t plane_bytes(int ymax, int lanes, int slots) {
  return (int64_t)(ymax + 1) * lanes * swg::dir_bytes(slots);
}

}  // namespace

extern "C" {

// Every direction of n problems' planes: planes (n, ymax+1, lanes,
// dir_bytes(slots)) bytes in the kernel's shared-memory layout -> out
// (n, ymax+1, lanes*slots) codes.
int thermite_swg_host_dir_at(const uint8_t* planes, int lanes, int slots,
                             int ymax, int64_t n, uint8_t* out) {
  const DirAt::type fn = for_group<DirAt>(lanes, slots);
  if (!fn) return -1;
  const int L = lanes * slots;
  for (int64_t p = 0; p < n; ++p)
    for (int j = 0; j <= ymax; ++j)
      for (int s = 0; s < L; ++s)
        out[(p * (ymax + 1) + j) * L + s] =
            (uint8_t)fn(planes + p * plane_bytes(ymax, lanes, slots), j, s);
  return 0;
}

// Walk + header for n problems.  planes as for thermite_swg_host_dir_at;
// hdr (n, 2) and streams (n, smax/16) are written like the kernel writes
// them.
int thermite_swg_host_walk(const uint8_t* planes, int lanes, int slots,
                           int ymax, const int32_t* ms, const int32_t* mi,
                           const int32_t* mj, const int32_t* band,
                           const uint8_t* cert, int64_t n, int smax,
                           int32_t* hdr, int32_t* streams) {
  const Walk::type fn = for_group<Walk>(lanes, slots);
  if (!fn) return -1;
  const int pw = smax / 16;
  const int64_t per = plane_bytes(ymax, lanes, slots);
  for (int64_t p = 0; p < n; ++p) {
    uint32_t* words = reinterpret_cast<uint32_t*>(streams + p * pw);
    for (int w = 0; w < pw; ++w) words[w] = 0;
    const swg::WalkEnd we =
        fn(planes + p * per, mi[p], mj[p], band[p], smax, words, pw);
    swg::pack_hdr(ms[p], mi[p], mj[p], swg::nsteps_code(we, cert[p] != 0),
                  hdr + 2 * p);
  }
  return 0;
}

// Run walk for n problems (planes as for thermite_swg_host_dir_at): runs
// (n, rmax) receive each walk's first rmax runs (nothing else is
// written), nruns (n,) the walk's count or -1.
int thermite_swg_host_walk_runs(const uint8_t* planes, int lanes, int slots,
                                int ymax, const int32_t* mi,
                                const int32_t* mj, const int32_t* band,
                                int64_t n, int steps, int rmax, int32_t* runs,
                                int32_t* nruns) {
  const WalkRuns::type fn = for_group<WalkRuns>(lanes, slots);
  if (!fn) return -1;
  const int64_t per = plane_bytes(ymax, lanes, slots);
  for (int64_t p = 0; p < n; ++p)
    nruns[p] = fn(planes + p * per, mi[p], mj[p], band[p], steps, rmax,
                  runs + p * rmax);
  return 0;
}

}  // extern "C"
