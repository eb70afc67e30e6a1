// Host build of the scalar pieces of swg_stream.cuh, with a plain C
// interface for tests/test_torch_kernel_host.py: g++ compiles the same
// meta unpacking, nibble gather, slot classes and shared-memory sizing,
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

// -> per-warp shared-memory words; *warps gets the warps per block.
int thermite_swg_host_smem(int xmax, int ymax, int pw, int slots,
                           int max_warps, int* warps) {
  const int words = swg::warp_smem_words(xmax, ymax, pw, slots);
  *warps = swg::warps_per_block(words, max_warps);
  return words;
}

// Walk + header for n problems.  planes: (n, ymax+1, 2*slots) uint32 in
// the kernel's shared-memory layout; hdr (n, 2) and streams (n, smax/16)
// are written like the kernel writes them.
int thermite_swg_host_walk(const uint32_t* planes, int slots, int ymax,
                           const int32_t* ms, const int32_t* mi,
                           const int32_t* mj, const int32_t* band,
                           const uint8_t* cert, int64_t n, int smax,
                           int32_t* hdr, int32_t* streams) {
  using Walk = swg::WalkEnd (*)(const uint32_t*, int, int, int, int,
                                uint32_t*, int);
  Walk fn;
  switch (slots) {
    case 1: fn = swg::walk<1>; break;
    case 2: fn = swg::walk<2>; break;
    case 4: fn = swg::walk<4>; break;
    case 8: fn = swg::walk<8>; break;
    case 16: fn = swg::walk<16>; break;
    case 32: fn = swg::walk<32>; break;
    default: return -1;
  }
  const int pw = smax / 16;
  const int64_t per = (int64_t)(ymax + 1) * 2 * slots;
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

// Run walk for n problems (planes as for thermite_swg_host_walk): runs
// (n, rmax) receive each walk's first rmax runs (nothing else is
// written), nruns (n,) the walk's count or -1.
int thermite_swg_host_walk_runs(const uint32_t* planes, int slots, int ymax,
                                const int32_t* mi, const int32_t* mj,
                                const int32_t* band, int64_t n, int steps,
                                int rmax, int32_t* runs, int32_t* nruns) {
  using Walk = int (*)(const uint32_t*, int, int, int, int, int, int32_t*);
  Walk fn;
  switch (slots) {
    case 1: fn = swg::walk_runs<1>; break;
    case 2: fn = swg::walk_runs<2>; break;
    case 4: fn = swg::walk_runs<4>; break;
    case 8: fn = swg::walk_runs<8>; break;
    case 16: fn = swg::walk_runs<16>; break;
    case 32: fn = swg::walk_runs<32>; break;
    default: return -1;
  }
  const int64_t per = (int64_t)(ymax + 1) * 2 * slots;
  for (int64_t p = 0; p < n; ++p)
    nruns[p] = fn(planes + p * per, mi[p], mj[p], band[p], steps, rmax,
                  runs + p * rmax);
  return 0;
}

}  // extern "C"
