// Banded SWG extension + traceback op stream at any band, as sub-warp
// groups, for Hopper (sm_90a).
//
// Replaces both of the reference's stream kernels, which give the same
// rows: make_packed_stream_call (swg_pallas_packed.py, behind
// make_packed_stream_gather_kernel(split=True)) for bands up to 31, and
// make_stream_traceback_kernel (swg_pallas.py, behind
// make_stream_traceback_gather_call) for any band, where the reference
// rounds the band to W = roundup(2b+1, 128) lanes per problem.  Per
// problem it gathers the x window from the nibble-packed read block and
// the y window from the nibble-packed text, runs banded affine-gap SWG
// with X-drop, keeps the best score and the first cell reaching it,
// computes the band-exactness certificate, and walks the traceback into
// 2-bit codes (backward order, 16 per int32).  Outputs are written in meta
// row order: hdr (N, 2) int16 halves, streams (N, SMAX/16); the wrapper
// assembles the reference's fused (N, 4 + SMAX/16) rows from the two.
// Both are one template (stream_kernel<LANES, SLOTS> in swg_dp.cuh) and
// one launch; the wrappers swg_stream and swg_stream_wide count the
// launches of each band class.
//
// What bounds it on this card: operations, not bytes.  A problem reads
// ~0.1 KB of text and reads and writes 60 B; the DP is a serial chain of
// columns (up to YMAX), each a dependent sequence of integer operations
// (about 15 a cell, LANES * SLOTS cells a column) and a few warp shuffles
// and reductions, of which an SM issues far fewer a clock.  The walk is a
// serial chain of shared-memory reads.  At wide bands shared memory also
// counts: the direction planes take LANES * dir_bytes(SLOTS) bytes a
// column (at 32 x 32 slots and YMAX 512 about 131 KB a problem), which
// caps the warps per block and per SM.
//
// What the design does about it (swg_dp.cuh): a launch takes the first
// group shape of stream_group() that covers min(2*band_max + 1, XMAX + 1)
// slots, since slots past row xlen are never computed.  A problem at band
// <= 15 has at most 31 slots, so it takes 8 lanes with 4 slots each in
// registers and a warp carries four problems; bands 16..31 (63 slots)
// take 16 lanes, two problems a warp; band 60 at XMAX 96 (97 slots) takes
// 32 lanes x 4 slots, one problem a warp (16 x 8, two a warp, timed
// slower on an H100).  The shuffles of a column (two neighbour shuffles, a
// 1 + log2(LANES)-step prefix-max scan, two redux) are issued once for all
// problems of the warp.  Each lane packs the directions of its own slots
// and stores them to shared memory itself (1, 2, 4 or 8 bytes a column;
// 8 bytes a problem-column at band <= 15, ~1 KB a problem at YMAX 128);
// no ballots.  Each group gathers its x and y codes into shared memory
// once, so the DP loop reads no global memory.  The first lane of every
// group walks its own problem, so up to four walks run at once, and packs
// codes with uint32 shifts.  Problems of one warp end at different
// columns; the batch pipeline submits rows ordered by column count, so
// neighbours end close together.  Warps per block follow from the shared
// memory of a warp's problems so that every shape the reference accepts
// (XMAX, YMAX <= 512) fits the opt-in limit.  Registers grow with the
// slots a lane (80 at 32 x 8, 128 at 32 x 16, 254 at 32 x 32 with sm_90a;
// no shape spills, see the build log).  The pipeline reaches 32 x 8 at
// full band and -s0 once reads pass 96 bp (a 150 bp read has band 120 and
// 161 slots at XMAX 160); 32 x 16 needs reads above 224 bp (XMAX 256),
// 32 x 32 above 480 bp.

#include "swg_dp.cuh"

// Launch on `stream` for problems with band <= band_max and xlen <= xmax;
// returns the cudaError_t of the launch (0 = ok), or -1 for a shape the
// kernel does not take (nothing is launched then).
extern "C" int thermite_swg_stream_launch(
    const int32_t* ref, int64_t ref_lw, const int32_t* reads,
    int64_t reads_lw, const int32_t* meta, int meta_cols, int64_t n,
    int xmax, int ymax, int smax, int band_max, int32_t* hdr,
    int32_t* streams, void* stream) {
  if (n <= 0) return 0;
  const swg::Args a{ref, ref_lw, reads, reads_lw, meta, meta_cols, n,
                    xmax, ymax, smax, hdr, streams};
  const cudaStream_t s = (cudaStream_t)stream;
  const swg::Group g = swg::stream_group(band_max, xmax);
  switch (g.lanes * 100 + g.slots) {
    case 804: return swg::launch_stream<8, 4>(a, s);
    case 1604: return swg::launch_stream<16, 4>(a, s);
    case 3204: return swg::launch_stream<32, 4>(a, s);
    case 3208: return swg::launch_stream<32, 8>(a, s);
    case 3216: return swg::launch_stream<32, 16>(a, s);
    case 3232: return swg::launch_stream<32, 32>(a, s);
    default: return swg::ERR_ARGS;
  }
}
