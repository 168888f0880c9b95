// B1: work-list visibility raster for Hopper (sm_90a).
//
// Replaces sailor_tpu/raster/tile_raster.py `_raster_kernel_worklist` (with
// `_test_chunk` and `_merge_chunk`), called from `rasterize_worklist`. Its
// plain twin is `rasterize_worklist_plain` in raster/tile_raster.py.
//
// What it computes: per 64x128 screen tile, every candidate row of the tile
// (the big-triangle list, then the tile's windows of the sorted row table
// in order, each window's live 32-row groups b0..b1) is tested against
// each pixel centre: three edge functions >= -0.05 px, the AABB sliver
// clamp, reverse-Z plane depth z in (0, 1] and optional exclusive
// (zlo, zhi) bounds. Within a 32-row group the max z wins and equal z goes
// to the larger id; a later group takes a pixel only with strictly
// greater z. That is the TPU kernel's merge order and tie rule, kept
// exactly so the winner ids match on shared edges.
//
// Bound on the H100. The function must test each candidate row only at
// the pixels inside the row's screen AABB (every other pixel fails the AABB
// clamp): 16 float operations per such (pixel, candidate) pair, four planes
// of fma + mul + add; and it must read the rows' 17 raster columns once
// and write depth and tid (8 bytes a pixel). chip_smoke.py computes both
// from the frame's rows and reports the larger as the bound. This kernel
// is far from it: each block walks all of its tile's rows in order, with
// two barriers per 32-row group, and tests all 1024 pixels of its strip
// for every row whose AABB touches the strip.
// Design: one block per 8-row strip of a tile (8 strips per tile, 256
// threads, 4 pixels per thread). The block stages each 32-row group
// through shared memory once (every thread then reads the same row: a
// broadcast, no bank conflicts) and skips rows whose AABB misses the whole
// strip (exact: such a row rejects every pixel). The strip, staging, test
// and merge are shared with B7-B9 (raster_common.cuh). Rounding: common.cuh.
#include "raster_common.cuh"

namespace {

using namespace sailor_raster;

__global__ void __launch_bounds__(THREADS)
raster_worklist_kernel(const float* __restrict__ rows, int ncols,
                       const float* __restrict__ big_rows, int nbig_rows,
                       const int* __restrict__ n_big_ptr,
                       const int* __restrict__ starts,
                       const int* __restrict__ counts,
                       const float* __restrict__ zlo,
                       const float* __restrict__ zhi, float* __restrict__ depth,
                       int* __restrict__ tid, int tiles_x, int chunk) {
  __shared__ float s[CHUNK * NCOL];
  Strip st;
  init_strip(st, tiles_x, zlo, zhi);
  // big triangles first (the reference tests them at each tile's first window)
  test_big<CHUNK, false>(s, big_rows, ncols, nbig_rows, *n_big_ptr, st);
  // then the tile's windows in order, each window's live groups b0..b1
  const int start = starts[st.tile];
  const int end = start + counts[st.tile];
  const int c0 = start / chunk;
  const int c1 = max((end + chunk - 1) / chunk, c0 + 1);
  for (int wabs = c0; wabs < c1; ++wabs) {
    const int lo = min(max(start - wabs * chunk, 0), chunk);
    const int hi = min(max(end - wabs * chunk, 0), chunk);
    const int b1 = (hi + CHUNK - 1) / CHUNK;
    for (int b = lo / CHUNK; b < b1; ++b) {
      stage<CHUNK>(s, rows + (static_cast<int64_t>(wabs) * chunk + b * CHUNK) * ncols,
                   ncols, CHUNK);
      test_group<CHUNK, true, false>(s, st);
    }
  }
  write_strip(st, depth, tid);
}

}  // namespace

extern "C" int sailor_raster_worklist(const float* rows, int ncols,
                                      const float* big_rows, int nbig_rows,
                                      const int* n_big, const int* starts,
                                      const int* counts, const float* zlo,
                                      const float* zhi, float* depth, int* tid,
                                      int tiles_y, int tiles_x, int chunk,
                                      cudaStream_t stream) {
  const int blocks = tiles_y * tiles_x * STRIPS;
  raster_worklist_kernel<<<blocks, THREADS, 0, stream>>>(
      rows, ncols, big_rows, nbig_rows, n_big, starts, counts, zlo, zhi, depth,
      tid, tiles_x, chunk);
  return static_cast<int>(cudaGetLastError());
}
