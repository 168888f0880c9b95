// B8: per-tile window-walk visibility raster for Hopper (sm_90a).
//
// Replaces sailor_tpu/raster/tile_raster.py `_raster_kernel_dma` (with
// `_test_chunk`, `_merge_chunk`), called from `rasterize_dma`. Its plain
// twin is `rasterize_dma_plain` in raster/tile_raster.py.
//
// What it computes: B1's test and merge (raster_common.cuh) over another
// walk. The TPU kernel walks each tile's exact window span of the sorted
// rows, windows w0 .. w0 + nw - 1 of `dchunk` rows (nw = 0 for an empty
// tile), through a double-buffered manual DMA; there is no per-tile cap.
// The big list seeds the tile first; every window is tested whole, in
// groups of 32 rows. Depth and tid equal the twin's bit for bit.
//
// Bound on the H100: as B1's (raster.cu), counted over the rows this walk
// reads. The TPU's manual copy pipeline becomes the block's staging of each
// group through shared memory; the next group's load is not overlapped.
#include "raster_common.cuh"

namespace {

using namespace sailor_raster;

__global__ void __launch_bounds__(THREADS)
raster_dma_kernel(const float* __restrict__ rows, int ncols,
                  const float* __restrict__ big_rows, int nbig_rows,
                  const int* __restrict__ n_big_ptr, const int* __restrict__ w0,
                  const int* __restrict__ nw, const float* __restrict__ zlo,
                  const float* __restrict__ zhi, float* __restrict__ depth,
                  int* __restrict__ tid, int tiles_x, int dchunk) {
  __shared__ float s[CHUNK * NCOL];
  Strip st;
  init_strip(st, tiles_x, zlo, zhi);
  test_big<CHUNK>(s, big_rows, ncols, nbig_rows, *n_big_ptr, st);
  test_windows<CHUNK>(s, rows, ncols, w0[st.tile], nw[st.tile], dchunk, st);
  write_strip(st, depth, tid);
}

}  // namespace

extern "C" int sailor_raster_dma(const float* rows, int ncols,
                                 const float* big_rows, int nbig_rows,
                                 const int* n_big, const int* w0, const int* nw,
                                 const float* zlo, const float* zhi, float* depth,
                                 int* tid, int tiles_y, int tiles_x, int dchunk,
                                 cudaStream_t stream) {
  const int blocks = tiles_y * tiles_x * STRIPS;
  raster_dma_kernel<<<blocks, THREADS, 0, stream>>>(
      rows, ncols, big_rows, nbig_rows, n_big, w0, nw, zlo, zhi, depth, tid,
      tiles_x, dchunk);
  return static_cast<int>(cudaGetLastError());
}
