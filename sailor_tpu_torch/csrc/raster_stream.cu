// B7: grid-k streaming visibility raster for Hopper (sm_90a), in its VPU
// and MXU forms.
//
// Replaces sailor_tpu/raster/tile_raster.py `_raster_kernel_stream` (with
// `_test_chunk`, `_merge_chunk`) and `_raster_kernel_stream_mxu` (with
// `_test_chunk_mxu`, `_merge_chunk_mxu`), called from `rasterize_stream`.
// Its plain twin is `rasterize_stream_plain` in raster/tile_raster.py.
//
// What it computes: B1's test and merge (raster_common.cuh) over another
// walk. The TPU grid is (ty, tx, k < kmax): step k of a tile tests the
// whole k-th `chunk`-aligned window of its segment of the sorted rows,
// c0 + k for k < max(spt, 1), where spt is capped at kmax. Rows past the
// cap are never tested (the caller counts them as overflow), and the
// windows' rows of neighbouring tiles are tested too (the AABB clamp
// rejects them). The big list seeds the tile first. The VPU form merges
// groups of 32 rows; the MXU form, built for the TPU's matrix unit,
// merges groups of 128 and evaluates each plane re-centred on the tile
// origin (c_t = c + a*ox + b*oy, then [dx, dy, 1] . [a, b, c_t]), which
// rounds differently from the VPU form on a few pixels; one template flag
// selects it. Depth and tid equal the twin's bit for bit.
//
// Bound on the H100: as B1's (raster.cu), counted over the rows this walk
// reads. This kernel walks the windows serially per strip, as B1 does; the
// TPU's k grid becomes the loop over k.
#include "raster_common.cuh"

namespace {

using namespace sailor_raster;

template <bool MXU>
__global__ void __launch_bounds__(THREADS)
raster_stream_kernel(const float* __restrict__ rows, int ncols,
                     const float* __restrict__ big_rows, int nbig_rows,
                     const int* __restrict__ n_big_ptr, const int* __restrict__ c0,
                     const int* __restrict__ spt, const float* __restrict__ zlo,
                     const float* __restrict__ zhi, float* __restrict__ depth,
                     int* __restrict__ tid, int tiles_x, int chunk) {
  constexpr int G = MXU ? CHUNK_MXU : CHUNK;
  __shared__ float s[G * NCOL];
  Strip st;
  init_strip(st, tiles_x, zlo, zhi);
  test_big<G, MXU>(s, big_rows, ncols, nbig_rows, *n_big_ptr, st);
  test_windows<G, MXU>(s, rows, ncols, c0[st.tile], max(spt[st.tile], 1), chunk, st);
  write_strip(st, depth, tid);
}

}  // namespace

extern "C" int sailor_raster_stream(const float* rows, int ncols,
                                    const float* big_rows, int nbig_rows,
                                    const int* n_big, const int* c0,
                                    const int* spt, const float* zlo,
                                    const float* zhi, float* depth, int* tid,
                                    int tiles_y, int tiles_x, int chunk, int mxu,
                                    cudaStream_t stream) {
  const int blocks = tiles_y * tiles_x * STRIPS;
  if (mxu)
    raster_stream_kernel<true><<<blocks, THREADS, 0, stream>>>(
        rows, ncols, big_rows, nbig_rows, n_big, c0, spt, zlo, zhi, depth, tid,
        tiles_x, chunk);
  else
    raster_stream_kernel<false><<<blocks, THREADS, 0, stream>>>(
        rows, ncols, big_rows, nbig_rows, n_big, c0, spt, zlo, zhi, depth, tid,
        tiles_x, chunk);
  return static_cast<int>(cudaGetLastError());
}
