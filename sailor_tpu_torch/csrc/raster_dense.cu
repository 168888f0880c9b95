// B9: dense-bin visibility raster for Hopper (sm_90a).
//
// Replaces sailor_tpu/raster/tile_raster.py `_raster_kernel`, called from
// `rasterize_tiles` (one pass of bin_all's fixed-capacity slot tables).
// Its plain twin is `rasterize_tiles_plain` in raster/tile_raster.py.
//
// What it computes: per tile, slots 0 .. ceil(count / 32) * 32 of the
// tile's bin, in groups of 32 from slot 0 (the per-tile early exit on the
// live count), tested and merged as in B1 (raster_common.cuh). The rows
// carry 12 columns (edges, depth plane) or 16 (and the screen AABB); only
// with 16 does the AABB sliver clamp apply, as in the reference, which
// clamps only when its caller passes the AABB. The ids come from their
// own array (-1 for an empty slot). The reference evaluates the planes
// inline, in the same rounding as B1's. Depth and tid equal the twin's
// bit for bit.
//
// Bound on the H100: as B1's, over the live slots walked; without the
// clamp each candidate must be tested at all 8192 pixels of its tile.
#include "raster_common.cuh"

namespace {

using namespace sailor_raster;

// Stage one 32-slot group of the bin: the row's `width` columns, the id.
__device__ __forceinline__ void stage_slots(float* s, const float* rows, int width,
                                            const int* ids) {
  __syncthreads();
  for (int i = threadIdx.x; i < CHUNK * NCOL; i += THREADS) {
    const int r = i / NCOL, c = i - r * NCOL;
    s[i] = c == 16 ? static_cast<float>(ids[r])
                   : (c < width ? rows[static_cast<int64_t>(r) * width + c] : 0.0f);
  }
  __syncthreads();
}

template <bool CLAMP>
__global__ void __launch_bounds__(THREADS)
raster_dense_kernel(const float* __restrict__ rows, int width,
                    const int* __restrict__ ids, const int* __restrict__ counts,
                    int cap, const float* __restrict__ zlo,
                    const float* __restrict__ zhi, float* __restrict__ depth,
                    int* __restrict__ tid, int tiles_x) {
  __shared__ float s[CHUNK * NCOL];
  Strip st;
  init_strip(st, tiles_x, zlo, zhi);
  const int ng = (counts[st.tile] + CHUNK - 1) / CHUNK;
  const int64_t base = static_cast<int64_t>(st.tile) * cap;
  for (int g = 0; g < ng; ++g) {
    const int64_t slot = base + g * CHUNK;
    stage_slots(s, rows + slot * width, width, ids + slot);
    test_group<CHUNK, CLAMP>(s, st);
  }
  write_strip(st, depth, tid);
}

}  // namespace

extern "C" int sailor_raster_dense(const float* rows, int width, const int* ids,
                                   const int* counts, int cap, const float* zlo,
                                   const float* zhi, float* depth, int* tid,
                                   int tiles_y, int tiles_x, cudaStream_t stream) {
  const int blocks = tiles_y * tiles_x * STRIPS;
  if (width == 16)
    raster_dense_kernel<true><<<blocks, THREADS, 0, stream>>>(
        rows, width, ids, counts, cap, zlo, zhi, depth, tid, tiles_x);
  else
    raster_dense_kernel<false><<<blocks, THREADS, 0, stream>>>(
        rows, width, ids, counts, cap, zlo, zhi, depth, tid, tiles_x);
  return static_cast<int>(cudaGetLastError());
}
