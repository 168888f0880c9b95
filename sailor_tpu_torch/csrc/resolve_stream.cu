// B10: fused visibility resolve on the grid-k windows, for Hopper (sm_90a).
//
// Replaces sailor_tpu/raster/tile_raster.py `_resolve_kernel` (with
// `_resolve_accumulate` and `_resolve_emit`), called from `resolve_stream`.
// Its plain twin is `resolve_stream_plain` in raster/tile_raster.py.
//
// What it computes: B2's function (resolve.cu) in full mode, over the
// rows B7 walks. The TPU grid is (ty, tx, k < kmax); step k accumulates
// the rows of window c0 + k (k < max(spt, 1)) that lie in the tile's own
// [start, end) segment and match the pixel's tid, after the big list; the
// last step emits. So the rows it can select are the segment rows before
// (c0 + max(spt, 1)) * chunk and the big list: a winner past the kmax cap
// gives all-zero planes, as the reference's empty sum does.
//
// Bound on the H100: bytes, as B2's. Design: B2's, one thread per pixel,
// with the binary search of the segment cut at the cap (resolve_common.cuh).
#include "resolve_common.cuh"

namespace {

using namespace sailor_resolve;

__global__ void __launch_bounds__(THREADS)
resolve_stream_kernel(const float* __restrict__ rows, int ncols,
                      const float* __restrict__ big_rows, int nbig_rows,
                      const int* __restrict__ tid, const int* __restrict__ starts,
                      const int* __restrict__ counts, const int* __restrict__ c0,
                      const int* __restrict__ spt, const float* __restrict__ par,
                      float* __restrict__ out, int n_out, int tiles_x, int tile_h,
                      int chunk, int H, int W) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t HW = static_cast<int64_t>(H) * W;
  if (p >= HW) return;
  const int y = static_cast<int>(p / W), x = static_cast<int>(p - static_cast<int64_t>(y) * W);
  const int t = tid[p];
  const float* row = nullptr;
  if (t >= 0) {
    const int tile = (y / tile_h) * tiles_x + x / TILE_W;
    const int s = starts[tile];
    const int64_t cap = (static_cast<int64_t>(c0[tile]) + max(spt[tile], 1)) * chunk;
    const int e = static_cast<int>(min(static_cast<int64_t>(s) + counts[tile], cap));
    row = find_row(rows, ncols, s, max(e, s), big_rows, nbig_rows, static_cast<float>(t));
  }
  if (row == nullptr) {
    for (int c = 0; c < n_out; ++c) out[c * HW + p] = 0.0f;
    return;
  }
  emit(row + 17, par, x, y, out, p, HW, n_out, 0);
}

}  // namespace

extern "C" int sailor_resolve_stream(const float* rows, int ncols,
                                     const float* big_rows, int nbig_rows,
                                     const int* tid, const int* starts,
                                     const int* counts, const int* c0,
                                     const int* spt, const float* par, float* out,
                                     int n_out, int tiles_y, int tiles_x, int tile_h,
                                     int chunk, cudaStream_t stream) {
  if (tile_h < 8 || tile_h % 8) return static_cast<int>(cudaErrorInvalidValue);
  const int H = tiles_y * tile_h, W = tiles_x * TILE_W;
  const int64_t n = static_cast<int64_t>(H) * W;
  const int blocks = static_cast<int>((n + THREADS - 1) / THREADS);
  resolve_stream_kernel<<<blocks, THREADS, 0, stream>>>(
      rows, ncols, big_rows, nbig_rows, tid, starts, counts, c0, spt, par, out,
      n_out, tiles_x, tile_h, chunk, H, W);
  return static_cast<int>(cudaGetLastError());
}
