// B2: fused visibility resolve for Hopper (sm_90a).
//
// Replaces sailor_tpu/raster/tile_raster.py `_resolve_kernel_worklist` (with
// `_resolve_accumulate` and `_resolve_emit`), called from
// `resolve_worklist`. Its plain twin is `resolve_worklist_plain` in
// raster/tile_raster.py.
//
// What it computes: for each pixel, the attribute row of its winning
// triangle, then the pixel ray unprojected with inv_vp, clamped
// Moller-Trumbore u, v against the source triangle, and the interpolated
// planes: mode "full" writes 13 planes (37 attribute columns) or 29 (49),
// mode "alpha" the 5 planes of the masked peel.
//
// The TPU sums a one-hot matrix product over the tile's rows because it
// cannot gather; here each thread finds its row directly. The rows a
// one-hot selects are those of the tile's own [start, end) segment whose id
// equals the pixel's tid, plus any such row of the big list. Inside a
// segment the ids ascend and are unique (bin_sorted sorts tile * T + id
// keys), so a binary search finds it; the big list (<= 64 rows) is
// scanned. No match (tid < 0) gives all-zero planes, as the empty sum does.
//
// Bound on the H100: bytes. Per pixel it reads the tid and one ~216-byte
// row and writes 13 floats (52 bytes); the arithmetic is ~100 operations.
// Design: one thread per pixel, rows read through the L1/L2 caches
// (neighbouring pixels share winners), planes written coalesced.
// Rounding: common.cuh.
#include "resolve_common.cuh"

namespace {

using namespace sailor_resolve;

__global__ void __launch_bounds__(THREADS)
resolve_worklist_kernel(const float* __restrict__ rows, int ncols,
                        const float* __restrict__ big_rows, int nbig_rows,
                        const int* __restrict__ tid,
                        const int* __restrict__ starts,
                        const int* __restrict__ counts,
                        const float* __restrict__ par, float* __restrict__ out,
                        int n_out, int mode, int tiles_x, int tile_h, int H, int W) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t HW = static_cast<int64_t>(H) * W;
  if (p >= HW) return;
  const int y = static_cast<int>(p / W), x = static_cast<int>(p - static_cast<int64_t>(y) * W);
  const int t = tid[p];
  const float* row = nullptr;
  if (t >= 0) {
    const int tile = (y / tile_h) * tiles_x + x / TILE_W;
    const int s = starts[tile];
    row = find_row(rows, ncols, s, s + counts[tile], big_rows, nbig_rows,
                   static_cast<float>(t));
  }
  if (row == nullptr) {
    for (int c = 0; c < n_out; ++c) out[c * HW + p] = 0.0f;
    return;
  }
  emit(row + 17, par, x, y, out, p, HW, n_out, mode);
}

}  // namespace

extern "C" int sailor_resolve_worklist(const float* rows, int ncols,
                                       const float* big_rows, int nbig_rows,
                                       const int* tid, const int* starts,
                                       const int* counts, const float* par,
                                       float* out, int n_out, int mode,
                                       int tiles_y, int tiles_x, int tile_h,
                                       cudaStream_t stream) {
  if (tile_h < 8 || tile_h % 8) return static_cast<int>(cudaErrorInvalidValue);
  const int H = tiles_y * tile_h, W = tiles_x * TILE_W;
  const int64_t n = static_cast<int64_t>(H) * W;
  const int blocks = static_cast<int>((n + THREADS - 1) / THREADS);
  resolve_worklist_kernel<<<blocks, THREADS, 0, stream>>>(
      rows, ncols, big_rows, nbig_rows, tid, starts, counts, par, out, n_out,
      mode, tiles_x, tile_h, H, W);
  return static_cast<int>(cudaGetLastError());
}
