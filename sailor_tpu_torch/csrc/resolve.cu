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
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int TILE_H = 64;
constexpr int TILE_W = 128;
constexpr int THREADS = 256;

__device__ __forceinline__ float fma_(float a, float b, float c) { return __fmaf_rn(a, b, c); }
// x0*y0 - x1*y1
__device__ __forceinline__ float det2(float x0, float y0, float x1, float y1) {
  return __fmaf_rn(x0, y0, -__fmul_rn(x1, y1));
}
// x0*y0 + x1*y1 + x2*y2
__device__ __forceinline__ float dot3(float x0, float y0, float x1, float y1, float x2, float y2) {
  return __fmaf_rn(x2, y2, __fmaf_rn(x0, y0, __fmul_rn(x1, y1)));
}

__device__ const float* find_row(const float* rows, int ncols, int s, int e,
                                 const float* big_rows, int nbig_rows, float ft) {
  int lo = s, hi = e;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (rows[static_cast<int64_t>(mid) * ncols + 16] < ft) lo = mid + 1;
    else hi = mid;
  }
  if (lo < e && rows[static_cast<int64_t>(lo) * ncols + 16] == ft)
    return rows + static_cast<int64_t>(lo) * ncols;
  for (int i = 0; i < nbig_rows; ++i)
    if (big_rows[static_cast<int64_t>(i) * ncols + 16] == ft)
      return big_rows + static_cast<int64_t>(i) * ncols;
  return nullptr;
}

__global__ void __launch_bounds__(THREADS)
resolve_worklist_kernel(const float* __restrict__ rows, int ncols,
                        const float* __restrict__ big_rows, int nbig_rows,
                        const int* __restrict__ tid,
                        const int* __restrict__ starts,
                        const int* __restrict__ counts,
                        const float* __restrict__ par, float* __restrict__ out,
                        int n_out, int mode, int tiles_x, int H, int W) {
  const int64_t p = static_cast<int64_t>(blockIdx.x) * THREADS + threadIdx.x;
  const int64_t HW = static_cast<int64_t>(H) * W;
  if (p >= HW) return;
  const int y = static_cast<int>(p / W), x = static_cast<int>(p - static_cast<int64_t>(y) * W);
  const int t = tid[p];
  const float* row = nullptr;
  if (t >= 0) {
    const int tile = (y / TILE_H) * tiles_x + x / TILE_W;
    const int s = starts[tile];
    row = find_row(rows, ncols, s, s + counts[tile], big_rows, nbig_rows,
                   static_cast<float>(t));
  }
  if (row == nullptr) {
    for (int c = 0; c < n_out; ++c) out[c * HW + p] = 0.0f;
    return;
  }
  const float* a = row + 17;  // attribute columns

  const float px = static_cast<float>(x) + 0.5f;
  const float py = static_cast<float>(y) + 0.5f;
  const float ndc_x = __fsub_rn(__fmul_rn(__fmul_rn(px, par[19]), 2.0f), 1.0f);
  const float ndc_y = __fsub_rn(1.0f, __fmul_rn(__fmul_rn(__fadd_rn(py, par[21]), par[20]), 2.0f));
  float m[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    m[r] = __fadd_rn(fma_(par[4 * r], ndc_x, __fmul_rn(par[4 * r + 1], ndc_y)),
                     __fadd_rn(__fmul_rn(par[4 * r + 2], 0.5f), par[4 * r + 3]));
  const float inv_w = __fdiv_rn(1.0f, m[3]);
  const float cx = par[16], cy = par[17], cz = par[18];
  const float dx = fma_(m[0], inv_w, -cx);
  const float dy = fma_(m[1], inv_w, -cy);
  const float dz = fma_(m[2], inv_w, -cz);
  const float v0x = a[0], v0y = a[1], v0z = a[2];
  const float e1x = a[3], e1y = a[4], e1z = a[5];
  const float e2x = a[6], e2y = a[7], e2z = a[8];

  const float pvx = det2(dy, e2z, dz, e2y);
  const float pvy = det2(dz, e2x, dx, e2z);
  const float pvz = det2(dx, e2y, dy, e2x);
  const float det = dot3(e1x, pvx, e1y, pvy, e1z, pvz);
  const float inv_det = fabsf(det) > 1e-12f ? __fdiv_rn(1.0f, det) : 0.0f;
  const float tvx = __fsub_rn(cx, v0x), tvy = __fsub_rn(cy, v0y), tvz = __fsub_rn(cz, v0z);
  float u = __fmul_rn(dot3(tvx, pvx, tvy, pvy, tvz, pvz), inv_det);
  const float qvx = det2(tvy, e1z, tvz, e1y);
  const float qvy = det2(tvz, e1x, tvx, e1z);
  const float qvz = det2(tvx, e1y, tvy, e1x);
  float v = __fmul_rn(dot3(dx, qvx, dy, qvy, dz, qvz), inv_det);
  u = sailor::clamp2(u, 0.0f, 1.0f);
  v = sailor::min_nan(sailor::clamp_lo(v, 0.0f), __fsub_rn(1.0f, u));

  auto lerp3 = [&](float r0, float r1, float r2) { return fma_(r2, v, fma_(r1, u, r0)); };
  auto row3 = [&](int b0, int b1, int b2) { return lerp3(a[b0], a[b1], a[b2]); };
  int o = 0;
  auto put = [&](float val) { out[(o++) * HW + p] = val; };

  if (mode == 1) {  // alpha: uv, vertex-colour alpha, material id, cutoff
    put(row3(18, 20, 22));
    put(row3(19, 21, 23));
    put(row3(27, 31, 35));
    put(a[36]);
    put(a[48]);
    return;
  }
  put(lerp3(v0x, e1x, e2x));
  put(lerp3(v0y, e1y, e2y));
  put(lerp3(v0z, e1z, e2z));
  for (int c = 0; c < 3; ++c) put(row3(9 + c, 12 + c, 15 + c));   // normal
  for (int c = 0; c < 2; ++c) put(row3(18 + c, 20 + c, 22 + c));  // uv
  for (int c = 0; c < 4; ++c) put(row3(24 + c, 28 + c, 32 + c));  // vertex colour
  put(a[36]);                                                       // material id
  if (n_out == 29) {
    for (int c = 0; c < 3; ++c) put(a[37 + c]);  // albedo
    put(a[40]);                                  // metallic
    put(a[41]);                                  // roughness
    for (int c = 0; c < 3; ++c) put(a[42 + c]);  // emissive
    put(a[45]);                                  // albedo layer
    put(a[46]);                                  // normal layer
    const float duv1y = a[21], duv2y = a[23];
    put(det2(e1x, duv2y, e2x, duv1y));           // tangent seed
    put(det2(e1y, duv2y, e2y, duv1y));
    put(det2(e1z, duv2y, e2z, duv1y));
    put(det2(a[20], a[23], a[22], a[21]));       // uv determinant
    put(a[48]);                                  // alpha cutoff
    put(a[47]);                                  // opacity
  }
}

}  // namespace

extern "C" int sailor_resolve_worklist(const float* rows, int ncols,
                                       const float* big_rows, int nbig_rows,
                                       const int* tid, const int* starts,
                                       const int* counts, const float* par,
                                       float* out, int n_out, int mode,
                                       int tiles_y, int tiles_x,
                                       cudaStream_t stream) {
  const int H = tiles_y * TILE_H, W = tiles_x * TILE_W;
  const int64_t n = static_cast<int64_t>(H) * W;
  const int blocks = static_cast<int>((n + THREADS - 1) / THREADS);
  resolve_worklist_kernel<<<blocks, THREADS, 0, stream>>>(
      rows, ncols, big_rows, nbig_rows, tid, starts, counts, par, out, n_out,
      mode, tiles_x, H, W);
  return static_cast<int>(cudaGetLastError());
}
