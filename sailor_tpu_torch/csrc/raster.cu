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
// strip (exact: such a row rejects every pixel). Rounding: common.cuh.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int TILE_H = 64;
constexpr int TILE_W = 128;
constexpr int CHUNK = 32;
constexpr int NCOL = 17;          // edge 9, zplane 3, aabb 4, id
constexpr int STRIP_H = 8;        // pixel rows per block
constexpr int THREADS = 256;
constexpr int PX = STRIP_H * TILE_W / THREADS;  // pixels per thread (4)
constexpr int ROW_STEP = THREADS / TILE_W;      // 2
constexpr float EPS = -0.05f;

__device__ __forceinline__ float plane(float a, float b, float c, float px, float py) {
  return __fadd_rn(__fmaf_rn(a, px, __fmul_rn(b, py)), c);
}

struct Strip {
  float px;            // this thread's pixel-centre x
  float py[PX];        // and its PX pixel-centre rows
  float x_lo, x_hi, y_lo, y_hi;  // the strip's outermost pixel centres
  float zlo[PX], zhi[PX];
  bool bounded;
  float bz[PX];
  int bid[PX];
};

// Test one staged 32-row group and merge it into the running winners.
__device__ __forceinline__ void test_group(const float* s, Strip& st) {
  float gz[PX];
  int gid[PX];
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    gz[k] = -1.0f;
    gid[k] = -1;
  }
  for (int r = 0; r < CHUNK; ++r) {
    const float* q = s + r * NCOL;
    const int id = static_cast<int>(q[16]);
    if (id < 0) continue;  // dead row: its -1 never changes a live max
    // whole-strip AABB reject (the same comparisons as per pixel)
    if (st.x_hi < q[12] + EPS || st.x_lo > q[13] - EPS ||
        st.y_hi < q[14] + EPS || st.y_lo > q[15] - EPS)
      continue;
#pragma unroll
    for (int k = 0; k < PX; ++k) {
      const float px = st.px, py = st.py[k];
      bool ok = plane(q[0], q[1], q[2], px, py) >= EPS &&
                plane(q[3], q[4], q[5], px, py) >= EPS &&
                plane(q[6], q[7], q[8], px, py) >= EPS;
      ok = ok && px >= q[12] + EPS && px <= q[13] - EPS &&
           py >= q[14] + EPS && py <= q[15] - EPS;
      const float z = plane(q[9], q[10], q[11], px, py);
      ok = ok && z > 0.0f && z <= 1.0f;
      if (st.bounded) ok = ok && z > st.zlo[k] && z < st.zhi[k];
      const float zm = ok ? z : -1.0f;
      if (zm > gz[k]) {
        gz[k] = zm;
        gid[k] = id;
      } else if (zm == gz[k] && id > gid[k]) {
        gid[k] = id;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    if (gz[k] > st.bz[k]) {
      st.bz[k] = gz[k];
      st.bid[k] = gid[k];
    }
  }
}

__device__ __forceinline__ void stage(float* s, const float* src, int ncols) {
  __syncthreads();  // the previous group is no longer read
  for (int i = threadIdx.x; i < CHUNK * NCOL; i += THREADS) {
    const int r = i / NCOL, c = i - r * NCOL;
    s[i] = src[static_cast<int64_t>(r) * ncols + c];
  }
  __syncthreads();
}

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
  const int strips = TILE_H / STRIP_H;
  const int tile = blockIdx.x / strips;
  const int strip = blockIdx.x - tile * strips;
  const int ti = tile / tiles_x, tj = tile - ti * tiles_x;
  const int W = tiles_x * TILE_W;
  const int col = threadIdx.x % TILE_W;
  const int row0 = ti * TILE_H + strip * STRIP_H + threadIdx.x / TILE_W;

  Strip st;
  st.px = static_cast<float>(tj * TILE_W + col) + 0.5f;
  st.x_lo = static_cast<float>(tj * TILE_W) + 0.5f;
  st.x_hi = static_cast<float>(tj * TILE_W + TILE_W - 1) + 0.5f;
  st.y_lo = static_cast<float>(ti * TILE_H + strip * STRIP_H) + 0.5f;
  st.y_hi = static_cast<float>(ti * TILE_H + strip * STRIP_H + STRIP_H - 1) + 0.5f;
  st.bounded = zlo != nullptr;
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const int y = row0 + k * ROW_STEP;
    st.py[k] = static_cast<float>(y) + 0.5f;
    st.bz[k] = 0.0f;
    st.bid[k] = -1;
    if (st.bounded) {
      st.zlo[k] = zlo[static_cast<int64_t>(y) * W + tj * TILE_W + col];
      st.zhi[k] = zhi[static_cast<int64_t>(y) * W + tj * TILE_W + col];
    }
  }

  // big triangles first (the reference tests them at each tile's first window)
  const int n_big = *n_big_ptr;
  const int nb = (n_big + CHUNK - 1) / CHUNK;
  for (int g = 0; g < nb && (g + 1) * CHUNK <= nbig_rows; ++g) {
    stage(s, big_rows + static_cast<int64_t>(g) * CHUNK * ncols, ncols);
    test_group(s, st);
  }
  // then the tile's windows in order, each window's live groups b0..b1
  const int start = starts[tile];
  const int end = start + counts[tile];
  const int c0 = start / chunk;
  const int c1 = max((end + chunk - 1) / chunk, c0 + 1);
  for (int wabs = c0; wabs < c1; ++wabs) {
    const int lo = min(max(start - wabs * chunk, 0), chunk);
    const int hi = min(max(end - wabs * chunk, 0), chunk);
    const int b1 = (hi + CHUNK - 1) / CHUNK;
    for (int b = lo / CHUNK; b < b1; ++b) {
      stage(s, rows + (static_cast<int64_t>(wabs) * chunk + b * CHUNK) * ncols, ncols);
      test_group(s, st);
    }
  }
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const int64_t p = static_cast<int64_t>(row0 + k * ROW_STEP) * W + tj * TILE_W + col;
    depth[p] = st.bz[k];
    tid[p] = st.bid[k];
  }
}

}  // namespace

extern "C" int sailor_raster_worklist(const float* rows, int ncols,
                                      const float* big_rows, int nbig_rows,
                                      const int* n_big, const int* starts,
                                      const int* counts, const float* zlo,
                                      const float* zhi, float* depth, int* tid,
                                      int tiles_y, int tiles_x, int chunk,
                                      cudaStream_t stream) {
  const int blocks = tiles_y * tiles_x * (TILE_H / STRIP_H);
  raster_worklist_kernel<<<blocks, THREADS, 0, stream>>>(
      rows, ncols, big_rows, nbig_rows, n_big, starts, counts, zlo, zhi, depth,
      tid, tiles_x, chunk);
  return static_cast<int>(cudaGetLastError());
}
