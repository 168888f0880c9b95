// Device code shared by the tile rasters B1 and B7 (raster.cu), B8
// (raster_dma.cu) and B9 (raster_dense.cu): the counterparts of
// sailor_tpu/raster/tile_raster.py `_test_chunk` and `_merge_chunk`.
//
// Every raster runs blocks of 8-row strips of a 64x128 tile (8 strips a
// tile, 256 threads, 4 pixels a thread); B8 and B9 one block a strip, with
// the strip walk below (B1 and B7 cut a tile's walk into runs: raster.cu). A block stages a group of
// candidate rows through shared memory (every thread then reads the same
// row: a broadcast), tests it at its pixels and merges it into its running
// winners by the reference's rule: within a group the max reverse-Z wins
// and equal z goes to the larger id; a later group takes a pixel only with
// strictly greater z. Which rows share a group is each variant's walk and
// lives in its own kernel. Rounding: common.cuh.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace sailor_raster {

constexpr int TILE_H = 64;
constexpr int TILE_W = 128;
constexpr int CHUNK = 32;       // rows per merge group (the tie-break unit)
constexpr int CHUNK_MXU = 128;  // rows per group of B7's MXU form (raster.cu)
constexpr int NCOL = 17;        // staged row: edge 9, zplane 3, aabb 4, id
constexpr int STRIP_H = 8;      // pixel rows per block
constexpr int STRIPS = TILE_H / STRIP_H;
constexpr int THREADS = 256;
constexpr int PX = STRIP_H * TILE_W / THREADS;  // pixels per thread (4)
constexpr int ROW_STEP = THREADS / TILE_W;      // 2
constexpr float EPS = -0.05f;

// a*px + b*py + c as fma(a, px, b*py) + c
__device__ __forceinline__ float plane(float a, float b, float c, float px, float py) {
  return __fadd_rn(__fmaf_rn(a, px, __fmul_rn(b, py)), c);
}

struct Strip {
  int tile;
  float px;                // this thread's pixel-centre x
  float py[PX];            // its PX pixel-centre rows
  float x_lo, x_hi, y_lo, y_hi;  // the strip's outermost pixel centres
  float zlo[PX], zhi[PX];
  bool bounded;
  float bz[PX];
  int bid[PX];
  int64_t pix[PX];         // output index of each pixel
};

// This block's strip (blockIdx.x = tile * STRIPS + strip) and thread.
__device__ __forceinline__ void init_strip(Strip& st, int tiles_x,
                                           const float* zlo, const float* zhi) {
  const int tile = blockIdx.x / STRIPS;
  const int strip = blockIdx.x - tile * STRIPS;
  const int ti = tile / tiles_x, tj = tile - ti * tiles_x;
  const int W = tiles_x * TILE_W;
  const int col = threadIdx.x % TILE_W;
  const int lrow0 = strip * STRIP_H + threadIdx.x / TILE_W;
  st.tile = tile;
  st.px = static_cast<float>(tj * TILE_W + col) + 0.5f;
  st.x_lo = static_cast<float>(tj * TILE_W) + 0.5f;
  st.x_hi = static_cast<float>(tj * TILE_W + TILE_W - 1) + 0.5f;
  st.y_lo = static_cast<float>(ti * TILE_H + strip * STRIP_H) + 0.5f;
  st.y_hi = static_cast<float>(ti * TILE_H + strip * STRIP_H + STRIP_H - 1) + 0.5f;
  st.bounded = zlo != nullptr;
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    const int ly = lrow0 + k * ROW_STEP;
    st.py[k] = static_cast<float>(ti * TILE_H + ly) + 0.5f;
    st.pix[k] = static_cast<int64_t>(ti * TILE_H + ly) * W + tj * TILE_W + col;
    st.bz[k] = 0.0f;
    st.bid[k] = -1;
    if (st.bounded) {
      st.zlo[k] = zlo[st.pix[k]];
      st.zhi[k] = zhi[st.pix[k]];
    }
  }
}

__device__ __forceinline__ void write_strip(const Strip& st, float* depth, int* tid) {
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    depth[st.pix[k]] = st.bz[k];
    tid[st.pix[k]] = st.bid[k];
  }
}

// Stage G rows of `ncols` columns (the first NCOL used) into shared memory;
// rows past `nvalid` are dead (zeros, id -1).
template <int G>
__device__ __forceinline__ void stage(float* s, const float* src, int ncols, int nvalid) {
  __syncthreads();  // the previous group is no longer read
  for (int i = threadIdx.x; i < G * NCOL; i += THREADS) {
    const int r = i / NCOL, c = i - r * NCOL;
    s[i] = r < nvalid ? src[static_cast<int64_t>(r) * ncols + c] : (c == 16 ? -1.0f : 0.0f);
  }
  __syncthreads();
}

// Test one staged group of G rows and merge it into the running winners.
// CLAMP: the AABB sliver clamp (and the exact whole-strip reject it
// allows).
template <int G, bool CLAMP>
__device__ __forceinline__ void test_group(const float* s, Strip& st) {
  float gz[PX];
  int gid[PX];
#pragma unroll
  for (int k = 0; k < PX; ++k) {
    gz[k] = -1.0f;
    gid[k] = -1;
  }
  for (int r = 0; r < G; ++r) {
    const float* q = s + r * NCOL;
    const int id = static_cast<int>(q[16]);
    if (id < 0) continue;  // dead row: its -1 never changes a live max
    if (CLAMP && (st.x_hi < q[12] + EPS || st.x_lo > q[13] - EPS ||
                  st.y_hi < q[14] + EPS || st.y_lo > q[15] - EPS))
      continue;  // whole-strip AABB reject (the per-pixel comparisons)
#pragma unroll
    for (int k = 0; k < PX; ++k) {
      float e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = plane(q[3 * j], q[3 * j + 1], q[3 * j + 2], st.px, st.py[k]);
      bool ok = e[0] >= EPS && e[1] >= EPS && e[2] >= EPS;
      if (CLAMP)
        ok = ok && st.px >= q[12] + EPS && st.px <= q[13] - EPS &&
             st.py[k] >= q[14] + EPS && st.py[k] <= q[15] - EPS;
      const float z = e[3];
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

// The big-triangle list in groups of G: every tile tests it first.
template <int G>
__device__ __forceinline__ void test_big(float* s, const float* big_rows, int ncols,
                                         int nbig_rows, int n_big, Strip& st) {
  const int nb = (n_big + G - 1) / G;
  for (int g = 0; g < nb; ++g) {
    stage<G>(s, big_rows + static_cast<int64_t>(g) * G * ncols, ncols,
             max(0, min(G, nbig_rows - g * G)));
    test_group<G, true>(s, st);
  }
}

// Whole windows [w, w + nw) of `chunk` rows, in groups of G.
template <int G>
__device__ __forceinline__ void test_windows(float* s, const float* rows, int ncols,
                                             int w, int nw, int chunk, Strip& st) {
  for (int i = w; i < w + nw; ++i)
    for (int b = 0; b < chunk / G; ++b) {
      stage<G>(s, rows + (static_cast<int64_t>(i) * chunk + b * G) * ncols, ncols, G);
      test_group<G, true>(s, st);
    }
}

}  // namespace sailor_raster
