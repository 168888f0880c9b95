// Constants and the plane evaluation of the tile rasters in raster.cu: B1,
// B7 (both plane forms), B8 and B9 on one plan kernel and one raster
// kernel, the counterparts of sailor_tpu/raster/tile_raster.py
// `_test_chunk` and `_merge_chunk`.
//
// A tile is tile_h x 128 pixels (tile_h, a multiple of 8, is an argument
// of each entry: raster/tile_raster.py TILE_H), cut into 8-row strips of
// 256 threads, 4 pixels a thread, so a block's work and shared memory do
// not depend on the height. Candidate rows are merged by the reference's rule: within a
// group the max reverse-Z wins and equal z goes to the larger id; a later
// group takes a pixel only with strictly greater z. Which rows share a
// group is each variant's walk (raster.cu). Rounding: common.cuh.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace sailor_raster {

constexpr int TILE_W = 128;
constexpr int CHUNK = 32;       // rows per merge group (the tie-break unit)
constexpr int CHUNK_MXU = 128;  // rows per group of B7's MXU form
constexpr int NCOL = 17;        // staged row: edge 9, zplane 3, aabb 4, id
constexpr int STRIP_H = 8;      // pixel rows per block
constexpr int THREADS = 256;
constexpr float EPS = -0.05f;

// a*px + b*py + c as fma(a, px, b*py) + c
__device__ __forceinline__ float plane(float a, float b, float c, float px, float py) {
  return __fadd_rn(__fmaf_rn(a, px, __fmul_rn(b, py)), c);
}

}  // namespace sailor_raster
