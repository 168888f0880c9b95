// Device code shared by the cluster sweeps B5 (sweep.cu, the per-block
// walk) and B6 (sweep_grid.cu, the dense (block, step) grid): the staging
// of one cluster, the (ray, triangle) test and the merge into a ray's best
// hit. Each kernel keeps only its walk over visit steps.
//
// One block per 256-ray sub-block, one thread per ray. A step stages the 25
// used feature rows of its cluster (18 side, 4 num, 3 den) in shared memory,
// transposed to 28 floats per triangle, so each thread reads a triangle as
// seven float4 broadcasts. The test: Plücker sides s_e = [d, m] . edge_e,
// num = [o, 1] . [-n, k], den = d . n; a hit iff the sides agree in sign,
// den != 0 and 1e-4 < num/den < best (exact division, den == 0 -> 1).
// Closest hit keeps the least t, equal t within a cluster going to the larger
// cid * 256 + col; any hit retires the ray with t = -1 and index 0. Sums run
// left to right with -fmad=false, as in the plain twins, so the kernels and
// the twins agree bit for bit.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace sweep_dev {

constexpr int SUB = 256;
constexpr int CLUSTER = 256;
constexpr int ROWS = 40;
constexpr int FEATS = 16;
constexpr int TRI = 28;  // staged floats per triangle: 18 side, 4 num, 3 den, pad
constexpr int WARPS = SUB / 32;

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// left-to-right six-term dot of [d, m] with an edge's six features
__device__ __forceinline__ float side(const float* r, const float* g) {
  float acc = mul(r[0], g[0]);
#pragma unroll
  for (int k = 1; k < 6; ++k) acc = add(acc, mul(r[k], g[k]));
  return acc;
}

// The largest v over the block (every thread gets it). Its barriers also
// keep the next step from restaging the cluster while a thread still tests.
__device__ __forceinline__ int block_max(int v, int* scratch) {
  const int w = __reduce_max_sync(0xffffffffu, v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = w;
  __syncthreads();
  int m = scratch[0];
#pragma unroll
  for (int i = 1; i < WARPS; ++i) m = max(m, scratch[i]);
  __syncthreads();  // scratch is rewritten by the next call
  return m;
}

// This thread's ray: d (3), m (3), o (3) from its 16 feature columns.
__device__ __forceinline__ void load_ray(const float* __restrict__ feats, int64_t ray,
                                         float r[9]) {
#pragma unroll
  for (int k = 0; k < 6; ++k) r[k] = feats[ray * FEATS + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) r[6 + k] = feats[ray * FEATS + 8 + k];
}

// Thread k copies triangle k's used rows of cluster cid (coalesced across
// threads), then the block waits for the whole cluster.
__device__ __forceinline__ void stage_cluster(const float* __restrict__ g_cluster, int cid,
                                              float* tri) {
  const float* g = g_cluster + static_cast<int64_t>(cid) * ROWS * CLUSTER + threadIdx.x;
  float* s = tri + threadIdx.x * TRI;
#pragma unroll
  for (int e = 0; e < 3; ++e)
#pragma unroll
    for (int k = 0; k < 6; ++k) s[6 * e + k] = g[(8 * e + k) * CLUSTER];
#pragma unroll
  for (int k = 0; k < 4; ++k) s[18 + k] = g[(24 + k) * CLUSTER];
#pragma unroll
  for (int k = 0; k < 3; ++k) s[22 + k] = g[(36 + k) * CLUSTER];
  __syncthreads();
}

// Test the ray r against the staged cluster cid and merge into (t, idx). A
// dead ray (t <= 1e-4) skips the tests: no t can pass both 1e-4 < t and
// t < best.
template <bool ANY_HIT>
__device__ __forceinline__ void test_cluster(const float r[9], const float* tri, int cid,
                                             float& t, int& idx) {
  if (!(t > 1e-4f)) return;
  const float best = t;
  float cur = __int_as_float(0x7f800000);
  int ci = -1;
  for (int k = 0; k < CLUSTER; ++k) {
    float q[TRI];
    const float4* q4 = reinterpret_cast<const float4*>(tri + k * TRI);
#pragma unroll
    for (int v = 0; v < TRI / 4; ++v) {
      const float4 x = q4[v];
      q[4 * v] = x.x;
      q[4 * v + 1] = x.y;
      q[4 * v + 2] = x.z;
      q[4 * v + 3] = x.w;
    }
    const float s0 = side(r, q), s1 = side(r, q + 6), s2 = side(r, q + 12);
    const float num = add(add(add(mul(r[6], q[18]), mul(r[7], q[19])), mul(r[8], q[20])), q[21]);
    const float den = add(add(mul(r[0], q[22]), mul(r[1], q[23])), mul(r[2], q[24]));
    const bool agree = (s0 >= 0.0f && s1 >= 0.0f && s2 >= 0.0f) ||
                       (s0 <= 0.0f && s1 <= 0.0f && s2 <= 0.0f);
    const float tval = __fdiv_rn(num, den == 0.0f ? 1.0f : den);
    const bool ok = agree && den != 0.0f && tval > 1e-4f && tval < best;
    if (ok) {
      if (ANY_HIT) {
        ci = k;
        break;
      }
      if (tval <= cur) {  // ascending k: equal t goes to the larger col
        cur = tval;
        ci = k;
      }
    }
  }
  if (ci >= 0) {  // a later step takes the ray only with a strictly smaller t
    t = ANY_HIT ? -1.0f : cur;
    idx = ANY_HIT ? 0 : cid * CLUSTER + ci;
  }
}

}  // namespace sweep_dev
