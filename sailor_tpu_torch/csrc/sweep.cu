// B5: cluster sweep (closest hit and any hit) for Hopper (sm_90a).
//
// Replaces sailor_tpu/raytracing/sweep.py `_sweep_kernel_dma`, called from
// `intersect` (the reference's `_sweep_kernel` computes the same function
// over a dense (block, cluster) grid). Its plain twin is `sweep_plain` in
// raytracing/sweep.py.
//
// What it computes: each 256-ray sub-block walks the clusters of its
// 2048-ray block in visit order (near to far by the block's slab entry).
// Its bound is the largest float32 bit pattern of its rays' best t (dead
// rays hold -1.0, whose bits are negative). A step whose sub-block entry
// bits are not below the bound is skipped; the walk stops at the first step
// whose sorted block entry reaches the bound (the sorted block entry is a
// lower bound of every later sub-block entry, so the stop is exact). A live
// step tests every (ray, triangle) pair of the cluster: Plücker sides
// s_e = [d, m] . edge_e, num = [o, 1] . [-n, k], den = d . n, a hit iff the
// sides agree in sign, den != 0 and 1e-4 < num/den < best (exact division).
// Closest hit keeps the least t, equal t within a cluster going to the
// larger cid * 256 + col and across clusters to the earlier step; any hit
// retires the ray with t = -1 and index 0. Sums run left to right with
// -fmad=false, as in the twin, so the two agree bit for bit.
//
// Bound on the H100: about 45 float operations per (ray, triangle) test of
// a ray live at its step, and the 25 used rows (25 KB) of the cluster block
// read per (sub-block, step) pair the walk takes; chip_smoke.py counts both
// from the run's data and reports the larger. Design: one block per sub-block, one thread per ray. A live
// step stages the 25 used feature rows of its cluster in shared memory,
// transposed to 28 floats per triangle, so each thread reads a triangle as
// seven float4 broadcasts. A dead ray (best t <= 1e-4) skips the tests: no
// t can pass both 1e-4 < t and t < best. The bound is a block reduction
// (__reduce_max_sync per warp, then the 8 warp maxima) after each live step.
#include <cstdint>

#include "common.cuh"

namespace {

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

template <bool ANY_HIT>
__global__ void __launch_bounds__(SUB)
sweep_kernel(const int* __restrict__ e_bits, const int* __restrict__ order,
             const int* __restrict__ blk_bits, const int* __restrict__ nlive,
             const float* __restrict__ feats, const float* __restrict__ tmax,
             const float* __restrict__ g_cluster, float* __restrict__ best_t,
             int* __restrict__ best_i, int nsub, int nc) {
  __shared__ __align__(16) float tri[CLUSTER * TRI];
  __shared__ int scratch[WARPS];
  const int sb = blockIdx.x;
  const int b = sb / nsub;
  const int64_t ray = static_cast<int64_t>(sb) * SUB + threadIdx.x;
  float r[9];  // d (3), m (3), o (3)
#pragma unroll
  for (int k = 0; k < 6; ++k) r[k] = feats[ray * FEATS + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) r[6 + k] = feats[ray * FEATS + 8 + k];
  float t = tmax[ray];
  int idx = -1;
  int bound = block_max(__float_as_int(t), scratch);

  const int steps = nlive[b];
  for (int j = 0; j < steps; ++j) {
    if (blk_bits[b * nc + j] >= bound) break;
    if (e_bits[static_cast<int64_t>(sb) * nc + j] >= bound) continue;
    const int cid = order[b * nc + j];
    // stage: thread k copies triangle k's used rows (coalesced across threads)
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

    if (t > 1e-4f) {
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
      if (ci >= 0) {
        t = ANY_HIT ? -1.0f : cur;
        idx = ANY_HIT ? 0 : cid * CLUSTER + ci;
      }
    }
    // block_max's barriers also keep the next step from restaging early
    bound = block_max(__float_as_int(t), scratch);
  }
  best_t[ray] = t;
  best_i[ray] = idx;
}

}  // namespace

extern "C" int sailor_sweep(const int* e_bits, const int* order,
                            const int* blk_bits, const int* nlive,
                            const float* feats, const float* tmax,
                            const float* g_cluster, float* best_t, int* best_i,
                            int n_sub_blocks, int nsub, int nc, int any_hit,
                            cudaStream_t stream) {
  if (any_hit)
    sweep_kernel<true><<<n_sub_blocks, SUB, 0, stream>>>(
        e_bits, order, blk_bits, nlive, feats, tmax, g_cluster, best_t, best_i, nsub, nc);
  else
    sweep_kernel<false><<<n_sub_blocks, SUB, 0, stream>>>(
        e_bits, order, blk_bits, nlive, feats, tmax, g_cluster, best_t, best_i, nsub, nc);
  return static_cast<int>(cudaGetLastError());
}
