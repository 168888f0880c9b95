// B5: cluster sweep (closest hit and any hit) for Hopper (sm_90a).
//
// Replaces sailor_tpu/raytracing/sweep.py `_sweep_kernel_dma`, called from
// `intersect` with DMA_SWEEP on (B6, sweep_grid.cu, computes the same
// function over the dense (block, step) grid). Its plain twin is
// `sweep_plain` in raytracing/sweep.py.
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
// from the run's data and reports the larger. Design: one block per
// sub-block, one thread per ray; the staging, the test and the merge are
// sweep_common.cuh's (shared with B6, sweep_grid.cu). The bound is a block
// reduction (__reduce_max_sync per warp, then the 8 warp maxima) after each
// live step.
#include <cstdint>

#include "sweep_common.cuh"

namespace {

using namespace sweep_dev;

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
  float r[9];
  load_ray(feats, ray, r);
  float t = tmax[ray];
  int idx = -1;
  int bound = block_max(__float_as_int(t), scratch);

  const int steps = nlive[b];
  for (int j = 0; j < steps; ++j) {
    if (blk_bits[b * nc + j] >= bound) break;
    if (e_bits[static_cast<int64_t>(sb) * nc + j] >= bound) continue;
    const int cid = order[b * nc + j];
    stage_cluster(g_cluster, cid, tri);
    test_cluster<ANY_HIT>(r, tri, cid, t, idx);
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
