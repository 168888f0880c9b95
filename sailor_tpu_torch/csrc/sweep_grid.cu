// B6: cluster sweep over the dense (block, visit step) grid, closest hit and
// any hit, for Hopper (sm_90a).
//
// Replaces sailor_tpu/raytracing/sweep.py `_sweep_kernel` (the grid kernel
// `intersect` runs with SAILOR_SWEEP_DMA=0). Its plain twin is
// `sweep_grid_plain` in raytracing/sweep.py.
//
// What it computes: B5's function (sweep.cu) by the grid's contract. Each
// 256-ray sub-block visits every one of the nc steps of its 2048-ray
// block's visit order, in order, and skips a step whose sub-block entry bits
// are not below its bound (the largest float32 bit pattern of its rays' best
// t; dead and retired rays hold -1.0, whose bits are negative). There is no
// live-step count and no block-wide stop: a step past the last live one
// costs one compare. A live step tests every (ray, triangle) pair of the
// step's cluster order[b, j] with B5's test and merge (sweep_common.cuh),
// so the output equals B5's bit for bit: equal t within a cluster goes to
// the larger cid * 256 + col, across clusters strict < keeps the earlier
// step, any hit retires the ray with t = -1 and index 0.
//
// The TPU kernel's hold-previous fetch table and its feature-major side and
// plane blocks are Mosaic fetch tricks; here a live step reads its cluster's
// rows from the cluster-major g_cluster through order[b, j], as B5 does.
//
// Bound on the H100: about 45 float operations per (ray, triangle) test of a
// ray live at its step, and the 25 used rows (25 KB) of the cluster block
// read per live (sub-block, step) pair, counted over every step the grid
// takes (the same pairs B5 walks); chip_smoke.py counts both from the run's
// data and reports the larger. Design: one block per sub-block, one thread
// per ray, one sequential walk over the steps (the across-cluster tie rule
// needs the visit order); the step's entry bits are one broadcast load.
#include <cstdint>

#include "sweep_common.cuh"

namespace {

using namespace sweep_dev;

template <bool ANY_HIT>
__global__ void __launch_bounds__(SUB)
sweep_grid_kernel(const int* __restrict__ e_bits, const int* __restrict__ order,
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

  const int* e_row = e_bits + static_cast<int64_t>(sb) * nc;
  for (int j = 0; j < nc; ++j) {
    if (e_row[j] >= bound) continue;
    const int cid = order[b * nc + j];
    stage_cluster(g_cluster, cid, tri);
    test_cluster<ANY_HIT>(r, tri, cid, t, idx);
    bound = block_max(__float_as_int(t), scratch);
  }
  best_t[ray] = t;
  best_i[ray] = idx;
}

}  // namespace

extern "C" int sailor_sweep_grid(const int* e_bits, const int* order, const float* feats,
                                 const float* tmax, const float* g_cluster, float* best_t,
                                 int* best_i, int n_sub_blocks, int nsub, int nc,
                                 int any_hit, cudaStream_t stream) {
  if (any_hit)
    sweep_grid_kernel<true><<<n_sub_blocks, SUB, 0, stream>>>(
        e_bits, order, feats, tmax, g_cluster, best_t, best_i, nsub, nc);
  else
    sweep_grid_kernel<false><<<n_sub_blocks, SUB, 0, stream>>>(
        e_bits, order, feats, tmax, g_cluster, best_t, best_i, nsub, nc);
  return static_cast<int>(cudaGetLastError());
}
