// B6: cluster sweep over the dense (block, visit step) grid, closest hit and
// any hit, for Hopper (sm_90a).
//
// Replaces sailor_tpu/raytracing/sweep.py `_sweep_kernel` (the grid kernel
// `intersect` runs with SAILOR_SWEEP_DMA=0). Its plain twin is
// `sweep_grid_plain` in raytracing/sweep.py.
//
// What it computes: B5's function (sweep.cu) by the grid's contract. Each
// sub-block (any size, 256 rays by default) visits every one of the nc
// steps of its ray block's visit order, in order, and skips a step whose
// sub-block entry bits are not below its bound (the largest float32 bit pattern of its rays' best
// t; dead and retired rays hold -1.0, whose bits are negative). There is no
// live-step count and no block-wide stop. A live step tests the rays still
// live against the step's cluster order[b, j] with B5's test and merge
// (sweep_common.cuh), so the output equals B5's bit for bit: equal t within
// a cluster goes to the larger cid * cluster + col, across clusters strict <
// keeps the earlier step, any hit retires the ray with t = -1 and index 0.
//
// The TPU kernel's hold-previous fetch table and its feature-major side and
// plane blocks are Mosaic fetch tricks; here a live step copies its
// cluster's rows from the cluster-major g_cluster through order[b, j], as
// B5 does.
//
// Bound on the H100: B5's (the same pairs and tests): about 45 float
// operations per (ray, triangle) test of a ray live at its step, and 100 B
// of cluster rows a column (25 KB at 256) per live (sub-block, step) pair; chip_smoke.py counts both
// from the run's data and reports the larger.
//
// Design: B5's (sweep_common.cuh: live rays packed per step, triangles
// across lanes, division only where sides agree, the next live step's rows
// copied with cp.async during the current step, 3 blocks an SM); only the
// step search differs. It ballots 32 of the sub-block's entry
// bits at a time against the bound, over all nc steps: the dead steps past
// the last live one cost one ballot per 32, not one pass of the walk each.
#include <cstdint>
#include <type_traits>

#include "sweep_common.cuh"

namespace {

using namespace sweep_dev;

// MODE: WALK (sub-block and cluster of 256), CHUNKS (sub-block of 256, any
// cluster) or GENERAL (any sub-block and cluster; sweep_common.cuh point 6)
template <bool ANY_HIT, int MODE>
__global__ void __launch_bounds__(CHUNK, BLOCKS_PER_SM)
sweep_grid_kernel(const int* __restrict__ e_bits, const int* __restrict__ order,
                  const float* __restrict__ feats, const float* __restrict__ tmax,
                  const float* __restrict__ g_cluster, float* __restrict__ best_t,
                  int* __restrict__ best_i, int nsub, int sub, int nc, int cluster) {
  __shared__ __align__(16) std::conditional_t<MODE == GENERAL, SmemG, Smem> sm;
  const int b = blockIdx.x / nsub;
  const int* e_row = e_bits + static_cast<int64_t>(blockIdx.x) * nc;
  // the first step at or after `from` whose entry bits are below the bound
  auto next = [&](int from, int bound) {
    const int lane = threadIdx.x & 31;
    for (int base = from; base < nc; base += 32) {
      const int j = base + lane;
      const unsigned live = __ballot_sync(FULL, j < nc && e_row[j] < bound);
      if (live != 0) return base + __ffs(live) - 1;
    }
    return -1;
  };
  const int* order_row = order + static_cast<int64_t>(b) * nc;
  if constexpr (MODE == GENERAL)
    walk_general<ANY_HIT>(order_row, feats, tmax, g_cluster, cluster, sub, best_t, best_i, sm,
                          next);
  else if constexpr (MODE == CHUNKS)
    walk_chunks<ANY_HIT>(order_row, feats, tmax, g_cluster, cluster, best_t, best_i, sm, next);
  else
    walk<ANY_HIT>(order_row, feats, tmax, g_cluster, best_t, best_i, sm, next);
}

}  // namespace

extern "C" int sailor_sweep_grid(const int* e_bits, const int* order, const float* feats,
                                 const float* tmax, const float* g_cluster, float* best_t,
                                 int* best_i, int n_sub_blocks, int nsub, int sub, int nc,
                                 int cluster, int any_hit, cudaStream_t stream) {
  if (cluster < 1 || sub < 1 || nsub < 1) return static_cast<int>(cudaErrorInvalidValue);
  using Kernel = decltype(&sweep_grid_kernel<true, GENERAL>);
  const Kernel kernels[2][3] = {
      {sweep_grid_kernel<false, WALK>, sweep_grid_kernel<false, CHUNKS>,
       sweep_grid_kernel<false, GENERAL>},
      {sweep_grid_kernel<true, WALK>, sweep_grid_kernel<true, CHUNKS>,
       sweep_grid_kernel<true, GENERAL>}};
  const int mode = sub != SUB ? GENERAL : (cluster == CHUNK ? WALK : CHUNKS);
  const Kernel kernel = kernels[any_hit ? 1 : 0][mode];
  kernel<<<n_sub_blocks, CHUNK, 0, stream>>>(e_bits, order, feats, tmax, g_cluster, best_t,
                                             best_i, nsub, sub, nc, cluster);
  return static_cast<int>(cudaGetLastError());
}
