// B5: cluster sweep (closest hit and any hit) for Hopper (sm_90a).
//
// Replaces sailor_tpu/raytracing/sweep.py `_sweep_kernel_dma`, called from
// `intersect` with DMA_SWEEP on (B6, sweep_grid.cu, computes the same
// function over the dense (block, step) grid). Its plain twin is
// `sweep_plain` in raytracing/sweep.py.
//
// What it computes: each sub-block (256 rays by default; `sub`, any size)
// walks the clusters of its ray block (nsub sub-blocks) in visit order (near
// to far by the block's slab entry).
// Its bound is the largest float32 bit pattern of its rays' best t (dead
// rays hold -1.0, whose bits are negative). A step whose sub-block entry
// bits are not below the bound is skipped; the walk stops at the first step
// whose sorted block entry reaches the bound (the sorted block entry is a
// lower bound of every later sub-block entry, so the stop is exact). A live
// step tests every (ray, triangle) pair of the cluster for the rays still
// live (best t > 1e-4), with the test and merge of sweep_common.cuh. The
// cluster size is an argument (any size of at least 1: a step tests its
// cluster 256 columns at a time), and so is the sub-block size (any size of
// at least 1: a step tests its live rays 256 at a time).
//
// Bound on the H100: about 45 float operations per (ray, triangle) test of
// a ray live at its step, and the 25 used rows of the cluster block (100 B
// a column: 25 KB at 256) read per (sub-block, step) pair the walk takes; chip_smoke.py counts both
// from the run's data and reports the larger. With -fmad=false every
// multiply and add issues alone, so the issue-rate floor is about twice that
// bound.
//
// Design (sweep_common.cuh says how): one block per sub-block; the live
// rays are packed per step, so idle lanes of dead, escaped and retired rays
// cost nothing; thread k holds triangle k, each warp loops over the packed
// rays four (any hit: three) at a time; the division runs only where a
// lane's sides agree; the next live step's rows are copied with cp.async
// while the current step tests; 3 blocks an SM. The step search is a warp
// ballot over 32 steps of the sub-block's entry bits and the block's sorted
// entries at a time.
#include <cstdint>
#include <type_traits>

#include "sweep_common.cuh"

namespace {

using namespace sweep_dev;

// MODE: WALK (sub-block and cluster of 256), CHUNKS (sub-block of 256, any
// cluster) or GENERAL (any sub-block and cluster; sweep_common.cuh point 6)
template <bool ANY_HIT, int MODE>
__global__ void __launch_bounds__(CHUNK, BLOCKS_PER_SM)
sweep_kernel(const int* __restrict__ e_bits, const int* __restrict__ order,
             const int* __restrict__ blk_bits, const int* __restrict__ nlive,
             const float* __restrict__ feats, const float* __restrict__ tmax,
             const float* __restrict__ g_cluster, float* __restrict__ best_t,
             int* __restrict__ best_i, int nsub, int sub, int nc, int cluster) {
  __shared__ __align__(16) std::conditional_t<MODE == GENERAL, SmemG, Smem> sm;
  const int b = blockIdx.x / nsub;
  const int* e_row = e_bits + static_cast<int64_t>(blockIdx.x) * nc;
  const int* blk_row = blk_bits + static_cast<int64_t>(b) * nc;
  const int steps = nlive[b];
  // the first step at or after `from` that is live, -1 once a sorted block
  // entry reaches the bound (the walk's stop) or the live steps run out
  auto next = [&](int from, int bound) {
    const int lane = threadIdx.x & 31;
    for (int base = from; base < steps; base += 32) {
      const int j = base + lane;
      const bool in = j < steps;
      const unsigned stop = __ballot_sync(FULL, in && blk_row[j] >= bound);
      const unsigned live = __ballot_sync(FULL, in && e_row[j] < bound);
      const unsigned any = stop | live;
      if (any != 0) {
        const int f = __ffs(any) - 1;
        return ((stop >> f) & 1u) ? -1 : base + f;
      }
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

extern "C" int sailor_sweep(const int* e_bits, const int* order,
                            const int* blk_bits, const int* nlive,
                            const float* feats, const float* tmax,
                            const float* g_cluster, float* best_t, int* best_i,
                            int n_sub_blocks, int nsub, int sub, int nc, int cluster, int any_hit,
                            cudaStream_t stream) {
  if (cluster < 1 || sub < 1 || nsub < 1) return static_cast<int>(cudaErrorInvalidValue);
  using Kernel = decltype(&sweep_kernel<true, GENERAL>);
  const Kernel kernels[2][3] = {
      {sweep_kernel<false, WALK>, sweep_kernel<false, CHUNKS>, sweep_kernel<false, GENERAL>},
      {sweep_kernel<true, WALK>, sweep_kernel<true, CHUNKS>, sweep_kernel<true, GENERAL>}};
  const int mode = sub != SUB ? GENERAL : (cluster == CHUNK ? WALK : CHUNKS);
  const Kernel kernel = kernels[any_hit ? 1 : 0][mode];
  kernel<<<n_sub_blocks, CHUNK, 0, stream>>>(e_bits, order, blk_bits, nlive, feats, tmax,
                                             g_cluster, best_t, best_i, nsub, sub, nc, cluster);
  return static_cast<int>(cudaGetLastError());
}
