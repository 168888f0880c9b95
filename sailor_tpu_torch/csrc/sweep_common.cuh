// Device code shared by the cluster sweeps B5 (sweep.cu, the per-block
// walk) and B6 (sweep_grid.cu, the dense (block, step) grid): the staging of
// a sub-block's rays, the packing of its live rays, the prefetch of a
// cluster, the (ray, triangle) test of a step and the merge into each ray's
// best hit. Each kernel keeps only its walk over visit steps.
//
// The function (the plain twins' in raytracing/sweep.py): Plücker sides
// s_e = [d, m] . edge_e, num = [o, 1] . [-n, k], den = d . n; a hit iff the
// sides agree in sign, den != 0 and 1e-4 < num/den < best (exact division,
// den == 0 -> 1). Closest hit keeps the least t, equal t within a cluster
// going to the larger cid * cluster + col; any hit retires the ray with
// t = -1 and index 0. Sums run left to right with -fmad=false, as in the twins, so
// the kernels and the twins agree bit for bit.
//
// The mapping: one block of 256 threads per sub-block (256 rays by default;
// any other size: point 6); the skip and
// stop decisions stay per sub-block, from its bound (the largest float32 bit
// pattern of its rays' best t), so no ray moves between sub-blocks.
//  1. Live rays packed per step. Thread r owns ray r (its t and index live
//     in registers). Before each step every warp ballots t > 1e-4, the block
//     forms a prefix over the 8 warp counts, and each live owner writes its
//     ray's features and best t to slot `pos` of a packed list of L entries.
//     A step then costs L x 256 tests on 256 lanes, however sparse the pass:
//     dead, escaped and retired rays take no lane time.
//  2. Triangles across lanes. Thread k holds triangle k's 25 used values in
//     registers; warp w loops over the L packed rays (read as broadcasts),
//     four at a time (three for any hit), and tests its 32 triangles. The
//     exact division runs only under a warp-uniform vote that some lane's
//     sides agree with den != 0; the hit is decided on the rounded quotient.
//     One vote covers the four rays' candidates, so most iterations are the
//     sums, the side signs and one vote (a sign test of num against den
//     before the vote would skip more divisions but cost every iteration
//     more than it saves). Per (ray, warp), a ballot of the hits; only if it
//     is nonzero a warp reduction to the least t (equal t to the larger k),
//     which lane 0 writes into the ray's slot for the warp (a slot holds
//     +inf otherwise). After a barrier each owner merges the 8 warps in k
//     order (least t, equal t to the larger k) and resets its slots; a later
//     step takes the ray only with a strictly smaller t (best is the t at
//     the start of the step). Any hit: a hit writes -1 into the packed ray's
//     best, which the other warps read before testing it and the owner reads
//     after the step (a harmless race: the result is t = -1, index 0,
//     whichever triangle hit).
//  3. No restaging through a transposed tile: thread k copies its own
//     column of the cluster's 25 feature-major rows (row r at r*256 + k, a
//     coalesced 128 B a warp) with cp.async into its own column of a shared
//     buffer, conflict-free, and reads it back into registers. Only thread k
//     ever touches column k, so the copy needs no barrier, and the next live
//     step's copy (found under the current bound) is issued before the
//     current step tests. The bound only falls, so a prefetched step may turn
//     out dead: that wastes bytes, never changes a result. Three barriers a
//     step: the packed list, the (ray, warp) results, the next packing.
//  4. Waves: four rays' independent sums need more than 64 registers
//     (ptxas: 72-76), so __launch_bounds__(256, 3): 3 blocks (46 KB of
//     shared memory each) on an SM, 396 at once, 2.6 waves of 1024
//     sub-blocks. On the H100 this beat 64 registers and 4 blocks an SM;
//     the kernel is bound by instruction issue (45 unfused float operations
//     and about 10 others a test, per lane), not by memory.
//  5. The cluster size is a kernel argument. A cluster of CHUNK = 256 (the
//     default) takes `walk`, the mapping above with every size a constant.
//     Any other size takes `walk_chunks`: a step tests its cluster a chunk
//     of 256 columns at a time, thread k holding column c * 256 + k of
//     chunk c (row r of cluster cid at (cid * 40 + r) * cluster + column);
//     a lane past the cluster's end holds zeros, whose den is 0 (or NaN with
//     NaN sides), so it never hits, and a warp with no column skips the test
//     loop. Every chunk tests against the t at the step's start; the owner
//     folds each chunk's 8 warps in column order into the step's running
//     best (an equal t to the larger column, so to the later chunk) and
//     takes it after the last chunk, so a later step, another cluster, takes
//     the ray only with a strictly smaller t, as the twins do. part_k holds
//     a column within its chunk (8 bits); the fold adds the chunk's first
//     column. The next chunk of the same step is the next copy. Below 256
//     columns lanes sit idle (cluster / 256 of them hold a column), and 257
//     to 511 pay for two whole chunks. walk_chunks at cluster 256 took
//     3.7265-3.7914 ms on tracer-512's bounce-1 pass against 3.3045-3.35 for
//     walk (H100 80GB HBM3, 700 W, tests/torch_sweep_variants.py): nvcc
//     schedules the test loop worse around the chunk loop, so the default
//     size keeps its own walk.
//  6. The sub-block size is a kernel argument too. At SUB = 256 (the
//     default) the walks above own one ray a thread. Any other size takes
//     `walk_general`, with the same 256 lanes of triangles and the chunks
//     of point 5: thread k owns the sub-block's rays k, k + 256, ... (none
//     past the sub-block's end, so below 256 some threads own none), and
//     their best t and index live in best_t/best_i in global memory, so a
//     thread's registers do not grow with the size. A step packs the live
//     rays round by round (256 rays a round, a prefix over the 8 warps as
//     above) into a list of at most LIST = 256 entries, each with the
//     ray it holds; a full list is tested (every chunk of the step's
//     cluster, against the t at the step's start) and thread s folds slot
//     s's results into its ray in global memory, and the round's rays
//     past the list's end open the next list. The last, partial list is
//     tested after the last round. The bound is then read anew over every
//     ray. The skip and stop decisions, the test and the fold order are
//     those of the walks above, so the result is the same function at
//     every size. walk_general could also serve sub-block 256 at any
//     cluster size, in walk_chunks' place; in turns on tracer-512's
//     bounce-1 pass (H100 80GB HBM3, 700 W, tests/torch_sweep_variants.py)
//     it took 3.5974-3.6207 ms at cluster 128 against walk_chunks'
//     3.4308-3.4848 (shadow pass 1.1636-1.1976 against 1.122-1.1695), and
//     at 512 4.5084-4.5355 against 4.5139-4.5526 (shadow 1.4214-1.4784
//     against 1.3624-1.4384); a second call gave 3.6152-3.6576 against
//     3.4901-3.5189 at 128. So sub-block 256 keeps walk_chunks.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace sweep_dev {

constexpr int SUB = 256;    // the default sub-block: one ray a thread
constexpr int LIST = 256;   // packed rays a step tests at a time
constexpr int CHUNK = 256;  // columns a step stages at a time: one a thread
constexpr int ROWS = 40;
constexpr int FEATS = 16;
constexpr int USED = 25;  // used rows a triangle: 18 side, 4 num, 3 den
constexpr int WARPS = SUB / 32;
constexpr int BLOCKS_PER_SM = 3;  // __launch_bounds__: at most 80 registers
constexpr unsigned FULL = 0xffffffffu;
enum { WALK, CHUNKS, GENERAL };  // the kernels' walks: walk, walk_chunks, walk_general

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// the used rows: edge e's six Plücker rows at 8e, then -n, k and n
__device__ __forceinline__ int used_row(int r) {
  return r < 18 ? 8 * (r / 6) + r % 6 : (r < 22 ? 24 + (r - 18) : 36 + (r - 22));
}

struct Smem {
  float4 ray_dm[SUB];      // packed live rays: d0 d1 d2 m0
  float4 ray_mo[SUB];      // m1 m2 o0 o1
  float2 ray_ob[SUB];      // o2, best t at the step's start (-1: any hit found)
  float part_t[WARPS][SUB];          // per (warp, packed ray): least t, +inf if none
  unsigned char part_k[WARPS][SUB];  // its column
  float buf[USED][CHUNK];            // column k: thread k's rows of the chunk
  int wmax[WARPS];
  unsigned wmask[WARPS];
};

// walk_general's: the shared state of the walks, the ray each packed slot
// holds (its index in the sub-block) and the round's warp masks (two
// rounds' apart, so a round needs one barrier).
struct SmemG {
  Smem s;
  int slot_ray[LIST];
  unsigned rmask[2][WARPS];
};

struct Pack {
  int bound;  // the sub-block's bound: largest t bits
  int count;  // L, live rays
  int pos;    // this thread's ray's slot in the packed list, -1 if not live
};

// Pack the live rays (t > 1e-4) of the sub-block: every thread gets the
// bound and L, each live owner its slot; the slots are filled in ray order.
// Ends without a barrier: the caller's next barrier publishes the list.
__device__ __forceinline__ Pack pack(float t, const float* __restrict__ feats, int64_t ray,
                                     Smem& sm) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const bool live = t > 1e-4f;
  const unsigned mask = __ballot_sync(FULL, live);
  const int wmax = __reduce_max_sync(FULL, __float_as_int(t));
  if (lane == 0) {
    sm.wmax[w] = wmax;
    sm.wmask[w] = mask;
  }
  __syncthreads();
  Pack p{sm.wmax[0], 0, -1};
  int before = 0;
#pragma unroll
  for (int v = 0; v < WARPS; ++v) {
    const int c = __popc(sm.wmask[v]);
    before += v < w ? c : 0;
    p.count += c;
    p.bound = max(p.bound, sm.wmax[v]);
  }
  if (live) {
    p.pos = before + __popc(mask & ((1u << lane) - 1u));
    const float4* f = reinterpret_cast<const float4*>(feats + ray * FEATS);
    const float4 dm = __ldg(f), mz = __ldg(f + 1), o1 = __ldg(f + 2);
    sm.ray_dm[p.pos] = dm;
    sm.ray_mo[p.pos] = make_float4(mz.x, mz.y, o1.x, o1.y);
    sm.ray_ob[p.pos] = make_float2(o1.z, t);
  }
  return p;
}

// Thread k: copy triangle k's used rows of cluster cid into column k of the
// buffer, asynchronously (one group). Clusters of CHUNK columns.
__device__ __forceinline__ void prefetch(const float* __restrict__ g_cluster, int cid, Smem& sm) {
  const float* g = g_cluster + static_cast<int64_t>(cid) * ROWS * CHUNK + threadIdx.x;
#pragma unroll
  for (int r = 0; r < USED; ++r) {
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(&sm.buf[r][threadIdx.x]));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(g + used_row(r) * CHUNK)
                 : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Thread k: copy column chunk * CHUNK + k's used rows of cluster cid (if
// the cluster has that column) into column k of the buffer, asynchronously
// (one group). Clusters of any size.
__device__ __forceinline__ void prefetch_chunk(const float* __restrict__ g_cluster, int cid,
                                               int chunk, int cluster, Smem& sm) {
  const int col = chunk * CHUNK + static_cast<int>(threadIdx.x);
  if (col < cluster) {
    const float* g = g_cluster + static_cast<int64_t>(cid) * ROWS * cluster + col;
#pragma unroll
    for (int r = 0; r < USED; ++r) {
      const unsigned dst =
          static_cast<unsigned>(__cvta_generic_to_shared(&sm.buf[r][threadIdx.x]));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                   "l"(g + static_cast<int64_t>(used_row(r)) * cluster)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_prefetch() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Thread k: triangle k's rows, from its own column once its copy landed.
__device__ __forceinline__ void take(const Smem& sm, float q[USED]) {
  wait_prefetch();
#pragma unroll
  for (int r = 0; r < USED; ++r) q[r] = sm.buf[r][threadIdx.x];
}

// take for a chunk of `width` columns: zeros for a lane past the cluster's
// end (never a hit: its den is 0, or NaN with NaN sides).
__device__ __forceinline__ void take_chunk(const Smem& sm, float q[USED], int width) {
  wait_prefetch();
  const bool valid = static_cast<int>(threadIdx.x) < width;
#pragma unroll
  for (int r = 0; r < USED; ++r) q[r] = valid ? sm.buf[r][threadIdx.x] : 0.0f;
}

// left-to-right six-term dot of [d, m] with an edge's six rows
__device__ __forceinline__ float side(float d0, float d1, float d2, float m0, float m1,
                                      float m2, const float* g) {
  float acc = mul(d0, g[0]);
  acc = add(acc, mul(d1, g[1]));
  acc = add(acc, mul(d2, g[2]));
  acc = add(acc, mul(m0, g[3]));
  acc = add(acc, mul(m1, g[4]));
  return add(acc, mul(m2, g[5]));
}

// Test packed rays i0 .. i0 + R - 1 against this thread's triangle q: the
// R rays' sums first (R x 5 independent chains), then one vote for all R;
// only a warp with a candidate lane goes on to the divisions and ballots.
template <bool ANY_HIT, int R>
__device__ __forceinline__ void test_rays(const float q[USED], Smem& sm, int i0) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const float inf = __int_as_float(0x7f800000);
  float best[R], num[R], den[R];
  bool may[R];
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int i = i0 + u;
    best[u] = sm.ray_ob[i].y;
    if (ANY_HIT) best[u] = __shfl_sync(FULL, best[u], 0);  // another warp may retire it
    const float4 dm = sm.ray_dm[i], mo = sm.ray_mo[i];
    const float o2 = sm.ray_ob[i].x;
    const float s0 = side(dm.x, dm.y, dm.z, dm.w, mo.x, mo.y, q);
    const float s1 = side(dm.x, dm.y, dm.z, dm.w, mo.x, mo.y, q + 6);
    const float s2 = side(dm.x, dm.y, dm.z, dm.w, mo.x, mo.y, q + 12);
    num[u] = add(add(add(mul(mo.z, q[18]), mul(mo.w, q[19])), mul(o2, q[20])), q[21]);
    den[u] = add(add(mul(dm.x, q[22]), mul(dm.y, q[23])), mul(dm.z, q[24]));
    const bool agree = (s0 >= 0.0f && s1 >= 0.0f && s2 >= 0.0f) ||
                       (s0 <= 0.0f && s1 <= 0.0f && s2 <= 0.0f);
    may[u] = agree && den[u] != 0.0f && (!ANY_HIT || best[u] > 0.0f);
  }
  bool any_may = false;
#pragma unroll
  for (int u = 0; u < R; ++u) any_may = any_may || may[u];
  if (!__any_sync(FULL, any_may)) return;
#pragma unroll
  for (int u = 0; u < R; ++u) {
    const int i = i0 + u;
    unsigned hits = 0;
    float tval = inf;
    if (__any_sync(FULL, may[u])) {
      tval = __fdiv_rn(num[u], den[u] == 0.0f ? 1.0f : den[u]);
      hits = __ballot_sync(FULL, may[u] && tval > 1e-4f && tval < best[u]);
    }
    if (ANY_HIT) {
      if (hits != 0 && lane == 0) sm.ray_ob[i].y = -1.0f;
      continue;
    }
    if (hits != 0) {  // the slot holds +inf otherwise (merge resets it)
      const bool ok = (hits >> lane) & 1u;
      float tmin = ok ? tval : inf;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) tmin = fminf(tmin, __shfl_xor_sync(FULL, tmin, o));
      const int kmax =
          __reduce_max_sync(FULL, (ok && tval == tmin) ? static_cast<int>(threadIdx.x) : -1);
      if (lane == 0) {
        sm.part_t[w][i] = tmin;
        sm.part_k[w][i] = static_cast<unsigned char>(kmax);
      }
    }
  }
}
// Test the `count` packed rays against this thread's triangle q (column
// threadIdx.x): per (ray, warp), one (t, k) into part_t/part_k (closest
// hit) or the retire flag (any hit). Barriers before (the packed list) and
// after (the results).
template <bool ANY_HIT>
__device__ __forceinline__ void test_step(const float q[USED], Smem& sm, int count) {
  __syncthreads();
  int i = 0;
  // packed rays a warp tests an iteration (any hit keeps each ray's best
  // live through the sums, so it takes three to stay within 80 registers)
  constexpr int R = ANY_HIT ? 3 : 4;
  for (; i + R <= count; i += R) test_rays<ANY_HIT, R>(q, sm, i);
  for (; i < count; ++i) test_rays<ANY_HIT, 1>(q, sm, i);
  __syncthreads();
}

// test_step for a chunk of `width` columns: a warp with no column skips
// the loop (it still meets the barriers).
template <bool ANY_HIT>
__device__ __forceinline__ void test_chunk(const float q[USED], Smem& sm, int count, int width) {
  __syncthreads();
  if ((threadIdx.x & ~31u) < static_cast<unsigned>(width)) {
    int i = 0;
    constexpr int R = ANY_HIT ? 3 : 4;
    for (; i + R <= count; i += R) test_rays<ANY_HIT, R>(q, sm, i);
    for (; i < count; ++i) test_rays<ANY_HIT, 1>(q, sm, i);
  }
  __syncthreads();
}

// The owner of a packed ray folds the step's results into (t, idx).
template <bool ANY_HIT>
__device__ __forceinline__ void merge(Smem& sm, int pos, int cid, float& t, int& idx) {
  if (pos < 0) return;
  if (ANY_HIT) {
    if (sm.ray_ob[pos].y < 0.0f) {
      t = -1.0f;
      idx = 0;
    }
    return;
  }
  const float inf = __int_as_float(0x7f800000);
  float cur = inf;
  int ci = -1;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {  // ascending k: equal t goes to the larger col
    const float pt = sm.part_t[w][pos];
    if (pt < inf && pt <= cur) {
      cur = pt;
      ci = sm.part_k[w][pos];
    }
    sm.part_t[w][pos] = inf;  // the packed slots only shrink: every later slot is reset
  }
  if (ci >= 0) {
    t = cur;
    idx = cid * CHUNK + ci;
  }
}

// Closest hit, clusters of any size: the owner of a packed ray folds one
// chunk's results, whose first column is col0, into the step's running
// best (cur, ci): ascending column, so an equal t goes to the larger
// column, the later chunk's too.
template <bool ANY_HIT>
__device__ __forceinline__ void fold(Smem& sm, int pos, int col0, float& cur, int& ci) {
  if (ANY_HIT || pos < 0) return;
  const float inf = __int_as_float(0x7f800000);
#pragma unroll
  for (int w = 0; w < WARPS; ++w) {
    const float pt = sm.part_t[w][pos];
    if (pt < inf && pt <= cur) {
      cur = pt;
      ci = col0 + sm.part_k[w][pos];
    }
    sm.part_t[w][pos] = inf;
  }
}

// One sub-block's walk, given the kernel's step search: next(from, bound)
// is the first live step at or after `from` under `bound`, or -1. Every
// thread computes the same steps (the same loads and the same bound).
// Clusters of CHUNK columns: one chunk a step, every size a constant.
template <bool ANY_HIT, typename Next>
__device__ __forceinline__ void walk(const int* __restrict__ order_row,
                                     const float* __restrict__ feats,
                                     const float* __restrict__ tmax,
                                     const float* __restrict__ g_cluster,
                                     float* __restrict__ best_t, int* __restrict__ best_i,
                                     Smem& sm, Next next) {
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * SUB + threadIdx.x;
  float t = tmax[ray];
  int idx = -1;
  if (!ANY_HIT)
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sm.part_t[w][threadIdx.x] = __int_as_float(0x7f800000);
  Pack pk = pack(t, feats, ray, sm);
  int j = next(0, pk.bound);
  int staged = -1;  // the step whose rows are in (or on their way to) the buffer
  while (j >= 0) {
    const int cid = order_row[j];
    if (staged != j) {
      wait_prefetch();  // a copy of a step that turned out dead may be in flight
      prefetch(g_cluster, cid, sm);
    }
    float q[USED];
    take(sm, q);
    staged = next(j + 1, pk.bound);  // live now; may die before its turn
    if (staged >= 0) prefetch(g_cluster, order_row[staged], sm);
    test_step<ANY_HIT>(q, sm, pk.count);
    merge<ANY_HIT>(sm, pk.pos, cid, t, idx);
    pk = pack(t, feats, ray, sm);
    j = next(j + 1, pk.bound);
  }
  wait_prefetch();
  best_t[ray] = t;
  best_i[ray] = idx;
}

// walk for clusters of any size: a step tests its cluster's `cluster`
// columns a chunk at a time, every chunk against the t at the step's start,
// and the owner takes the step's best after the last chunk (so the next
// step, another cluster, takes the ray only with a strictly smaller t).
template <bool ANY_HIT, typename Next>
__device__ __forceinline__ void walk_chunks(const int* __restrict__ order_row,
                                            const float* __restrict__ feats,
                                            const float* __restrict__ tmax,
                                            const float* __restrict__ g_cluster, int cluster,
                                            float* __restrict__ best_t,
                                            int* __restrict__ best_i, Smem& sm, Next next) {
  const int64_t ray = static_cast<int64_t>(blockIdx.x) * SUB + threadIdx.x;
  float t = tmax[ray];
  int idx = -1;
  if (!ANY_HIT)
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sm.part_t[w][threadIdx.x] = __int_as_float(0x7f800000);
  const int chunks = (cluster + CHUNK - 1) / CHUNK;
  Pack pk = pack(t, feats, ray, sm);
  int j = next(0, pk.bound);
  // the (step, chunk) whose rows are in (or on their way to) the buffer
  int staged = -1, staged_chunk = 0;
  while (j >= 0) {
    const int cid = order_row[j];
    float cur = __int_as_float(0x7f800000);  // the step's best so far (closest hit)
    int ci = -1;
    for (int c = 0; c < chunks; ++c) {
      const int width = min(CHUNK, cluster - c * CHUNK);
      if (staged != j || staged_chunk != c) {
        wait_prefetch();
        prefetch_chunk(g_cluster, cid, c, cluster, sm);
      }
      float q[USED];
      take_chunk(sm, q, width);
      if (c + 1 < chunks) {
        staged = j;
        staged_chunk = c + 1;
        prefetch_chunk(g_cluster, cid, c + 1, cluster, sm);
      } else {
        staged = next(j + 1, pk.bound);
        staged_chunk = 0;
        if (staged >= 0) prefetch_chunk(g_cluster, order_row[staged], 0, cluster, sm);
      }
      test_chunk<ANY_HIT>(q, sm, pk.count, width);
      fold<ANY_HIT>(sm, pk.pos, c * CHUNK, cur, ci);
    }
    if (pk.pos >= 0) {
      if (ANY_HIT) {
        if (sm.ray_ob[pk.pos].y < 0.0f) {
          t = -1.0f;
          idx = 0;
        }
      } else if (ci >= 0) {
        t = cur;
        idx = cid * cluster + ci;
      }
    }
    pk = pack(t, feats, ray, sm);
    j = next(j + 1, pk.bound);
  }
  wait_prefetch();
  best_t[ray] = t;
  best_i[ray] = idx;
}

// Any sub-block size: the sub-block's largest best-t bits over all its rays
// (in global memory), for every thread. The caller's barrier before it
// publishes the last merges.
__device__ __forceinline__ int bound_of(const float* t_g, int sub, Smem& sm) {
  int mx = INT32_MIN;
  for (int r = threadIdx.x; r < sub; r += LIST) mx = max(mx, __float_as_int(__ldcg(t_g + r)));
  mx = __reduce_max_sync(FULL, mx);
  if ((threadIdx.x & 31) == 0) sm.wmax[threadIdx.x >> 5] = mx;
  __syncthreads();
  int b = sm.wmax[0];
#pragma unroll
  for (int v = 1; v < WARPS; ++v) b = max(b, sm.wmax[v]);
  return b;
}

// Any sub-block size: put ray r of the sub-block, best t `t`, into `slot`.
__device__ __forceinline__ void put(const float* __restrict__ feats, int64_t ray, int r,
                                    float t, int slot, SmemG& sm) {
  const float4* f = reinterpret_cast<const float4*>(feats + ray * FEATS);
  const float4 dm = __ldg(f), mz = __ldg(f + 1), o1 = __ldg(f + 2);
  sm.s.ray_dm[slot] = dm;
  sm.s.ray_mo[slot] = make_float4(mz.x, mz.y, o1.x, o1.y);
  sm.s.ray_ob[slot] = make_float2(o1.z, t);
  sm.slot_ray[slot] = r;
}

// walk for any sub-block size (and any cluster size; point 6 above): rays
// in global memory, packed round by round into lists of at most LIST.
template <bool ANY_HIT, typename Next>
__device__ __forceinline__ void walk_general(const int* __restrict__ order_row,
                                             const float* __restrict__ feats,
                                             const float* __restrict__ tmax,
                                             const float* __restrict__ g_cluster, int cluster,
                                             int sub, float* __restrict__ best_t,
                                             int* __restrict__ best_i, SmemG& sm, Next next) {
  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * sub;
  float* t_g = best_t + base;
  int* i_g = best_i + base;
  for (int r = tid; r < sub; r += LIST) {
    t_g[r] = tmax[base + r];
    i_g[r] = -1;
  }
  if (!ANY_HIT)
#pragma unroll
    for (int v = 0; v < WARPS; ++v) sm.s.part_t[v][tid] = __int_as_float(0x7f800000);
  const int chunks = (cluster + CHUNK - 1) / CHUNK;
  const int rounds = (sub + LIST - 1) / LIST;
  __syncthreads();
  int bound = bound_of(t_g, sub, sm.s);
  int j = next(0, bound);
  // the (step, chunk) whose rows are in (or on their way to) the buffer
  int staged = -1, staged_chunk = 0;
  while (j >= 0) {
    const int cid = order_row[j];
    // test the list's `count` rays against every chunk of the step, then
    // fold each slot's result into its ray; `last`: no list follows in
    // this step, so the next step's first chunk may be fetched meanwhile
    auto test_list = [&](int count, bool last) {
      float cur = __int_as_float(0x7f800000);  // slot tid's best in the step (closest hit)
      int ci = -1;
      for (int c = 0; c < chunks; ++c) {
        const int width = min(CHUNK, cluster - c * CHUNK);
        if (staged != j || staged_chunk != c) {
          wait_prefetch();
          prefetch_chunk(g_cluster, cid, c, cluster, sm.s);
          staged = j;
          staged_chunk = c;
        }
        float q[USED];
        take_chunk(sm.s, q, width);
        if (c + 1 < chunks) {
          staged_chunk = c + 1;
          prefetch_chunk(g_cluster, cid, c + 1, cluster, sm.s);
        } else if (last) {
          staged = next(j + 1, bound);
          staged_chunk = 0;
          if (staged >= 0) prefetch_chunk(g_cluster, order_row[staged], 0, cluster, sm.s);
        }
        test_chunk<ANY_HIT>(q, sm.s, count, width);
        fold<ANY_HIT>(sm.s, tid < count ? tid : -1, c * CHUNK, cur, ci);
      }
      if (tid < count) {
        const int r = sm.slot_ray[tid];
        if (ANY_HIT) {
          if (sm.s.ray_ob[tid].y < 0.0f) {
            t_g[r] = -1.0f;
            i_g[r] = 0;
          }
        } else if (ci >= 0) {
          t_g[r] = cur;
          i_g[r] = cid * cluster + ci;
        }
      }
      __syncthreads();  // the slots are free again
    };
    int n = 0;  // entries in the open list
    for (int k = 0; k < rounds; ++k) {
      const int r = k * LIST + tid;
      const float t = r < sub ? __ldcg(t_g + r) : -1.0f;
      const bool live = t > 1e-4f;
      const unsigned mask = __ballot_sync(FULL, live);
      if (lane == 0) sm.rmask[k & 1][w] = mask;
      __syncthreads();
      int before = 0, count = 0;
#pragma unroll
      for (int v = 0; v < WARPS; ++v) {
        const int c = __popc(sm.rmask[k & 1][v]);
        before += v < w ? c : 0;
        count += c;
      }
      const int slot = n + before + __popc(mask & ((1u << lane) - 1u));
      if (live && slot < LIST) put(feats, base + r, r, t, slot, sm);
      if (n + count < LIST) {
        n += count;
        continue;
      }
      test_list(LIST, k + 1 == rounds && n + count == LIST);
      if (live && slot >= LIST) put(feats, base + r, r, t, slot - LIST, sm);
      n += count - LIST;
    }
    if (n > 0) test_list(n, true);
    __syncthreads();  // the merges, before the bound reads them
    bound = bound_of(t_g, sub, sm.s);
    j = next(j + 1, bound);
  }
  wait_prefetch();
}

}  // namespace sweep_dev
