// B1: work-list visibility raster for Hopper (sm_90a).
//
// Replaces sailor_tpu/raster/tile_raster.py `_raster_kernel_worklist` (with
// `_test_chunk` and `_merge_chunk`), called from `rasterize_worklist`. Its
// plain twin is `rasterize_worklist_plain` in raster/tile_raster.py.
//
// What it computes: per 64x128 screen tile, a walk of 32-row groups: the
// big-triangle list first, then the rows floor(start/32)*32 ..
// ceil(end/32)*32 of the sorted row table (`worklist_span`: the tile's
// work-list windows, with the rows of neighbouring tiles that share an
// aligned group). Each row is tested at each pixel centre: three edge
// functions >= -0.05 px, the AABB sliver clamp, reverse-Z plane depth z in
// (0, 1] and optional exclusive (zlo, zhi) bounds. Within a group the max z
// wins and equal z goes to the larger id; a later group takes a pixel only
// with strictly greater z. That is the TPU kernel's merge order and tie
// rule, kept exactly so the winner ids match on shared edges.
//
// Bound on the H100: bytes. The function must read the candidate rows' 17
// raster columns once and write depth and tid (8 bytes a pixel); its
// arithmetic is 16 float operations per (pixel, candidate) pair inside the
// candidate's AABB. chip_smoke.py computes both from the frame's rows.
//
// What held the first version back: one block per 8-row strip walked all
// of its tile's groups in order, and the walk is very uneven (the flagship
// frame's two heaviest tiles hold 24% of its rows, most tiles a group or
// two), so the card waited on a few long walks; each group was tested at
// all 1024 pixels of the strip for every row whose AABB touched the strip.
// Design:
//  1. Runs. A one-block plan kernel cuts each tile's walk into runs of at
//     most R contiguous groups (the big list opens run 0) and writes one
//     record a run (tile, groups, scratch slot: one dependent load before a
//     block starts); one block per (run, strip) walks only its run. R
//     starts at the caller's `run_groups` and doubles until the runs of the
//     tiles with more than one fit the caller's scratch (`slots`), so the
//     grid, (tiles + slots) x 8 blocks, is a bound the host knows; blocks
//     past the list exit. The runs of tiles with at least HEAVY runs are
//     listed first, then the other split tiles, so the longest walks start
//     in the first wave. The raster kernel is launched as a programmatic
//     dependent of the plan. Nothing is read back by the host.
//  2. In-order merge. A tile of one run writes its pixels. Otherwise each
//     run writes its partial (z, id) to scratch and counts itself in on an
//     atomic counter per (tile, strip); the last block to arrive merges
//     the tile's runs in run order with the across-group rule (a later run
//     takes a pixel only with strictly greater z), reading the partials 8
//     runs at a time. The runs are contiguous in walk order, so this is the
//     sequential walk bit for bit, ties on shared edges included.
//  3. Per-rectangle rejects, balanced over the warps. The strip is cut into
//     eight 16x8-pixel rectangles, one a warp. Lane r tests row r of a
//     staged group against the strip and then the warp's rectangle (exact,
//     as the per-pixel AABB clamp: a row whose AABB misses every pixel
//     centre of a rectangle rejects each of them) and one ballot gives the
//     rows the rectangle takes. Where the rectangles' counts are near even
//     each warp tests its own rows and merges in registers. A distant dense
//     object can put most of a group's rows in one rectangle (one warp
//     would walk nearly all of a run's rows while the others wait at each
//     group's barrier; chip_smoke.py prints the longest such walk); then
//     the (rectangle, row) pairs of all eight are split evenly over the
//     warps, their pixel results meet in shared memory as a 64-bit max of
//     (z bits, id), which is the in-group rule (max z, equal z to the
//     larger id), and the owner of a rectangle merges it into its pixels
//     with the across-group rule.
//  4. Staging. Only the 17 used columns of a row are copied, with cp.async
//     into a ring of 4 group slots (rows 16-byte aligned, read back as
//     float4 broadcasts); the next groups' copies are in flight while a
//     group is tested.
//  5. Four blocks an SM (64 registers, a few spilled) in place of three
//     without spills. tests/torch_kernel_variants.py times this choice, the
//     balancing rule of 3 and the value of R against their alternatives.
// Rounding: common.cuh (plane() is raster_common.cuh's, B7-B9's).
#include "raster_common.cuh"

namespace {

using namespace sailor_raster;

constexpr int RS = 20;           // staged row stride in floats: 17 used, 16-byte rows
constexpr int NBUF = 4;          // group slots of the cp.async ring
constexpr int RECT_W = 16;       // a warp's rectangle: 16 x STRIP_H pixels
constexpr int PIX = STRIP_H * TILE_W;  // pixels of a strip
constexpr int PLAN_THREADS = 256;
constexpr int HEAVY = 8;        // tiles of this many runs are listed first
constexpr int MERGE_RUNS = 8;   // partials loaded at once by the merging block
constexpr unsigned FULL = 0xffffffffu;

// Workspace (int32; raster/tile_raster.py `_worklist_workspace` sizes it):
//   runs  [tiles + slots][8]: per listed run (tile, first walk group, groups,
//         the tile's runs; scratch slot or -1, first window group, big-list
//         groups, run index), tile -1 past the list
//   count [tiles * STRIPS]: arrivals per (tile, strip)
// then the scratch: partial z (float) and id, [slots][STRIPS][PIX] each.
struct Work {
  int4* runs;
  int* count;
  float* part_z;
  int* part_id;
};

__device__ __forceinline__ Work carve(int* ws, int ntiles, int slots) {
  Work w;
  w.runs = reinterpret_cast<int4*>(ws);
  w.count = ws + 8 * (ntiles + slots);
  int* scratch = w.count + ntiles * STRIPS;
  w.part_z = reinterpret_cast<float*>(scratch);
  w.part_id = scratch + static_cast<int64_t>(slots) * STRIPS * PIX;
  return w;
}

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// Sum over the block (all threads get it); `red` holds one int a warp.
__device__ __forceinline__ int block_sum(int v, int* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  v = __reduce_add_sync(FULL, v);
  __syncthreads();
  if (lane == 0) red[w] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int i = 0; i < PLAN_THREADS / 32; ++i) s += red[i];
  return s;
}

// Exclusive prefix over the block in thread order; `red` one int a warp.
__device__ __forceinline__ int block_exclusive(int v, int* red) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(FULL, inc, d);
    if (lane >= d) inc += u;
  }
  __syncthreads();
  if (lane == 31) red[w] = inc;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int i = 0; i < PLAN_THREADS / 32; ++i) before += i < w ? red[i] : 0;
  return before + inc - v;
}

// One block: R, the run records, zeroed arrival counts. The raster kernel
// may start while it runs (programmatic dependent launch) and waits for
// its end before it reads a record.
__global__ void __launch_bounds__(PLAN_THREADS)
plan_kernel(const int* __restrict__ starts, const int* __restrict__ counts,
            const int* __restrict__ n_big_ptr, int nbig_rows, int ntiles,
            int run_groups, int slots, int* __restrict__ ws) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  __shared__ int red[PLAN_THREADS / 32];
  const Work w = carve(ws, ntiles, slots);
  const int nb = cdiv(min(max(*n_big_ptr, 0), nbig_rows), CHUNK);
  // each thread plans a contiguous span of tiles, so runs list in tile order
  const int per = cdiv(ntiles, PLAN_THREADS);
  const int t0 = min(ntiles, static_cast<int>(threadIdx.x) * per);
  const int t1 = min(ntiles, t0 + per);
  auto walk = [&](int t, int& g, int& first) {  // tile t's groups, first window group
    const int start = starts[t];
    first = start / CHUNK;
    g = nb + (start + counts[t] + CHUNK - 1) / CHUNK - first;
  };
  int R = run_groups;
  for (;;) {  // the runs of tiles with more than one must fit the scratch
    int need = 0;
    for (int t = t0; t < t1; ++t) {
      int g, first;
      walk(t, g, first);
      const int n = cdiv(g, R);
      need += n > 1 ? n : 0;
    }
    if (block_sum(need, red) <= slots) break;
    R *= 2;
  }
  // list order: tiles of at least HEAVY runs, then the other tiles of
  // several runs, then the tiles of one (the long walks start first); a
  // tile of several runs keeps its scratch slots at its list positions
  int per_class[3] = {0, 0, 0};
  for (int t = t0; t < t1; ++t) {
    int g, first;
    walk(t, g, first);
    const int n = max(1, cdiv(g, R));
    per_class[n >= HEAVY ? 0 : (n > 1 ? 1 : 2)] += n;
  }
  int at[3], base = 0;
  for (int c = 0; c < 3; ++c) {
    at[c] = base + block_exclusive(per_class[c], red);
    base += block_sum(per_class[c], red);
  }
  const int total = base;
  for (int t = t0; t < t1; ++t) {
    int g, first;
    walk(t, g, first);
    const int n = max(1, cdiv(g, R));
    const int c = n >= HEAVY ? 0 : (n > 1 ? 1 : 2);
    for (int r = 0; r < n; ++r) {
      w.runs[2 * (at[c] + r)] = make_int4(t, r * R, max(0, min(g - r * R, R)), n);
      w.runs[2 * (at[c] + r) + 1] = make_int4(n > 1 ? at[c] + r : -1, first, nb, r);
    }
    at[c] += n;
  }
  for (int i = total + threadIdx.x; i < ntiles + slots; i += PLAN_THREADS)
    w.runs[2 * i] = make_int4(-1, 0, 0, 0);
  for (int i = threadIdx.x; i < ntiles * STRIPS; i += PLAN_THREADS) w.count[i] = 0;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int WARPS = THREADS / 32;  // one 16x8 rectangle each
constexpr int PER_RECT = 4 * 32;     // pixels of a rectangle: 4 a lane

// A block's shared state of a group's test.
struct GroupTest {
  unsigned long long key[WARPS][PER_RECT];  // the group's best (z bits, id) a pixel, 0 none
  float zlo[WARPS][PER_RECT], zhi[WARPS][PER_RECT];  // the strip's z bounds
  unsigned mask[WARPS];                     // the rows each rectangle takes
};

// This thread's 4 pixels (in its warp's rectangle) and their running
// winners; the strip and rectangle bounds.
struct Pix {
  float py[4];
  float bz[4];
  int bid[4];
  int64_t base;  // output index of pixel 0; pixel k is base + k * 2 * W
  int x0;        // the tile's first column
  float rx_lo, rx_hi, ry_lo, ry_hi;  // the warp rectangle's outermost centres
  float sx_lo, sx_hi;                // the strip's (its rows are the rectangle's)
};

// The depth of staged row q (edges, plane, AABB) at pixel centre (px, py)
// if the row covers it there, else -1: three edges >= EPS, the AABB clamp
// (its x half `in_x` is the caller's), z in (0, 1] and inside (zl, zh).
__device__ __forceinline__ float cover(const float4& e0, const float4& e1, const float4& e2,
                                       const float4& bb, bool in_x, float px, float py,
                                       bool bounded, float zl, float zh) {
  bool ok = plane(e0.x, e0.y, e0.z, px, py) >= EPS && plane(e0.w, e1.x, e1.y, px, py) >= EPS &&
            plane(e1.z, e1.w, e2.x, px, py) >= EPS;
  ok = ok && in_x && py >= bb.z + EPS && py <= bb.w - EPS;
  const float z = plane(e2.y, e2.z, e2.w, px, py);
  ok = ok && z > 0.0f && z <= 1.0f;
  if (bounded) ok = ok && z > zl && z < zh;
  return ok ? z : -1.0f;
}

// Test the rows `m` of a staged group at this warp's own pixels and merge
// the group into its running winners.
__device__ __forceinline__ void test_own(const float* __restrict__ s, unsigned m, Pix& p,
                                         const GroupTest& g, bool bounded) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float px = static_cast<float>(p.x0 + warp * RECT_W + (lane & 15)) + 0.5f;
  float gz[4];
  int gid[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    gz[k] = -1.0f;
    gid[k] = -1;
  }
  while (m) {
    const int r = __ffs(m) - 1;
    m &= m - 1;
    const float* q = s + r * RS;
    const float4 e0 = ld4(q), e1 = ld4(q + 4), e2 = ld4(q + 8), bb = ld4(q + 12);
    const int id = static_cast<int>(q[16]);
    const bool in_x = px >= bb.x + EPS && px <= bb.y - EPS;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = lane + 32 * k;
      const float z = cover(e0, e1, e2, bb, in_x, px, p.py[k], bounded, g.zlo[warp][j],
                            g.zhi[warp][j]);
      if (z > gz[k] || (z == gz[k] && id > gid[k])) {
        gz[k] = z;
        gid[k] = id;
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (gz[k] > p.bz[k]) {
      p.bz[k] = gz[k];
      p.bid[k] = gid[k];
    }
  }
}

// Test one staged group (`nvalid` rows present) and merge it into the
// running winners. Each warp ballots the rows its rectangle takes. If one
// rectangle takes far more than the average, the (rectangle, row) pairs of
// all eight are split evenly over the warps, which keep each pixel's best
// (max z, equal z to the larger id: a 64-bit max of (z bits, id)) in shared
// memory, and the owner of a rectangle merges its pixels' group result, a
// later group only with strictly greater z; otherwise each warp tests its
// own rows (test_own).
__device__ __forceinline__ void test_group(const float* __restrict__ s, int nvalid, Pix& p,
                                           GroupTest& g, bool bounded) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bool cand = false;
  if (lane < nvalid) {
    const float* q = s + lane * RS;
    const float4 bb = ld4(q + 12);
    const bool strip_out = p.sx_hi < bb.x + EPS || p.sx_lo > bb.y - EPS ||
                           p.ry_hi < bb.z + EPS || p.ry_lo > bb.w - EPS;
    const bool rect_out = p.rx_hi < bb.x + EPS || p.rx_lo > bb.y - EPS;
    cand = static_cast<int>(q[16]) >= 0 && !strip_out && !rect_out;
  }
  const unsigned mine = __ballot_sync(FULL, cand);
  if (lane == 0) g.mask[warp] = mine;
#pragma unroll
  for (int k = 0; k < 4; ++k) g.key[warp][lane + 32 * k] = 0ull;
  __syncthreads();
  int total = 0, most = 0;
#pragma unroll
  for (int v = 0; v < WARPS; ++v) {
    const int c = __popc(g.mask[v]);
    total += c;
    most = max(most, c);
  }
  if (most * WARPS <= 2 * total + 4 * WARPS) {
    // near even: each warp tests its own rows, no second barrier
    test_own(s, mine, p, g, bounded);
    return;
  }
  int i = total * warp / WARPS;
  const int i1 = total * (warp + 1) / WARPS;
  int rw = 0;  // the rectangle of pair i, and its rows from pair i on
  unsigned mr = g.mask[0];
  if (i < i1) {
    int skip = i;
    while (skip >= __popc(mr)) {
      skip -= __popc(mr);
      mr = g.mask[++rw];
    }
    for (; skip > 0; --skip) mr &= mr - 1;
  }
  const int col = lane & 15;
  for (; i < i1; ++i) {
    while (mr == 0) mr = g.mask[++rw];
    const int r = __ffs(mr) - 1;
    mr &= mr - 1;
    const float* q = s + r * RS;
    const float4 e0 = ld4(q), e1 = ld4(q + 4), e2 = ld4(q + 8), bb = ld4(q + 12);
    const unsigned id = static_cast<unsigned>(static_cast<int>(q[16]));
    const float px = static_cast<float>(p.x0 + rw * RECT_W + col) + 0.5f;
    const bool in_x = px >= bb.x + EPS && px <= bb.y - EPS;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = lane + 32 * k;
      const float z = cover(e0, e1, e2, bb, in_x, px, p.py[k], bounded, g.zlo[rw][j], g.zhi[rw][j]);
      if (z > 0.0f)
        atomicMax(&g.key[rw][j], static_cast<unsigned long long>(__float_as_uint(z)) << 32 | id);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const unsigned long long key = g.key[warp][lane + 32 * k];
    const float z = __uint_as_float(static_cast<unsigned>(key >> 32));
    if (key != 0ull && z > p.bz[k]) {
      p.bz[k] = z;
      p.bid[k] = static_cast<int>(static_cast<unsigned>(key));
    }
  }
}

__global__ void __launch_bounds__(THREADS, 4)
raster_worklist_kernel(const float* __restrict__ rows, int ncols,
                       const float* __restrict__ big_rows, int nbig_rows,
                       const float* __restrict__ zlo, const float* __restrict__ zhi,
                       float* __restrict__ depth, int* __restrict__ tid, int tiles_x,
                       int ntiles, int slots, int* __restrict__ ws) {
  __shared__ __align__(16) float s[NBUF][CHUNK * RS];
  __shared__ GroupTest g;
  __shared__ int s_last;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the plan has ended
  const Work w = carve(ws, ntiles, slots);
  const int run = blockIdx.x / STRIPS, strip = blockIdx.x - run * STRIPS;
  const int4 rec0 = w.runs[2 * run], rec1 = w.runs[2 * run + 1];
  const int tile = rec0.x;
  if (tile < 0) return;  // past the listed runs
  const int g0 = rec0.y, n = rec0.z, nruns = rec0.w;
  const int slot = rec1.x, gw0 = rec1.y, nb = rec1.z, r = rec1.w;

  // this warp's rectangle and this lane's pixels: column warp*16 + lane%16,
  // strip rows lane/16 + 2k
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int ti = tile / tiles_x, tj = tile - ti * tiles_x;
  const int W = tiles_x * TILE_W;
  const int y0 = ti * TILE_H + strip * STRIP_H;
  Pix p;
  p.x0 = tj * TILE_W;
  p.rx_lo = static_cast<float>(tj * TILE_W + warp * RECT_W) + 0.5f;
  p.rx_hi = static_cast<float>(tj * TILE_W + warp * RECT_W + RECT_W - 1) + 0.5f;
  p.sx_lo = static_cast<float>(tj * TILE_W) + 0.5f;
  p.sx_hi = static_cast<float>(tj * TILE_W + TILE_W - 1) + 0.5f;
  p.ry_lo = static_cast<float>(y0) + 0.5f;
  p.ry_hi = static_cast<float>(y0 + STRIP_H - 1) + 0.5f;
  p.base = static_cast<int64_t>(y0 + (lane >> 4)) * W + tj * TILE_W + warp * RECT_W + (lane & 15);
  const bool bounded = zlo != nullptr;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    p.py[k] = static_cast<float>(y0 + (lane >> 4) + 2 * k) + 0.5f;
    p.bz[k] = 0.0f;
    p.bid[k] = -1;
    if (bounded) {  // read by whichever warp tests a row at the pixel
      g.zlo[warp][lane + 32 * k] = zlo[p.base + static_cast<int64_t>(2 * k) * W];
      g.zhi[warp][lane + 32 * k] = zhi[p.base + static_cast<int64_t>(2 * k) * W];
    }
  }

  // walk group i of the run: (source rows, rows present)
  auto group = [&](int i, int& nvalid) -> const float* {
    const int g = g0 + i;
    if (g < nb) {
      nvalid = min(CHUNK, nbig_rows - g * CHUNK);
      return big_rows + static_cast<int64_t>(g) * CHUNK * ncols;
    }
    nvalid = CHUNK;
    return rows + static_cast<int64_t>(gw0 + g - nb) * CHUNK * ncols;
  };
  auto stage_group = [&](int i) {
    int nvalid;
    const float* src = group(i, nvalid);
    float* dst = s[i % NBUF];
    for (int e = threadIdx.x; e < nvalid * NCOL; e += THREADS) {
      const int row = e / NCOL, c = e - row * NCOL;
      cp_async4(dst + row * RS + c, src + static_cast<int64_t>(row) * ncols + c);
    }
  };
  for (int i = 0; i < NBUF - 1; ++i) {
    if (i < n) stage_group(i);
    commit();
  }
  for (int i = 0; i < n; ++i) {
    wait_groups<NBUF - 2>();  // group i has landed (this thread's copies)
    __syncthreads();          // everyone's copies, and group i-1's slot is free
    if (i + NBUF - 1 < n) stage_group(i + NBUF - 1);
    commit();
    int nvalid;
    group(i, nvalid);
    test_group(s[i % NBUF], nvalid, p, g, bounded);
  }

  if (nruns == 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      depth[p.base + static_cast<int64_t>(2 * k) * W] = p.bz[k];
      tid[p.base + static_cast<int64_t>(2 * k) * W] = p.bid[k];
    }
    return;
  }
  // several runs: the partial to scratch, the last to arrive merges in order
  const int64_t strip_off = static_cast<int64_t>(strip) * PIX + threadIdx.x;
  const int64_t mine = static_cast<int64_t>(slot) * STRIPS * PIX + strip_off;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w.part_z[mine + k * THREADS] = p.bz[k];
    w.part_id[mine + k * THREADS] = p.bid[k];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&w.count[tile * STRIPS + strip], 1) == nruns - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  float mz[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int mid[4] = {-1, -1, -1, -1};
  for (int q0 = 0; q0 < nruns; q0 += MERGE_RUNS) {
    float z[MERGE_RUNS][4];
    int id[MERGE_RUNS][4];
#pragma unroll
    for (int j = 0; j < MERGE_RUNS; ++j) {
      const int64_t at = static_cast<int64_t>(slot - r + q0 + j) * STRIPS * PIX + strip_off;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        z[j][k] = q0 + j < nruns ? __ldcg(w.part_z + at + k * THREADS) : 0.0f;
        id[j][k] = q0 + j < nruns ? __ldcg(w.part_id + at + k * THREADS) : -1;
      }
    }
#pragma unroll
    for (int j = 0; j < MERGE_RUNS; ++j) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (z[j][k] > mz[k]) {  // a later run only with strictly greater z
          mz[k] = z[j][k];
          mid[k] = id[j][k];
        }
      }
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    depth[p.base + static_cast<int64_t>(2 * k) * W] = mz[k];
    tid[p.base + static_cast<int64_t>(2 * k) * W] = mid[k];
  }
}

}  // namespace

extern "C" int sailor_raster_worklist(const float* rows, int ncols,
                                      const float* big_rows, int nbig_rows,
                                      const int* n_big, const int* starts,
                                      const int* counts, const float* zlo,
                                      const float* zhi, float* depth, int* tid,
                                      int tiles_y, int tiles_x, int run_groups,
                                      int slots, int* ws, cudaStream_t stream) {
  const int ntiles = tiles_y * tiles_x;
  plan_kernel<<<1, PLAN_THREADS, 0, stream>>>(starts, counts, n_big, nbig_rows, ntiles,
                                              run_groups, slots, ws);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((ntiles + slots) * STRIPS);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, raster_worklist_kernel, rows, ncols,
                                             big_rows, nbig_rows, zlo, zhi, depth, tid,
                                             tiles_x, ntiles, slots, ws));
}
