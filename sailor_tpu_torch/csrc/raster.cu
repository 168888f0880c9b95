// The tile rasters for Hopper (sm_90a): B1 work-list raster, B7 grid-k
// stream raster in its VPU and MXU forms, B8 per-tile window raster and B9
// dense-bin raster, on one plan kernel and one raster kernel over runs of
// a tile's walk.
//
// Replaces sailor_tpu/raster/tile_raster.py `_raster_kernel_worklist` (with
// `_test_chunk` and `_merge_chunk`), called from `rasterize_worklist`;
// `_raster_kernel_stream` (with `_test_chunk`, `_merge_chunk`) and
// `_raster_kernel_stream_mxu` (with `_test_chunk_mxu`, `_merge_chunk_mxu`),
// called from `rasterize_stream`; `_raster_kernel_dma`, called from
// `rasterize_dma`; and `_raster_kernel`, called from `rasterize_tiles`.
// Their plain twins are `rasterize_worklist_plain`,
// `rasterize_stream_plain`, `rasterize_dma_plain` and
// `rasterize_tiles_plain` in raster/tile_raster.py.
//
// What it computes: per tile_h x 128 screen tile, a walk of G-row groups: the
// big-triangle list first, then a contiguous range of a row table. B1 (G =
// 32) walks floor(start/32)*32 .. ceil(end/32)*32 of the sorted rows
// (`worklist_span`: the tile's work-list windows, with the rows of
// neighbouring tiles that share an aligned group). B7 walks the whole
// `chunk`-row windows c0 .. c0 + max(spt, 1) - 1 (spt capped at kmax: rows
// past the cap are never tested, the caller counts them as overflow), in
// groups of 32 (VPU form) or 128 (MXU form); chunk is a multiple of G, so
// the windows are exactly whole groups. B8 is B1's walk over the rows
// w0*dchunk .. (w0 + nw)*dchunk (dchunk a multiple of 32, so whole groups;
// a tile with nw = 0 walks the big list alone). B9 has no big list and
// walks the slots t*cap .. t*cap + ceil(count/32)*32 of its tile's bin
// (cap a multiple of 32); slot s holds a triangle id, and its row is read
// by that id from a per-triangle table of 12 columns (edges, depth plane)
// or 16 (and the screen AABB); with 12 the AABB is staged as (-inf, +inf,
// -inf, +inf), which every strip, rectangle and pixel test passes: the
// reference's test without the clamp. A dead slot (-1) stages id -1 and
// reads no table row. Each row is tested at each pixel
// centre: three edge functions >= -0.05 px, the AABB sliver clamp,
// reverse-Z plane depth z in (0, 1] and optional exclusive (zlo, zhi)
// bounds. Within a group the max z wins and equal z goes to the larger id;
// a later group takes a pixel only with strictly greater z. That is the TPU
// kernels' merge order and tie rule, kept exactly so the winner ids match
// on shared edges. The MXU form, built for the TPU's matrix unit,
// evaluates each plane re-centred on the tile origin, c_t = fma(b, oy,
// fma(a, ox, c)), then fma(b, dy, a*dx) + c_t at the tile-local centre
// (dx, dy); it rounds unlike the VPU form on a few pixels.
//
// Bound on the H100: bytes. The function must read the candidate rows' 17
// raster columns once (B9: each walked slot's id and each live slot's 12
// or 16 columns) and write depth and tid (8 bytes a pixel); its arithmetic
// is 16 float operations per (pixel, candidate) pair inside the
// candidate's AABB (B9 without the AABB: every pixel of the tile).
// chip_smoke.py computes both from the frame's rows.
//
// What held the first versions back: one block per 8-row strip walked all
// of its tile's groups in order, and the walk is very uneven (the flagship
// frame's two heaviest tiles hold 24% of B1's rows, most tiles a group or
// two; B7 walks whole 256-row windows, mostly neighbours' rows; B9's later
// rounds live on a few tiles of up to 32 groups), so the card waited on a
// few long walks; each group was staged with no overlap and tested at all
// 1024 pixels of the strip for every row whose AABB touched the strip; B9
// also gathered every slot's row into a (tiles x cap, 16) table a pass.
// Design:
//  1. Runs. A one-block plan kernel cuts each tile's walk into runs of at
//     most R contiguous groups (the big list opens run 0) and writes one
//     record a run (tile, groups, scratch slot: one dependent load before a
//     block starts); one block per (run, strip) walks only its run. R
//     starts at the caller's `run_groups` and doubles until the runs of the
//     tiles with more than one fit the caller's scratch (`slots`), so the
//     grid, (tiles + slots) x strips blocks (strips = tile_h / 8), is a
//     bound the host knows; blocks
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
//     staged group (rows r, r + 32, r + 64, r + 96 of a 128-row group: a
//     ballot each) against the strip and then the warp's rectangle (exact,
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
//     into a ring of group slots (4 of 32 rows, 2 of 128; rows 16-byte
//     aligned, read back as float4 broadcasts); the next groups' copies are
//     in flight while a group is tested. B9 reads a group's 32 ids and
//     copies each live id's table row (48 or 64 bytes, 16 at a time) into
//     the ring: the same staged layout, with no gathered rows in memory.
//  5. Four blocks an SM (64 registers, a few spilled) in place of three
//     without spills. tests/torch_kernel_variants.py times this choice, the
//     balancing rule of 3 and the value of R against their alternatives.
//     B7's rows are mostly neighbours' that the rectangle tests reject, so
//     its runs are longer: 512 rows (tile_raster.STREAM_RUN_ROWS). On an
//     H100 80GB HBM3 at 700 W, on the flagship frame: B7 0.0995 / 0.0773 /
//     0.0840 ms at 256 / 512 / 1024 rows a run, B7-MXU 0.0932 / 0.0710 /
//     0.0764 ms. B8 walks whole 128-row windows: 256 rows a run
//     (tile_raster.DMA_RUN_ROWS; the plan doubles 128 to the same R = 8),
//     0.0524 / 0.0519 / 0.0579 ms at 128 / 256 / 512. B9's later rounds
//     live on a few tiles of up to 32 groups: 64 rows a run
//     (DENSE_RUN_ROWS), a dense frame's five clamped passes 0.1140 /
//     0.1107 / 0.1213 ms at 32 / 64 / 128 (without the clamp 0.3624 /
//     0.3819 / 0.4220).
//  6. The tile height is an argument (a multiple of 8): a block still owns
//     one 8-row strip, so its warps and shared memory do not depend on it;
//     the strips a tile (tile_h / 8) size the grid, the arrival counts and
//     the partials' scratch. The default 64-row tile has an instantiation
//     of its own with the count fixed (see raster_runs_kernel).
// Rounding: common.cuh; plane() is raster_common.cuh's (B9's plane is the
// same fma(a, px, b*py) + c).
#include "raster_common.cuh"

namespace {

using namespace sailor_raster;

constexpr int RS = 20;           // staged row stride in floats: 17 used, 16-byte rows
constexpr int RECT_W = 16;       // a warp's rectangle: 16 x STRIP_H pixels
constexpr int PIX = STRIP_H * TILE_W;  // pixels of a strip
constexpr int PLAN_THREADS = 256;
constexpr int HEAVY = 8;        // tiles of this many runs are listed first
constexpr int MERGE_RUNS = 8;   // partials loaded at once by the merging block
constexpr int DEFAULT_STRIPS = 64 / STRIP_H;  // the strips of the default tile height
constexpr unsigned FULL = 0xffffffffu;

// Workspace (int32; raster/tile_raster.py `_worklist_workspace` sizes it):
//   runs  [tiles + slots][8]: per listed run (tile, first walk group, groups,
//         the tile's runs; scratch slot or -1, first row group, big-list
//         groups, run index), tile -1 past the list
//   count [tiles * strips]: arrivals per (tile, strip)
// then the scratch: partial z (float) and id, [slots][strips][PIX] each
// (strips = tile_h / STRIP_H).
struct Work {
  int4* runs;
  int* count;
  float* part_z;
  int* part_id;
};

__device__ __forceinline__ Work carve(int* ws, int ntiles, int slots, int strips) {
  Work w;
  w.runs = reinterpret_cast<int4*>(ws);
  w.count = ws + 8 * (ntiles + slots);
  int* scratch = w.count + ntiles * strips;
  w.part_z = reinterpret_cast<float*>(scratch);
  w.part_id = scratch + static_cast<int64_t>(slots) * strips * PIX;
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

// One block: R, the run records, zeroed arrival counts. A tile's rows are
// starts[t] .. starts[t] + counts[t] (win = 0: B1, B8, B9) or the windows
// starts[t] .. starts[t] + max(counts[t], 1) - 1 of `win` rows (B7's c0 and
// spt), walked in groups of `group` rows after the *n_big_ptr big rows (none
// when n_big_ptr is null). The raster kernel may start
// while it runs (programmatic dependent launch) and waits for its end
// before it reads a record.
__global__ void __launch_bounds__(PLAN_THREADS)
plan_kernel(const int* __restrict__ starts, const int* __restrict__ counts,
            const int* __restrict__ n_big_ptr, int nbig_rows, int ntiles, int group,
            int win, int run_groups, int slots, int strips, int* __restrict__ ws) {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  __shared__ int red[PLAN_THREADS / 32];
  const Work w = carve(ws, ntiles, slots, strips);
  const int nb = n_big_ptr ? cdiv(min(max(*n_big_ptr, 0), nbig_rows), group) : 0;
  // each thread plans a contiguous span of tiles, so runs list in tile order
  const int per = cdiv(ntiles, PLAN_THREADS);
  const int t0 = min(ntiles, static_cast<int>(threadIdx.x) * per);
  const int t1 = min(ntiles, t0 + per);
  auto walk = [&](int t, int& g, int& first) {  // tile t's groups, first row group
    const int start = win ? starts[t] * win : starts[t];
    const int end = win ? start + max(counts[t], 1) * win : start + counts[t];
    first = start / group;
    g = nb + cdiv(end, group) - first;
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
  for (int i = threadIdx.x; i < ntiles * strips; i += PLAN_THREADS) w.count[i] = 0;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// B9's AABB without the clamp: (-inf, +inf, -inf, +inf) passes every test.
__device__ __forceinline__ float4 open_aabb() {
  const float inf = __int_as_float(0x7f800000);
  return make_float4(-inf, inf, -inf, inf);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
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

// A block's shared state of a group's test (NW ballot words a rectangle:
// G / 32).
template <int NW>
struct GroupTest {
  unsigned long long key[WARPS][PER_RECT];  // the group's best (z bits, id) a pixel, 0 none
  float zlo[WARPS][PER_RECT], zhi[WARPS][PER_RECT];  // the strip's z bounds
  unsigned mask[WARPS][NW];                 // the rows each rectangle takes
};

// This thread's 4 pixels (in its warp's rectangle) and their running
// winners; the strip and rectangle bounds.
struct Pix {
  float py[4];
  float dy[4];   // tile-local (the MXU form's)
  float bz[4];
  int bid[4];
  int64_t base;  // output index of pixel 0; pixel k is base + k * 2 * W
  int x0;        // the tile's first column
  float ox, oy;  // the tile origin
  float rx_lo, rx_hi, ry_lo, ry_hi;  // the warp rectangle's outermost centres
  float sx_lo, sx_hi;                // the strip's (its rows are the rectangle's)
};

// A staged row's planes (a, b, c) x 4 (three edges, depth) in e0..e2, its
// AABB in bb, its id. The MXU form replaces each c by c_t, the plane's
// value at the tile origin.
struct Row {
  float4 e0, e1, e2, bb;
  int id;
};

template <bool MXU>
__device__ __forceinline__ Row load_row(const float* q, const Pix& p) {
  Row r;
  r.e0 = ld4(q);
  r.e1 = ld4(q + 4);
  r.e2 = ld4(q + 8);
  r.bb = ld4(q + 12);
  r.id = static_cast<int>(q[16]);
  if (MXU) {
    r.e0.z = __fmaf_rn(r.e0.y, p.oy, __fmaf_rn(r.e0.x, p.ox, r.e0.z));
    r.e1.y = __fmaf_rn(r.e1.x, p.oy, __fmaf_rn(r.e0.w, p.ox, r.e1.y));
    r.e2.x = __fmaf_rn(r.e1.w, p.oy, __fmaf_rn(r.e1.z, p.ox, r.e2.x));
    r.e2.w = __fmaf_rn(r.e2.z, p.oy, __fmaf_rn(r.e2.y, p.ox, r.e2.w));
  }
  return r;
}

// a*x + b*y + c: the VPU form at the pixel centre (x, y) = (px, py), as
// fma(a, px, b*py) + c; the MXU form at the tile-local centre (dx, dy), as
// fma(b, dy, a*dx) + c_t.
template <bool MXU>
__device__ __forceinline__ float eval(float a, float b, float c, float x, float y) {
  return MXU ? __fadd_rn(__fmaf_rn(b, y, __fmul_rn(a, x)), c) : plane(a, b, c, x, y);
}

// The depth of row r at the pixel whose plane coordinates are (x, y) and
// whose centre row is py, if the row covers it there, else -1: three edges
// >= EPS, the AABB clamp (its x half `in_x` is the caller's), z in (0, 1]
// and inside (zl, zh).
template <bool MXU>
__device__ __forceinline__ float cover(const Row& r, bool in_x, float x, float y, float py,
                                       bool bounded, float zl, float zh) {
  bool ok = eval<MXU>(r.e0.x, r.e0.y, r.e0.z, x, y) >= EPS &&
            eval<MXU>(r.e0.w, r.e1.x, r.e1.y, x, y) >= EPS &&
            eval<MXU>(r.e1.z, r.e1.w, r.e2.x, x, y) >= EPS;
  ok = ok && in_x && py >= r.bb.z + EPS && py <= r.bb.w - EPS;
  const float z = eval<MXU>(r.e2.y, r.e2.z, r.e2.w, x, y);
  ok = ok && z > 0.0f && z <= 1.0f;
  if (bounded) ok = ok && z > zl && z < zh;
  return ok ? z : -1.0f;
}

// Test the rows `mine` of a staged group at this warp's own pixels and
// merge the group into its running winners.
template <int NW, bool MXU>
__device__ __forceinline__ void test_own(const float* __restrict__ s, const unsigned (&mine)[NW],
                                         Pix& p, const GroupTest<NW>& g, bool bounded) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float dx = static_cast<float>(warp * RECT_W + (lane & 15)) + 0.5f;
  const float px = static_cast<float>(p.x0) + dx;
  float gz[4];
  int gid[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    gz[k] = -1.0f;
    gid[k] = -1;
  }
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    unsigned m = mine[w];
    while (m) {
      const int r = 32 * w + __ffs(m) - 1;
      m &= m - 1;
      const Row row = load_row<MXU>(s + r * RS, p);
      const bool in_x = px >= row.bb.x + EPS && px <= row.bb.y - EPS;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = lane + 32 * k;
        const float z = cover<MXU>(row, in_x, MXU ? dx : px, MXU ? p.dy[k] : p.py[k], p.py[k],
                                   bounded, g.zlo[warp][j], g.zhi[warp][j]);
        if (z > gz[k] || (z == gz[k] && row.id > gid[k])) {
          gz[k] = z;
          gid[k] = row.id;
        }
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

// Test one staged group (`nvalid` rows present, G = 32 * NW) and merge it
// into the running winners. Each warp ballots the rows its rectangle takes
// (lane r: rows r, r + 32, ...). If one rectangle takes far more than the
// average, the (rectangle, row) pairs of all eight are split evenly over
// the warps, which keep each pixel's best (max z, equal z to the larger
// id: a 64-bit max of (z bits, id)) in shared memory, and the owner of a
// rectangle merges its pixels' group result, a later group only with
// strictly greater z; otherwise each warp tests its own rows (test_own).
template <int NW, bool MXU>
__device__ __forceinline__ void test_group(const float* __restrict__ s, int nvalid, Pix& p,
                                           GroupTest<NW>& g, bool bounded) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned mine[NW];
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    const int r = lane + 32 * w;
    bool cand = false;
    if (r < nvalid) {
      const float* q = s + r * RS;
      const float4 bb = ld4(q + 12);
      const bool strip_out = p.sx_hi < bb.x + EPS || p.sx_lo > bb.y - EPS ||
                             p.ry_hi < bb.z + EPS || p.ry_lo > bb.w - EPS;
      const bool rect_out = p.rx_hi < bb.x + EPS || p.rx_lo > bb.y - EPS;
      cand = static_cast<int>(q[16]) >= 0 && !strip_out && !rect_out;
    }
    mine[w] = __ballot_sync(FULL, cand);
    if (lane == 0) g.mask[warp][w] = mine[w];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) g.key[warp][lane + 32 * k] = 0ull;
  __syncthreads();
  int total = 0, most = 0;
#pragma unroll
  for (int v = 0; v < WARPS; ++v) {
    int c = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) c += __popc(g.mask[v][w]);
    total += c;
    most = max(most, c);
  }
  if (most * WARPS <= 2 * total + 4 * WARPS) {
    // near even: each warp tests its own rows, no second barrier
    test_own<NW, MXU>(s, mine, p, g, bounded);
    return;
  }
  int i = total * warp / WARPS;
  const int i1 = total * (warp + 1) / WARPS;
  int rw = 0, wd = 0;  // the rectangle and ballot word of pair i, and its rows from pair i on
  unsigned mr = g.mask[0][0];
  auto next_word = [&]() {
    if (++wd == NW) {
      wd = 0;
      ++rw;
    }
    mr = g.mask[rw][wd];
  };
  if (i < i1) {
    int skip = i;
    while (skip >= __popc(mr)) {
      skip -= __popc(mr);
      next_word();
    }
    for (; skip > 0; --skip) mr &= mr - 1;
  }
  const int col = lane & 15;
  for (; i < i1; ++i) {
    while (mr == 0) next_word();
    const int r = 32 * wd + __ffs(mr) - 1;
    mr &= mr - 1;
    const Row row = load_row<MXU>(s + r * RS, p);
    const float dx = static_cast<float>(rw * RECT_W + col) + 0.5f;
    const float px = static_cast<float>(p.x0) + dx;
    const bool in_x = px >= row.bb.x + EPS && px <= row.bb.y - EPS;
    const unsigned id = static_cast<unsigned>(row.id);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int j = lane + 32 * k;
      const float z = cover<MXU>(row, in_x, MXU ? dx : px, MXU ? p.dy[k] : p.py[k], p.py[k],
                                 bounded, g.zlo[rw][j], g.zhi[rw][j]);
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

// One block per (listed run, strip): G-row groups, MXU: B7's MXU plane form,
// BY_ID: B9's rows, row ids[s] of the (rows, ncols) triangle table for slot
// s of the walk (no big list). STRIPS: the strips of a tile fixed at
// compile time (DEFAULT_STRIPS, the default 64-row tile), or 0 for
// tile_h / STRIP_H at run time, which ptxas compiles with more spills: on
// an H100 80GB HBM3 at 700 W, at 64 rows, the run-time count alone ran B1,
// B7-MXU, B8 and B9 1.4-3.2% slower than a kernel with the height fixed
// (tests/torch_compare_checkouts.py --raster, three calls), so the default
// height keeps its own instantiation; both are held to the same twins.
// tile_h is the last parameter: in the middle of the list ptxas spilled
// more still (B1 224 bytes of stores against 164 with it last) and B1, B8
// and B9 ran 3-4% slower.
template <int G, bool MXU, bool BY_ID, int STRIPS>
__global__ void __launch_bounds__(THREADS, 4)
raster_runs_kernel(const float* __restrict__ rows, int ncols,
                   const float* __restrict__ big_rows, int nbig_rows,
                   const int* __restrict__ ids,
                   const float* __restrict__ zlo, const float* __restrict__ zhi,
                   float* __restrict__ depth, int* __restrict__ tid, int tiles_x,
                   int ntiles, int slots, int* __restrict__ ws, int tile_h) {
  constexpr int NW = G / CHUNK;
  constexpr int NBUF = G == CHUNK ? 4 : 2;  // group slots of the cp.async ring
  __shared__ __align__(16) float s[NBUF][G * RS];
  __shared__ GroupTest<NW> g;
  __shared__ int s_last;
  asm volatile("griddepcontrol.wait;" ::: "memory");  // the plan has ended
  const int strips = STRIPS ? STRIPS : tile_h / STRIP_H;
  const Work w = carve(ws, ntiles, slots, strips);
  const int run = blockIdx.x / strips, strip = blockIdx.x - run * strips;
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
  const int y0 = (ti * strips + strip) * STRIP_H;
  Pix p;
  p.x0 = tj * TILE_W;
  p.rx_lo = static_cast<float>(tj * TILE_W + warp * RECT_W) + 0.5f;
  p.rx_hi = static_cast<float>(tj * TILE_W + warp * RECT_W + RECT_W - 1) + 0.5f;
  p.sx_lo = static_cast<float>(tj * TILE_W) + 0.5f;
  p.sx_hi = static_cast<float>(tj * TILE_W + TILE_W - 1) + 0.5f;
  p.ry_lo = static_cast<float>(y0) + 0.5f;
  p.ry_hi = static_cast<float>(y0 + STRIP_H - 1) + 0.5f;
  p.ox = static_cast<float>(tj * TILE_W);
  p.oy = static_cast<float>(ti * strips * STRIP_H);
  p.base = static_cast<int64_t>(y0 + (lane >> 4)) * W + tj * TILE_W + warp * RECT_W + (lane & 15);
  const bool bounded = zlo != nullptr;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    p.py[k] = static_cast<float>(y0 + (lane >> 4) + 2 * k) + 0.5f;
    p.dy[k] = static_cast<float>(strip * STRIP_H + (lane >> 4) + 2 * k) + 0.5f;
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
      nvalid = min(G, nbig_rows - g * G);
      return big_rows + static_cast<int64_t>(g) * G * ncols;
    }
    nvalid = G;
    return rows + static_cast<int64_t>(gw0 + g - nb) * G * ncols;
  };
  auto stage_group = [&](int i) {
    float* dst = s[i % NBUF];
    if (BY_ID) {  // four threads a slot: 16 bytes of its row each, or the open AABB
      const int64_t slot0 = static_cast<int64_t>(gw0 + g0 + i) * G;
      for (int e = threadIdx.x; e < G * 4; e += THREADS) {
        const int row = e >> 2, q = e & 3;
        const int id = ids[slot0 + row];
        float* d = dst + row * RS;
        if (id >= 0 && 4 * q < ncols)
          cp_async16(d + 4 * q, rows + static_cast<int64_t>(id) * ncols + 4 * q);
        else if (id >= 0 && q == 3)
          *reinterpret_cast<float4*>(d + 12) = open_aabb();
        if (q == 0) d[16] = static_cast<float>(id);
      }
      return;
    }
    int nvalid;
    const float* src = group(i, nvalid);
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
    test_group<NW, MXU>(s[i % NBUF], nvalid, p, g, bounded);
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
  const int64_t mine = static_cast<int64_t>(slot) * strips * PIX + strip_off;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    w.part_z[mine + k * THREADS] = p.bz[k];
    w.part_id[mine + k * THREADS] = p.bid[k];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(&w.count[tile * strips + strip], 1) == nruns - 1;
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
      const int64_t at = static_cast<int64_t>(slot - r + q0 + j) * strips * PIX + strip_off;
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

template <int G, bool MXU, bool BY_ID = false>
int launch_runs(const float* rows, int ncols, const float* big_rows, int nbig_rows,
                const int* n_big, const int* starts, const int* counts, int win,
                const float* zlo, const float* zhi, float* depth, int* tid, int tiles_y,
                int tiles_x, int tile_h, int run_groups, int slots, int* ws,
                cudaStream_t stream, const int* ids = nullptr) {
  if (tile_h < STRIP_H || tile_h % STRIP_H) return static_cast<int>(cudaErrorInvalidValue);
  const int ntiles = tiles_y * tiles_x;
  const int strips = tile_h / STRIP_H;
  plan_kernel<<<1, PLAN_THREADS, 0, stream>>>(starts, counts, n_big, nbig_rows, ntiles, G, win,
                                              run_groups, slots, strips, ws);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((ntiles + slots) * strips);
  cfg.blockDim = dim3(THREADS);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  auto kernel = strips == DEFAULT_STRIPS ? raster_runs_kernel<G, MXU, BY_ID, DEFAULT_STRIPS>
                                         : raster_runs_kernel<G, MXU, BY_ID, 0>;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, rows, ncols, big_rows, nbig_rows,
                                             ids, zlo, zhi, depth, tid, tiles_x, ntiles,
                                             slots, ws, tile_h));
}

}  // namespace

// B1: tile t walks rows starts[t] .. starts[t] + counts[t], widened to
// whole 32-row groups. B8 calls it with starts w0 * dchunk and counts nw *
// dchunk.
extern "C" int sailor_raster_worklist(const float* rows, int ncols,
                                      const float* big_rows, int nbig_rows,
                                      const int* n_big, const int* starts,
                                      const int* counts, const float* zlo,
                                      const float* zhi, float* depth, int* tid,
                                      int tiles_y, int tiles_x, int tile_h, int run_groups,
                                      int slots, int* ws, cudaStream_t stream) {
  return launch_runs<CHUNK, false>(rows, ncols, big_rows, nbig_rows, n_big, starts, counts, 0,
                                   zlo, zhi, depth, tid, tiles_y, tiles_x, tile_h, run_groups,
                                   slots, ws, stream);
}

// B7: tile t walks the windows c0[t] .. c0[t] + max(spt[t], 1) - 1 of
// `chunk` rows, in groups of 32 (VPU form) or 128 (MXU form).
extern "C" int sailor_raster_stream(const float* rows, int ncols,
                                    const float* big_rows, int nbig_rows,
                                    const int* n_big, const int* c0, const int* spt,
                                    const float* zlo, const float* zhi, float* depth,
                                    int* tid, int tiles_y, int tiles_x, int tile_h, int chunk,
                                    int mxu, int run_groups, int slots, int* ws,
                                    cudaStream_t stream) {
  if (chunk % (mxu ? CHUNK_MXU : CHUNK)) return static_cast<int>(cudaErrorInvalidValue);
  if (mxu)
    return launch_runs<CHUNK_MXU, true>(rows, ncols, big_rows, nbig_rows, n_big, c0, spt,
                                        chunk, zlo, zhi, depth, tid, tiles_y, tiles_x, tile_h,
                                        run_groups, slots, ws, stream);
  return launch_runs<CHUNK, false>(rows, ncols, big_rows, nbig_rows, n_big, c0, spt, chunk,
                                   zlo, zhi, depth, tid, tiles_y, tiles_x, tile_h, run_groups,
                                   slots, ws, stream);
}

// B9: tile t walks the slots starts[t] .. starts[t] + counts[t] (its bin:
// starts[t] = t * cap, cap a multiple of 32), widened to whole 32-row
// groups; slot s stages row ids[s] of the (rows, width) triangle table,
// width 12 (the AABB staged open: no clamp) or 16 (with the AABB clamp).
// The table must be 16-byte aligned.
extern "C" int sailor_raster_dense(const float* table, int width, const int* ids,
                                   const int* starts, const int* counts, const float* zlo,
                                   const float* zhi, float* depth, int* tid, int tiles_y,
                                   int tiles_x, int tile_h, int run_groups, int slots, int* ws,
                                   cudaStream_t stream) {
  if ((width != 12 && width != 16) || reinterpret_cast<uintptr_t>(table) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_runs<CHUNK, false, true>(table, width, nullptr, 0, nullptr, starts, counts, 0,
                                         zlo, zhi, depth, tid, tiles_y, tiles_x, tile_h,
                                         run_groups, slots, ws, stream, ids);
}
