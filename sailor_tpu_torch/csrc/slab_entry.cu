// B4: per-sub-block cluster slab entry, the rays' features and the sweep's
// visit tables, in one launch, for Hopper (sm_90a).
//
// Replaces sailor_tpu/raytracing/sweep.py `_slab_entry_kernel`, called from
// `_slab_entry_sub` in `intersect`, together with the XLA ops around it
// there (the feature rows before it; the block minimum, the stable argsort
// and the gathers after it). Its plain twin is `visit_tables_plain` in
// raytracing/sweep.py (the feature rows, `slab_entry_plain`, then
// `tables_from_entries`).
//
// Each ray's feature row, [d, m, 0, 0 | o, 1, d, 0] with m = o x d in plain
// float32 (m_k = o_{k+1} d_{k+2} - o_{k+2} d_{k+1}, each product rounded:
// core.math3d.cross32), is written for the sweeps.
// What it computes: for each sub-block of `sub` rays and each cluster AABB, the
// least entry distance of the sub-block's rays into the box (+inf where no
// ray pierces it). Per ray and axis, inv = |d| > 1e-12 ? 1/d : 1e12 and
// oinv = o * inv; a = inv * lo - oinv, b = inv * hi - oinv; the ray enters
// at tn = max over axes of min(a, b), leaves at tf = min of max(a, b),
// pierces the box iff tn <= min(tf, tmax) and tf > 0, and enters at
// max(tn, 0). Every min and max is a select on one comparison, as in the
// twin, so kernel and twin agree bit for bit (-fmad=false, exact division).
// Per ray block (nsub sub-blocks), with e_blk the minimum over them, it
// writes: order, the stable ascending argsort of e_blk; blk_bits, e_blk in
// that order; e_bits, each sub-block's entries (B4's own function) in that
// order; nlive, the finite block entries. Entries are written as int32
// float bits.
//
// Bound on the H100: the rays' origin, direction and tmax (28 B) read once,
// their feature rows (64 B) and the tables written once; about 30 float
// operations per (ray, cluster) pair,
// counted at the FMA rate although none of them is a fused multiply-add (so
// the instruction-rate floor is about twice that bound). chip_smoke.py reports
// the larger.
//
// Design: one block per ray block, 512 threads, RPT = 4 rays a thread at a
// time: warp w takes a run of 128 consecutive rays of each 2,048-ray group,
// lane l its rays l, l + 32, l + 64 and l + 96 (loads coalesce); a block of
// more than 2,048 rays takes its groups one after another, every group
// against every cluster. The boxes are staged in shared memory as two
// 16-byte rows each and every box read (a broadcast) serves the thread's
// RPT independent rays. Entries are +0, a positive finite or +inf, so their
// bits order like the floats and any order of min gives the same bits: where
// a warp's run lies in one sub-block (always at the default 2048/256) a
// thread takes the integer min of its rays, one warp reduce (redux) a
// cluster, and one shared atomicMin a warp and cluster merges a sub-block's
// warps, in a loop of its own (the rows' state below is not live there).
// Elsewhere each 32-ray row of the run is merged
// alone: by one redux where it lies in one sub-block, else by a segmented
// reduce (five shuffles down, each taken only from a lane of the same
// sub-block) whose segment heads do the atomicMin. The block then builds the
// tables in shared memory: the visit order by rank, rank(c) = #{c': e[c'] <
// e[c]} + #{c' < c: e[c'] = e[c]}, which is the stable argsort here (no NaN,
// and zero only as +0), with no sort and no host synchronisation.
// tests/torch_kernel_variants.py times RPT = 2 (1024 threads) against 4
// (512). The fixed-size kernel this one grew from was also timed with the
// other block layout (one block per sub-block, the last of a ray block's 8
// to arrive building the tables from the others' entries in scratch): on an
// H100 80GB HBM3 at 700 W, on the bench tracer scene's bounce-1 rays,
// 0.0501 ms as built, 0.0531 with 2 rays a thread, 0.0583 and 0.0576
// (2 rays) a block a sub-block.
// One instantiation serves every ray block and sub-block: at the default
// it took 0.0502-0.0506 ms on those rays against 0.0499-0.0507 for the
// fixed-size kernel of before, in turns (tests/torch_sweep_variants.py).
//
// Any ray block and sub-block (sub >= 1 dividing the ray block, nsub =
// ray block / sub, both arguments) and any cluster count: the tables take
// 32 + 4 * (nsub + 1) B a cluster (68 B at the default), so where the caller
// gives no scratch they live in dynamic shared memory (sweep.py's
// slab_smem_clusters is the one place that decides: up to 204 KB of the
// 227 KB a block may have, 3,072 clusters at the default), and where it
// gives one each block keeps its entries in its own rows of that global
// scratch ((n_blocks, nsub + 1, nc) ints; GLOBAL) and reads each box from
// cl_min and cl_max (a broadcast through L1). The arithmetic, the merge and
// the rank are the same, so the tables are bit-equal either way. The path
// tracer's routing rule (4 * (nsub + 1) B a (ray block, cluster) within
// 1 MiB) admits up to 29,127 block-clusters at the default: one ray block
// over 29,127 clusters ranks them in about 850M comparisons on one SM,
// some milliseconds.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int FEATS = 16;
constexpr int RPT = 4;          // rays a thread at a time
constexpr int THREADS = 512;
constexpr int RUN = 32 * RPT;   // a warp's consecutive rays in a group
constexpr int GROUP = THREADS * RPT;
constexpr int INF_BITS = 0x7f800000;
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t SMEM_LIMIT = 227 * 1024;  // dynamic shared memory a block may have

// Dynamic shared memory: box[2 * nc] (float4), e[nsub * nc], eb[nc] (int).
__host__ __device__ constexpr size_t smem_bytes(int nc, int nsub) {
  return static_cast<size_t>(nc) * (2 * sizeof(float4) + (nsub + 1) * sizeof(int));
}

// GLOBAL: the entries in this block's rows of `tables` and the boxes read
// from cl_min/cl_max; else all of it in dynamic shared memory.
template <bool GLOBAL>
__global__ void __launch_bounds__(THREADS)
slab_tables_kernel(const float* __restrict__ orig, const float* __restrict__ dir,
                   const float* __restrict__ tmax, const float* __restrict__ cl_min,
                   const float* __restrict__ cl_max, float* __restrict__ feats,
                   int* __restrict__ e_bits, int* __restrict__ order,
                   int* __restrict__ blk_bits, int* __restrict__ nlive,
                   int* __restrict__ tables, int nc, int sub, int nsub) {
  const int rb = sub * nsub;  // rays a ray block
  extern __shared__ __align__(16) unsigned char smem[];
  float4* box = reinterpret_cast<float4*>(smem);
  int* e = GLOBAL ? tables + static_cast<int64_t>(blockIdx.x) * (nsub + 1) * nc
                  : reinterpret_cast<int*>(box + 2 * nc);  // [nsub][nc]
  int* eb = e + static_cast<int64_t>(nsub) * nc;
  __shared__ int s_live;
  const int tid = threadIdx.x, lane = tid & 31;
  if (!GLOBAL)
    for (int i = tid; i < nc; i += THREADS) {
      box[2 * i] =
          make_float4(cl_min[3 * i], cl_min[3 * i + 1], cl_min[3 * i + 2], cl_max[3 * i]);
      box[2 * i + 1] = make_float4(cl_max[3 * i + 1], cl_max[3 * i + 2], 0.0f, 0.0f);
    }
  for (int64_t i = tid; i < static_cast<int64_t>(nsub) * nc; i += THREADS) e[i] = INF_BITS;
  if (tid == 0) s_live = 0;
  const int b = blockIdx.x;

  for (int g0 = 0; g0 < rb; g0 += GROUP) {
    // this thread's rays: g0 + first + j * 32 + lane, j < RPT (within the
    // ray block; a ray past its end takes no part)
    const int first = g0 + (tid >> 5) * RUN;
    float inv[RPT][3], oinv[RPT][3], tm[RPT];
    bool valid[RPT];
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = first + j * 32 + lane;
      valid[j] = r < rb;
      float dk[3], ok[3];
      const int64_t ray = static_cast<int64_t>(b) * rb + r;
      if (!valid[j]) {
#pragma unroll
        for (int k = 0; k < 3; ++k) inv[j][k] = oinv[j][k] = 0.0f;
        tm[j] = 0.0f;
        continue;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        dk[k] = dir[3 * ray + k];
        ok[k] = orig[3 * ray + k];
      }
      float m[3];
#pragma unroll
      for (int k = 0; k < 3; ++k)
        m[k] = __fsub_rn(__fmul_rn(ok[(k + 1) % 3], dk[(k + 2) % 3]),
                         __fmul_rn(ok[(k + 2) % 3], dk[(k + 1) % 3]));
      float4* row = reinterpret_cast<float4*>(feats + ray * FEATS);
      row[0] = make_float4(dk[0], dk[1], dk[2], m[0]);
      row[1] = make_float4(m[1], m[2], 0.0f, 0.0f);
      row[2] = make_float4(ok[0], ok[1], ok[2], 1.0f);
      row[3] = make_float4(dk[0], dk[1], dk[2], 0.0f);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        inv[j][k] = fabsf(dk[k]) > 1e-12f ? __fdiv_rn(1.0f, dk[k]) : 1e12f;
        oinv[j][k] = __fmul_rn(ok[k], inv[j][k]);
      }
      tm[j] = tmax[ray];
    }
    __syncthreads();  // the boxes and the cleared entries

    // the entry bits of this thread's rays into cluster c (+inf: no entry)
    auto entry_bits = [&](int c, int (&bits)[RPT]) {
      float lo[3], hi[3];
      if (GLOBAL) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          lo[k] = __ldg(cl_min + 3 * c + k);
          hi[k] = __ldg(cl_max + 3 * c + k);
        }
      } else {
        const float4 b0 = box[2 * c], b1 = box[2 * c + 1];
        lo[0] = b0.x, lo[1] = b0.y, lo[2] = b0.z, hi[0] = b0.w, hi[1] = b1.x, hi[2] = b1.y;
      }
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        float tn = 0.0f, tf = 0.0f;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float a = __fsub_rn(__fmul_rn(inv[j][k], lo[k]), oinv[j][k]);
          const float bb = __fsub_rn(__fmul_rn(inv[j][k], hi[k]), oinv[j][k]);
          const bool lt = a < bb;
          const float l = lt ? a : bb, h = lt ? bb : a;
          tn = k == 0 ? l : (l > tn ? l : tn);
          tf = k == 0 ? h : (h < tf ? h : tf);
        }
        const bool hit = tn <= (tm[j] < tf ? tm[j] : tf) && tf > 0.0f;
        bits[j] = hit ? __float_as_int(tn > 0.0f ? tn : 0.0f) : INF_BITS;
      }
    };

    if (first + RUN <= rb && first / sub == (first + RUN - 1) / sub) {
      // the warp's run lies in one sub-block, every ray valid: one merge a
      // cluster (the only case at the default 2048/256)
      int* e_s = e + static_cast<int64_t>(first / sub) * nc;
      for (int c = 0; c < nc; ++c) {
        int bits[RPT];
        entry_bits(c, bits);
        int m = bits[0];
#pragma unroll
        for (int j = 1; j < RPT; ++j) m = bits[j] < m ? bits[j] : m;
        m = __reduce_min_sync(FULL, m);
        if (lane == 0 && m != INF_BITS) atomicMin(&e_s[c], m);
      }
      continue;
    }
    // else each 32-ray row alone
    bool row_one[RPT], head[RPT];
    unsigned same[RPT];  // bit k: the lane 2^k further on is in this lane's sub-block
    int s_of[RPT];       // this lane's sub-block
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      const int r = first + j * 32 + lane;
      s_of[j] = r / sub;
      row_one[j] = (first + j * 32) / sub == (first + j * 32 + 31) / sub;
      head[j] = lane == 0 || (r - 1) / sub != s_of[j];
      same[j] = 0;
#pragma unroll
      for (int k = 0; k < 5; ++k)
        same[j] |= static_cast<unsigned>(lane + (1 << k) < 32 &&
                                         (r + (1 << k)) / sub == s_of[j]) << k;
    }
    for (int c = 0; c < nc; ++c) {
      int bits[RPT];
      entry_bits(c, bits);
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        int m = valid[j] ? bits[j] : INF_BITS;
        if (row_one[j]) {
          m = __reduce_min_sync(FULL, m);
          if (lane == 0 && m != INF_BITS)
            atomicMin(&e[static_cast<int64_t>(s_of[j]) * nc + c], m);
          continue;
        }
#pragma unroll
        for (int k = 0; k < 5; ++k) {
          const int u = __shfl_down_sync(FULL, m, 1 << k);
          if ((same[j] >> k) & 1u) m = u < m ? u : m;
        }
        if (head[j] && m != INF_BITS) atomicMin(&e[static_cast<int64_t>(s_of[j]) * nc + c], m);
      }
    }
  }
  __syncthreads();

  // the block entries, then the visit order by rank
  for (int c = tid; c < nc; c += THREADS) {
    int v = e[c];
    for (int s = 1; s < nsub; ++s) v = min(v, e[static_cast<int64_t>(s) * nc + c]);
    eb[c] = v;
  }
  __syncthreads();
  int live = 0;
  for (int c = tid; c < nc; c += THREADS) {
    const int v = eb[c];
    int r = 0;
    for (int c2 = 0; c2 < nc; ++c2) {
      const int u = eb[c2];
      r += (u < v) | ((u == v) & (c2 < c));
    }
    const int64_t at = static_cast<int64_t>(b) * nc + r;
    order[at] = c;
    blk_bits[at] = v;
    for (int s = 0; s < nsub; ++s)
      e_bits[(static_cast<int64_t>(b) * nsub + s) * nc + r] = e[static_cast<int64_t>(s) * nc + c];
    live += v != INF_BITS;
  }
  if (live) atomicAdd(&s_live, live);
  __syncthreads();
  if (tid == 0) nlive[b] = s_live;
}

}  // namespace

extern "C" int sailor_slab_tables(const float* orig, const float* dir, const float* tmax,
                                  const float* cl_min, const float* cl_max, float* feats,
                                  int* e_bits, int* order, int* blk_bits, int* nlive,
                                  int* tables, int n_blocks, int nc, int sub, int nsub,
                                  cudaStream_t stream) {
  if (nc < 1 || sub < 1 || nsub < 1 || static_cast<int64_t>(sub) * nsub > (1 << 30))
    return static_cast<int>(cudaErrorInvalidValue);
  if (tables != nullptr) {  // tables: (n_blocks, nsub + 1, nc) ints
    slab_tables_kernel<true><<<n_blocks, THREADS, 0, stream>>>(
        orig, dir, tmax, cl_min, cl_max, feats, e_bits, order, blk_bits, nlive, tables, nc, sub,
        nsub);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = smem_bytes(nc, nsub);
  if (smem > SMEM_LIMIT) return static_cast<int>(cudaErrorInvalidValue);
  const auto kernel = slab_tables_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<n_blocks, THREADS, smem, stream>>>(orig, dir, tmax, cl_min, cl_max, feats, e_bits,
                                              order, blk_bits, nlive, nullptr, nc, sub, nsub);
  return static_cast<int>(cudaGetLastError());
}
