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
// What it computes: for each 256-ray sub-block and each cluster AABB, the
// least entry distance of the sub-block's rays into the box (+inf where no
// ray pierces it). Per ray and axis, inv = |d| > 1e-12 ? 1/d : 1e12 and
// oinv = o * inv; a = inv * lo - oinv, b = inv * hi - oinv; the ray enters
// at tn = max over axes of min(a, b), leaves at tf = min of max(a, b),
// pierces the box iff tn <= min(tf, tmax) and tf > 0, and enters at
// max(tn, 0). Every min and max is a select on one comparison, as in the
// twin, so kernel and twin agree bit for bit (-fmad=false, exact division).
// Per 2048-ray block, with e_blk the minimum over its 8 sub-blocks, it
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
// Design: one block per 2048-ray block, RPT rays a thread (a thread's rays
// lie in one sub-block, SUB / RPT threads apart, so loads coalesce); the
// boxes are staged in shared memory as two 16-byte rows each and every box
// read (a broadcast) serves the thread's RPT independent rays. Entries are
// +0, a positive finite or +inf, so their bits order like the floats: a
// thread takes the integer min of its rays, one warp reduce (redux) a
// cluster, and one shared atomicMin a warp and cluster merges a sub-block's
// warps. The block then builds the tables in shared memory: the visit
// order by rank, rank(c) = #{c': e[c'] < e[c]} + #{c' < c: e[c'] = e[c]},
// which is the stable argsort here (no NaN, and zero only as +0), with no
// sort and no host synchronisation. tests/torch_kernel_variants.py times
// RPT = 2 (1024 threads) against 4 (512) and the other block layout (one
// block per sub-block, the last of a ray block's 8 to arrive building the
// tables from the others' entries in scratch, behind a zeroed arrival
// counter per ray block; the script patches it in). On an H100 80GB HBM3
// at 700 W, on the bench tracer scene's bounce-1 rays: 0.0501 ms as built,
// 0.0531 with 2 rays a thread, 0.0583 and 0.0576 (2 rays) a block a
// sub-block.
//
// Any cluster count: the tables take 68 B a cluster (boxes 32, entries
// 9 x 4), so up to SMEM_CLUSTERS clusters (204 KB of the 227 KB a block may
// have) they live in dynamic shared memory, and above it each block keeps
// its entries in its own rows of a global scratch the wrapper allocates
// ((n_blocks, NSUB + 1, nc) ints; GLOBAL) and reads each box from cl_min
// and cl_max (a broadcast through L1). The arithmetic, the merge and the
// rank are the same, so the tables are bit-equal either way. The path
// tracer's routing rule (36 B a (ray block, cluster) within 1 MiB) admits
// up to 29,127 block-clusters: one ray block over 29,127 clusters ranks
// them in about 850M comparisons on one SM, some milliseconds.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int SUB = 256;
constexpr int NSUB = 8;  // sub-blocks of a 2048-ray block
constexpr int FEATS = 16;
constexpr int SMEM_CLUSTERS = 3072;  // tables in shared memory up to here (sweep.py's too)
constexpr int RPT = 4;              // rays a thread
constexpr int THREADS = NSUB * SUB / RPT;
constexpr int SUB_THREADS = SUB / RPT;
constexpr int INF_BITS = 0x7f800000;
constexpr unsigned FULL = 0xffffffffu;

// Dynamic shared memory: box[2 * nc] (float4), e[NSUB * nc], eb[nc] (int).
__host__ __device__ constexpr size_t smem_bytes(int nc) {
  return static_cast<size_t>(nc) * (2 * sizeof(float4) + (NSUB + 1) * sizeof(int));
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
                   int* __restrict__ tables, int nc) {
  extern __shared__ __align__(16) unsigned char smem[];
  float4* box = reinterpret_cast<float4*>(smem);
  int* e = GLOBAL ? tables + static_cast<int64_t>(blockIdx.x) * (NSUB + 1) * nc
                  : reinterpret_cast<int*>(box + 2 * nc);  // [NSUB][nc]
  int* eb = e + NSUB * nc;
  __shared__ int s_live;
  const int tid = threadIdx.x;
  if (!GLOBAL)
    for (int i = tid; i < nc; i += THREADS) {
      box[2 * i] =
          make_float4(cl_min[3 * i], cl_min[3 * i + 1], cl_min[3 * i + 2], cl_max[3 * i]);
      box[2 * i + 1] = make_float4(cl_max[3 * i + 1], cl_max[3 * i + 2], 0.0f, 0.0f);
    }
  for (int i = tid; i < NSUB * nc; i += THREADS) e[i] = INF_BITS;
  if (tid == 0) s_live = 0;

  // this thread's rays: sub-block `sub` of the block, SUB_THREADS apart
  const int sub = tid / SUB_THREADS;
  const int b = blockIdx.x;
  const int64_t ray0 = (static_cast<int64_t>(b) * NSUB + sub) * SUB + tid % SUB_THREADS;
  float inv[RPT][3], oinv[RPT][3], tm[RPT];
#pragma unroll
  for (int j = 0; j < RPT; ++j) {
    const int64_t ray = ray0 + j * SUB_THREADS;
    float dk[3], ok[3];
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
  __syncthreads();

  int* mine = e + sub * nc;
  for (int c = 0; c < nc; ++c) {
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
    int m = INF_BITS;
#pragma unroll
    for (int j = 0; j < RPT; ++j) {
      float tn = 0.0f, tf = 0.0f;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float a = __fsub_rn(__fmul_rn(inv[j][k], lo[k]), oinv[j][k]);
        const float b = __fsub_rn(__fmul_rn(inv[j][k], hi[k]), oinv[j][k]);
        const bool lt = a < b;
        const float l = lt ? a : b, h = lt ? b : a;
        tn = k == 0 ? l : (l > tn ? l : tn);
        tf = k == 0 ? h : (h < tf ? h : tf);
      }
      const bool hit = tn <= (tm[j] < tf ? tm[j] : tf) && tf > 0.0f;
      const int bits = hit ? __float_as_int(tn > 0.0f ? tn : 0.0f) : INF_BITS;
      m = bits < m ? bits : m;
    }
    m = __reduce_min_sync(FULL, m);
    if ((tid & 31) == 0 && m != INF_BITS) atomicMin(&mine[c], m);
  }
  __syncthreads();

  // the block entries, then the visit order by rank
  for (int c = tid; c < nc; c += THREADS) {
    int v = e[c];
#pragma unroll
    for (int s = 1; s < NSUB; ++s) v = min(v, e[s * nc + c]);
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
#pragma unroll
    for (int s = 0; s < NSUB; ++s)
      e_bits[(static_cast<int64_t>(b) * NSUB + s) * nc + r] = e[s * nc + c];
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
                                  int* tables, int n_blocks, int nc, cudaStream_t stream) {
  if (nc < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (nc > SMEM_CLUSTERS) {  // tables: (n_blocks, NSUB + 1, nc) ints
    if (tables == nullptr) return static_cast<int>(cudaErrorInvalidValue);
    slab_tables_kernel<true><<<n_blocks, THREADS, 0, stream>>>(
        orig, dir, tmax, cl_min, cl_max, feats, e_bits, order, blk_bits, nlive, tables, nc);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = smem_bytes(nc);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        slab_tables_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  slab_tables_kernel<false><<<n_blocks, THREADS, smem, stream>>>(
      orig, dir, tmax, cl_min, cl_max, feats, e_bits, order, blk_bits, nlive, nullptr, nc);
  return static_cast<int>(cudaGetLastError());
}
