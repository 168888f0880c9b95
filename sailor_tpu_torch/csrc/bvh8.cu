// BVH8 traversal: closest or any hit of each ray through the packed 8-wide
// BVH table, for Hopper (sm_90a).
//
// No TPU kernel: the JAX package runs this traversal as a lockstep
// lax.while_loop over all rays (sailor_tpu/raytracing/bvh8.py `intersect`,
// the loop body at :213-408). Its plain twin is `intersect_plain` in
// raytracing/bvh8.py. In the reference's loop each ray's state evolves on
// its own (a dead ray parks on row 0 and changes nothing; the loop runs while
// any ray lives), so any schedule that runs each ray's steps in order gives
// the same result per ray. Per step a ray reads the row of its node:
//
// - a leaf (column 71 > 0.5): Moller-Trumbore against its 7 triangle slots,
//   rounded as the reference's compiled loop rounds it (ROADMAP C 2):
//   p = d x e2 and q = s x e1 as fma(a, b, -(c * d)) per component,
//   det = fma(e1z, pz, fma(e1x, px, e1y * py)), u and v likewise,
//   t = fma(e2z, qz, fma(e2y, qy, e2x * qx)), each dot times inv_det; a slot
//   counts when its id >= 0, |det| > 1e-10, u >= 0, v >= 0, u + v <= 1 and
//   1e-4 < t < best t. The leaf takes the least t and, among the slots at
//   that t, the largest id, the largest u and the largest v, each on its own;
// - an internal row: the slab test of its 8 children (entry
//   max(max(min x, min y), max(min z, 0)), exit min(min(max x, max y),
//   max z); a child is hit when exit >= entry, entry < best t and its index
//   >= 0), the hit children split at the midpoint of their entries into a
//   near (entry <= midpoint) and a far group, and the far group pushed
//   first as (first child << 8) | mask; a push that would reach MAX_STACK
//   is dropped, its subtree lost, as in the reference;
// - then the pop: the lowest set bit of the top entry's mask names the next
//   row; the entry goes when its mask empties. An any-hit ray stops after
//   the pop of the step that found a hit.
// Mins and maxes propagate NaN as jnp.minimum/maximum do (fminf/fmaxf drop
// it). The file is built with -fmad=false, so kernel and twin round the same
// way operation by operation. `step` is one ray's step (a row in registers,
// the ray's state in and out); only the schedule below decides which lane
// runs which ray's next step, and when.
//
// Bound on the H100: the rows a ray reads (the half its flag selects: 280 B
// of a leaf, 224 B of an internal row, and the flag), read from device
// memory, with ~50 float operations a triangle slot and ~25 a child.
// chip_smoke.py counts the rows each pass reads from the twin's `work`.
// The rows are few and hot (a pass reads each of a few thousand rows from
// L1/L2 hundreds of times), so what holds the kernel is instruction issue
// and the latency of the row loads; tests/torch_bvh8_variants.py times each
// choice below against its alternatives. The design:
//
// 1. Persistent warps that refill finished lanes (Aila & Laine 2009): one
//    grid of the SMs times the blocks resident on each (the occupancy is
//    asked once a device and cached). A warp takes rays 32 at a time from
//    a counter (`next`, cleared on the stream before each launch); an
//    inactive ray's outputs (t0, -1, 0, 0) are written at the fetch, an
//    active one waits in the register `pend` of the lane that fetched it.
//    Each iteration the idle lanes take pending rays in lane order
//    (ballots, popc and a shuffle: no list in shared memory, no barrier),
//    and the warp fetches the next 32 when none is pending and at least
//    REFILL_IDLE lanes are idle. Dead rays take no lane; a long walk keeps
//    one lane, not its warp's 31 others. A warp whose lanes hold both kinds
//    of row runs both branches in one iteration: making leaf lanes wait for
//    the internal ones (Aila & Laine's while-while) cost 28 registers (4
//    blocks an SM in place of 5) and idle lanes; waiting one step lost 5%
//    on the heaviest pass (pooled bounce rays) and won at most 5% on the
//    others, longer waits lost on all. Chunks of several batches a fetch
//    lost too (the ends of a pass fall unevenly).
// 2. 16-byte row loads through the read-only cache: a lane reads quads
//    0-13 of its row and quad 17 (leaf ids 5-6 and the flag) together, so
//    an internal row steps after one round trip, and a leaf reads quads
//    14-16 too: 15 or 18 load instructions a row in place of ~57 or ~71.
// 3. jnp.minimum/maximum as one min.NaN/max.NaN instruction each: the slab
//    test's 11 a child were most of an internal step's instructions as
//    compares and selects.
// 4. Occupancy: 96 registers, 5 blocks of 128 an SM. The stack stays in
//    local memory (12 ints a lane; in shared memory it costs 8 registers
//    and a block an SM), and a leaf tests all 7 slots (branching past the
//    empty ones costs 7 registers).
#include <cuda_runtime.h>

namespace {

constexpr int ROW = 72;
constexpr int QUADS = ROW / 4;  // float4s a row
constexpr int LEAF_QUADS = 17;  // columns 0-67: the geometry and ids 0-4
constexpr int INNER_QUADS = 14;  // columns 0-55: the bounds and the children
constexpr int HEAD = 17;  // float4 #17: ids 5-6, unused, the flag
constexpr int MAX_STACK = 12;
constexpr int THREADS = 128;
constexpr unsigned FULL = 0xffffffffu;
// a warp fetches 32 rays when none is pending and this many lanes are idle
constexpr int REFILL_IDLE = 16;
constexpr int I_MIN = 0, I_MAX = 24, I_CHILD = 48;
constexpr int L_V0 = 0, L_E1 = 21, L_E2 = 42, L_ID = 63;

// jnp.maximum / jnp.minimum semantics: NaN from either side propagates.
// One instruction each (sailor::min_nan's selects cost three); only
// comparisons read the results, so NaN payloads and the sign of a zero
// do not matter.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// A ray's walk: its best hit so far, its stack and the row it reads next.
struct State {
  float t, u, v;
  int tri, sp, node;
  int stack[MAX_STACK];
};

__device__ __forceinline__ float4 quad(const float4* row, int q) { return __ldg(row + q); }

// quads Q0..Q1-1 of a row into r[4 * Q0, 4 * Q1)
template <int Q0, int Q1>
__device__ __forceinline__ void load_quads(const float4* row, float (&r)[ROW]) {
#pragma unroll
  for (int q = Q0; q < Q1; ++q) {
    const float4 f = quad(row, q);
    r[4 * q] = f.x;
    r[4 * q + 1] = f.y;
    r[4 * q + 2] = f.z;
    r[4 * q + 3] = f.w;
  }
}

// A leaf: the least t of its slots, then the winners' maxima.
__device__ __forceinline__ void leaf_test(const Ray& ray, State& s, const float (&r)[ROW]) {
  const float ox = ray.ox, oy = ray.oy, oz = ray.oz, dx = ray.dx, dy = ray.dy, dz = ray.dz;
  float t_k[7], u_k[7], v_k[7];
  float t_leaf = __int_as_float(0x7f800000);
#pragma unroll
  for (int k = 0; k < 7; ++k) {
    const float v0x = r[L_V0 + k], v0y = r[L_V0 + 7 + k], v0z = r[L_V0 + 14 + k];
    const float e1x = r[L_E1 + k], e1y = r[L_E1 + 7 + k], e1z = r[L_E1 + 14 + k];
    const float e2x = r[L_E2 + k], e2y = r[L_E2 + 7 + k], e2z = r[L_E2 + 14 + k];
    const int id = __float_as_int(r[L_ID + k]);
    const float px = __fmaf_rn(dy, e2z, -(dz * e2y));
    const float py = __fmaf_rn(dz, e2x, -(dx * e2z));
    const float pz = __fmaf_rn(dx, e2y, -(dy * e2x));
    const float det = __fmaf_rn(e1z, pz, __fmaf_rn(e1x, px, e1y * py));
    const float inv_det = fabsf(det) > 1e-10f ? 1.0f / det : 0.0f;
    const float sx = ox - v0x, sy = oy - v0y, sz = oz - v0z;
    const float u = __fmaf_rn(sz, pz, __fmaf_rn(sx, px, sy * py)) * inv_det;
    const float qx = __fmaf_rn(sy, e1z, -(sz * e1y));
    const float qy = __fmaf_rn(sz, e1x, -(sx * e1z));
    const float qz = __fmaf_rn(sx, e1y, -(sy * e1x));
    const float v = __fmaf_rn(dz, qz, __fmaf_rn(dx, qx, dy * qy)) * inv_det;
    const float t = __fmaf_rn(e2z, qz, __fmaf_rn(e2y, qy, e2x * qx)) * inv_det;
    const bool ok = id >= 0 && fabsf(det) > 1e-10f && u >= 0.0f && v >= 0.0f &&
                    u + v <= 1.0f && t > 1e-4f && t < s.t;
    t_k[k] = ok ? t : __int_as_float(0x7f800000);
    u_k[k] = u;
    v_k[k] = v;
    t_leaf = fminf(t_leaf, t_k[k]);  // no NaN: a slot that counts has a finite t
  }
  if (t_leaf != __int_as_float(0x7f800000)) {
    int id_sel = -1;
    float u_sel = __int_as_float(0xff800000), v_sel = u_sel;
#pragma unroll
    for (int k = 0; k < 7; ++k) {
      if (t_k[k] == t_leaf) {
        id_sel = max(id_sel, __float_as_int(r[L_ID + k]));
        u_sel = u_k[k] > u_sel ? u_k[k] : u_sel;
        v_sel = v_k[k] > v_sel ? v_k[k] : v_sel;
      }
    }
    s.t = t_leaf;
    s.tri = id_sel;
    s.u = u_sel;
    s.v = v_sel;
  }
}

// An internal row: slab-test the 8 children, push far then near.
__device__ __forceinline__ void inner_test(const Ray& ray, State& s, const float (&r)[ROW]) {
  const float ox = ray.ox, oy = ray.oy, oz = ray.oz, ix = ray.ix, iy = ray.iy, iz = ray.iz;
  float tn[8];
  int hit = 0;
  float tn_min = __int_as_float(0x7f800000), tn_max = __int_as_float(0xff800000);
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    const float tx0 = (r[I_MIN + c] - ox) * ix, tx1 = (r[I_MAX + c] - ox) * ix;
    const float ty0 = (r[I_MIN + 8 + c] - oy) * iy, ty1 = (r[I_MAX + 8 + c] - oy) * iy;
    const float tz0 = (r[I_MIN + 16 + c] - oz) * iz, tz1 = (r[I_MAX + 16 + c] - oz) * iz;
    const float tnear = max_nan(max_nan(min_nan(tx0, tx1), min_nan(ty0, ty1)),
                                max_nan(min_nan(tz0, tz1), 0.0f));  // clamp_min(.., 0)
    const float tfar = min_nan(min_nan(max_nan(tx0, tx1), max_nan(ty0, ty1)),
                               max_nan(tz0, tz1));
    tn[c] = tnear;
    if (tfar >= tnear && tnear < s.t && __float_as_int(r[I_CHILD + c]) >= 0) {
      hit |= 1 << c;
      tn_min = fminf(tn_min, tnear);  // a hit child's entry is not NaN
      tn_max = fmaxf(tn_max, tnear);
    }
  }
  if (hit) {
    const float thresh = 0.5f * (tn_min + tn_max);
    int near = 0;
#pragma unroll
    for (int c = 0; c < 8; ++c) near |= (tn[c] <= thresh) << c;
    near &= hit;
    const int far = hit & ~near;
    const int base = __float_as_int(r[I_CHILD]) << 8;
    if (far && s.sp < MAX_STACK) s.stack[s.sp++] = base | far;
    if (near && s.sp < MAX_STACK) s.stack[s.sp++] = base | near;
  }
}

// One ray's step on the row r of its node (a leaf when LEAF), then the pop
// of the lowest set bit of the top entry. False when the walk ends: the
// stack is empty, or an any-hit ray has its hit.
template <bool LEAF>
__device__ __forceinline__ bool step(const Ray& ray, State& s, const float (&r)[ROW],
                                     int any_hit) {
  if (LEAF) {
    leaf_test(ray, s, r);
  } else {
    inner_test(ray, s, r);
  }
  if (s.sp == 0) return false;
  const int top = s.stack[s.sp - 1];
  const int mask = top & 0xFF;
  const int rem = mask & (mask - 1);
  if (rem) {
    s.stack[s.sp - 1] = (top & ~0xFF) | rem;
  } else {
    --s.sp;
  }
  s.node = (top >> 8) + __ffs(mask) - 1;
  return !(any_hit && s.tri >= 0);
}

// The position of set bit k (counted from 0) of m, which has more than k.
__device__ __forceinline__ int nth_set_bit(unsigned m, int k) {
  int p = 0;
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    const int c = __popc((m >> p) & ((1u << w) - 1u));
    if (k >= c) {
      k -= c;
      p += w;
    }
  }
  return p;
}

__global__ void __launch_bounds__(THREADS)
bvh8_kernel(const float* __restrict__ table, const float* __restrict__ orig,
            const float* __restrict__ dir, const float* __restrict__ t0,
            const unsigned char* __restrict__ active, float* __restrict__ t_out,
            int* __restrict__ tri_out, float* __restrict__ u_out,
            float* __restrict__ v_out, int n, int any_hit, int* __restrict__ next) {
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1u;
  const float4* rows = reinterpret_cast<const float4*>(table);
  Ray ray;
  State s;
  s.sp = 0;
  s.node = 0;
  int id = -1;  // the lane's ray, -1 while the lane is idle
  int pend = -1;  // an active ray this lane fetched that waits for a lane
  bool drained = false;  // (warp-uniform) the counter has passed n
  for (;;) {
    // ---- refill: fetch 32 rays when none is pending and enough lanes idle
    const unsigned idle = __ballot_sync(FULL, id < 0);
    unsigned pending = __ballot_sync(FULL, pend >= 0);
    if (!drained && !pending && __popc(idle) >= REFILL_IDLE) {
      int base = 0;
      if (lane == 0) base = atomicAdd(next, 32);
      base = __shfl_sync(FULL, base, 0);
      drained = base >= n - 32;
      const int i = base + lane;
      if (i < n) {
        if (__ldg(active + i)) {
          pend = i;
        } else {
          t_out[i] = __ldg(t0 + i);
          tri_out[i] = -1;
          u_out[i] = 0.0f;
          v_out[i] = 0.0f;
        }
      }
      pending = __ballot_sync(FULL, pend >= 0);
    }
    // idle lane k (in lane order) takes pending ray k
    const int take = min(__popc(idle), __popc(pending));
    if (take) {
      const int rank = __popc(idle & below);
      const bool gets = id < 0 && rank < take;
      const int got = __shfl_sync(FULL, pend, gets ? nth_set_bit(pending, rank) : lane);
      if (pend >= 0 && __popc(pending & below) < take) pend = -1;
      if (gets) {
        id = got;
        const size_t i3 = 3 * static_cast<size_t>(id);
        ray.ox = __ldg(orig + i3);
        ray.oy = __ldg(orig + i3 + 1);
        ray.oz = __ldg(orig + i3 + 2);
        ray.dx = __ldg(dir + i3);
        ray.dy = __ldg(dir + i3 + 1);
        ray.dz = __ldg(dir + i3 + 2);
        ray.ix = fabsf(ray.dx) > 1e-12f ? 1.0f / ray.dx : 1e12f;
        ray.iy = fabsf(ray.dy) > 1e-12f ? 1.0f / ray.dy : 1e12f;
        ray.iz = fabsf(ray.dz) > 1e-12f ? 1.0f / ray.dz : 1e12f;
        s.t = __ldg(t0 + id);
        s.tri = -1;
        s.u = 0.0f;
        s.v = 0.0f;
        s.sp = 0;
        s.node = 0;
      }
    }
    const unsigned busy = __ballot_sync(FULL, id >= 0);
    if (!busy) {
      if (drained) break;  // every lane idle, nothing pending, no ray left
      continue;
    }
    // ---- step: each busy lane reads quads 0-13 of its row with the flag
    // quad; an internal row steps on them, a leaf reads quads 14-16 too
    if (id >= 0) {
      const float4* row = rows + static_cast<size_t>(s.node) * QUADS;
      float r[ROW];
      load_quads<0, INNER_QUADS>(row, r);
      const float4 head = quad(row, HEAD);
      bool live;
      if (head.w > 0.5f) {
        load_quads<INNER_QUADS, LEAF_QUADS>(row, r);
        r[4 * HEAD] = head.x;
        r[4 * HEAD + 1] = head.y;
        live = step<true>(ray, s, r, any_hit);
      } else {
        live = step<false>(ray, s, r, any_hit);
      }
      if (!live) {
        t_out[id] = s.t;
        tri_out[id] = s.tri;
        u_out[id] = s.u;
        v_out[id] = s.v;
        id = -1;
      }
    }
  }
}

// blocks of bvh8_kernel resident on all SMs of each device, asked once
int resident_blocks(int device) {
  static int cached[64];
  if (device < 0 || device >= 64) return 0;
  if (!cached[device]) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bvh8_kernel, THREADS, 0) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
      return 0;
    cached[device] = per_sm * sms;
  }
  return cached[device];
}

}  // namespace

// The kernel as built on the current device: registers a thread, static
// shared and local bytes a thread, resident blocks on all SMs (the grid of
// a launch with enough rays), threads a block and REFILL_IDLE.
extern "C" int sailor_bvh8_info(int* info) {
  int device = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, bvh8_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  info[0] = attr.numRegs;
  info[1] = static_cast<int>(attr.sharedSizeBytes);
  info[2] = static_cast<int>(attr.localSizeBytes);
  info[3] = resident_blocks(device);
  info[4] = THREADS;
  info[5] = REFILL_IDLE;
  return static_cast<int>(cudaSuccess);
}

// `next` is one int32 of scratch: the ray counter, cleared here on `stream`.
extern "C" int sailor_bvh8_intersect(const float* table, const float* orig, const float* dir,
                                     const float* t0, const unsigned char* active,
                                     float* t_out, int* tri_out, float* u_out, float* v_out,
                                     int n, int any_hit, int* next, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int resident = resident_blocks(device);
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaMemsetAsync(next, 0, sizeof(int), stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int wanted = (n + THREADS - 1) / THREADS;
  const int blocks = wanted < resident ? wanted : resident;
  bvh8_kernel<<<blocks, THREADS, 0, stream>>>(table, orig, dir, t0, active, t_out, tri_out,
                                              u_out, v_out, n, any_hit, next);
  return static_cast<int>(cudaGetLastError());
}
