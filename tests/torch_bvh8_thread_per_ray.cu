// The BVH8 traversal's one-thread-a-ray form, kept as the yardstick of
// sailor_tpu_torch/csrc/bvh8.cu: chip_smoke.py and
// tests/torch_bvh8_variants.py build it on their own (it is not in the
// port's library) and time it in turns beside the persistent kernel on
// the same passes. Same function, same C entry (minus the ray counter),
// bit-equal outputs.
//
// No TPU kernel: the JAX package runs this traversal as a lockstep
// lax.while_loop over all rays (sailor_tpu/raytracing/bvh8.py `intersect`,
// the loop body at :213-408). Its plain twin is `intersect_plain` in
// raytracing/bvh8.py. In the reference's loop each ray's state evolves on
// its own (a dead ray parks on row 0 and changes nothing; the loop runs while
// any ray lives), so one thread walking one ray to its end gives the same
// result per ray. Per iteration a ray reads the row of its node:
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
//   the pop of the iteration that found a hit.
// Mins and maxes propagate NaN as jnp.minimum/maximum do (fminf/fmaxf drop
// it). The file is built with -fmad=false, so kernel and twin round the same
// way operation by operation.
//
// Bound on the H100: the rows a ray reads (the half its flag selects: 280 B
// of a leaf, 224 B of an internal row, and the flag), read from device
// memory, with ~50 float operations a triangle slot and ~25 a child.
// chip_smoke.py counts the rows each pass reads from the twin's `work`.
//
// Design: one thread per ray, one launch per intersector pass, the
// 12-entry stack in local memory, rows read as scalar floats through the
// read-only cache. Warps diverge wherever their rays' walks do.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

constexpr int ROW = 72;
constexpr int MAX_STACK = 12;
constexpr int THREADS = 128;
constexpr int I_MIN = 0, I_MAX = 24, I_CHILD = 48, FLAG = 71;
constexpr int L_V0 = 0, L_E1 = 21, L_E2 = 42, L_ID = 63;

// jnp.maximum semantics: NaN from either side propagates.
__device__ __forceinline__ float max_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}

__global__ void __launch_bounds__(THREADS)
bvh8_kernel(const float* __restrict__ table, const float* __restrict__ orig,
            const float* __restrict__ dir, const float* __restrict__ t0,
            const unsigned char* __restrict__ active, float* __restrict__ t_out,
            int* __restrict__ tri_out, float* __restrict__ u_out,
            float* __restrict__ v_out, int n, int any_hit) {
  using sailor::clamp_lo;
  using sailor::min_nan;
  const int i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  float t_best = t0[i];
  int tri_best = -1;
  float u_best = 0.f, v_best = 0.f;
  if (active[i]) {
    const float ox = orig[3 * i], oy = orig[3 * i + 1], oz = orig[3 * i + 2];
    const float dx = dir[3 * i], dy = dir[3 * i + 1], dz = dir[3 * i + 2];
    const float ix = fabsf(dx) > 1e-12f ? 1.0f / dx : 1e12f;
    const float iy = fabsf(dy) > 1e-12f ? 1.0f / dy : 1e12f;
    const float iz = fabsf(dz) > 1e-12f ? 1.0f / dz : 1e12f;
    int stack[MAX_STACK];
    int sp = 0;
    int node = 0;
    for (;;) {
      const float* row = table + static_cast<size_t>(node) * ROW;
      if (row[FLAG] > 0.5f) {
        // ---- leaf: the least t of its slots, then the winners' maxima
        float t_k[7], u_k[7], v_k[7];
        float t_leaf = __int_as_float(0x7f800000);
#pragma unroll
        for (int k = 0; k < 7; ++k) {
          const float v0x = row[L_V0 + k], v0y = row[L_V0 + 7 + k], v0z = row[L_V0 + 14 + k];
          const float e1x = row[L_E1 + k], e1y = row[L_E1 + 7 + k], e1z = row[L_E1 + 14 + k];
          const float e2x = row[L_E2 + k], e2y = row[L_E2 + 7 + k], e2z = row[L_E2 + 14 + k];
          const int id = __float_as_int(row[L_ID + k]);
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
                          u + v <= 1.0f && t > 1e-4f && t < t_best;
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
              id_sel = max(id_sel, __float_as_int(row[L_ID + k]));
              u_sel = u_k[k] > u_sel ? u_k[k] : u_sel;
              v_sel = v_k[k] > v_sel ? v_k[k] : v_sel;
            }
          }
          t_best = t_leaf;
          tri_best = id_sel;
          u_best = u_sel;
          v_best = v_sel;
        }
      } else {
        // ---- internal: slab-test the 8 children, push far then near
        float tn[8];
        int hit = 0;
        float tn_min = __int_as_float(0x7f800000), tn_max = __int_as_float(0xff800000);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float tx0 = (row[I_MIN + c] - ox) * ix, tx1 = (row[I_MAX + c] - ox) * ix;
          const float ty0 = (row[I_MIN + 8 + c] - oy) * iy, ty1 = (row[I_MAX + 8 + c] - oy) * iy;
          const float tz0 = (row[I_MIN + 16 + c] - oz) * iz, tz1 = (row[I_MAX + 16 + c] - oz) * iz;
          const float tnear = max_nan(max_nan(min_nan(tx0, tx1), min_nan(ty0, ty1)),
                                      clamp_lo(min_nan(tz0, tz1), 0.0f));
          const float tfar = min_nan(min_nan(max_nan(tx0, tx1), max_nan(ty0, ty1)),
                                     max_nan(tz0, tz1));
          tn[c] = tnear;
          if (tfar >= tnear && tnear < t_best && __float_as_int(row[I_CHILD + c]) >= 0) {
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
          const int base = __float_as_int(row[I_CHILD]) << 8;
          if (far && sp < MAX_STACK) stack[sp++] = base | far;
          if (near && sp < MAX_STACK) stack[sp++] = base | near;
        }
      }
      // ---- pop the lowest set bit of the top entry
      if (sp == 0) break;
      const int top = stack[sp - 1];
      const int mask = top & 0xFF;
      const int rem = mask & (mask - 1);
      if (rem) {
        stack[sp - 1] = (top & ~0xFF) | rem;
      } else {
        --sp;
      }
      node = (top >> 8) + __ffs(mask) - 1;
      if (any_hit && tri_best >= 0) break;
    }
  }
  t_out[i] = t_best;
  tri_out[i] = tri_best;
  u_out[i] = u_best;
  v_out[i] = v_best;
}

}  // namespace

extern "C" int sailor_bvh8_intersect(const float* table, const float* orig, const float* dir,
                                     const float* t0, const unsigned char* active,
                                     float* t_out, int* tri_out, float* u_out, float* v_out,
                                     int n, int any_hit, cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  bvh8_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      table, orig, dir, t0, active, t_out, tri_out, u_out, v_out, n, any_hit);
  return static_cast<int>(cudaGetLastError());
}
