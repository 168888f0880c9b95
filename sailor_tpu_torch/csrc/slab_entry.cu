// B4: per-sub-block cluster slab entry for Hopper (sm_90a).
//
// Replaces sailor_tpu/raytracing/sweep.py `_slab_entry_kernel`, called from
// `_slab_entry_sub` in `intersect`. Its plain twin is `slab_entry_plain` in
// raytracing/sweep.py.
//
// What it computes: for each 256-ray sub-block and each cluster AABB, the
// least entry distance of the sub-block's rays into the box (+inf where no
// ray pierces it). Per ray and axis, inv = |d| > 1e-12 ? 1/d : 1e12 and
// oinv = o * inv; a = inv * lo - oinv, b = inv * hi - oinv; the ray enters
// at tn = max over axes of min(a, b), leaves at tf = min of max(a, b),
// pierces the box iff tn <= min(tf, tmax) and tf > 0, and enters at
// max(tn, 0). Every min and max is a select on one comparison, as in the
// twin, so kernel and twin agree bit for bit (-fmad=false, exact division).
//
// Bound on the H100: the rays' feature rows (64 B), tmax and the (Rp/256, C)
// output move once; about 30 float operations per (ray, cluster) pair.
// chip_smoke.py reports the larger. Design: one block per sub-block, one
// thread per ray; the cluster boxes are staged in shared memory (broadcast
// reads); each warp reduces its 32 entries per cluster with
// __reduce_min_sync on the float bits (entries are +0 or more, or +inf, so
// the bits order like the floats) and one atomicMin per warp and cluster
// merges the warps in shared memory.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int SUB = 256;
constexpr int FEATS = 16;
constexpr int MAX_CLUSTERS = 1024;  // 262,144 triangles in clusters of 256

__global__ void __launch_bounds__(SUB)
slab_entry_kernel(const float* __restrict__ feats, const float* __restrict__ tmax,
                  const float* __restrict__ cl_min, const float* __restrict__ cl_max,
                  float* __restrict__ out, int nc) {
  __shared__ float box[6 * MAX_CLUSTERS];
  __shared__ int best[MAX_CLUSTERS];
  for (int i = threadIdx.x; i < nc; i += SUB) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      box[6 * i + k] = cl_min[3 * i + k];
      box[6 * i + 3 + k] = cl_max[3 * i + k];
    }
    best[i] = 0x7f800000;  // +inf
  }
  __syncthreads();

  const int64_t ray = static_cast<int64_t>(blockIdx.x) * SUB + threadIdx.x;
  const float* f = feats + ray * FEATS;
  float inv[3], oinv[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float d = f[k];
    inv[k] = fabsf(d) > 1e-12f ? __fdiv_rn(1.0f, d) : 1e12f;
    oinv[k] = __fmul_rn(f[8 + k], inv[k]);
  }
  const float tm = tmax[ray];

  for (int c = 0; c < nc; ++c) {
    const float* bx = box + 6 * c;
    float tn = 0.0f, tf = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float a = __fsub_rn(__fmul_rn(inv[k], bx[k]), oinv[k]);
      const float b = __fsub_rn(__fmul_rn(inv[k], bx[3 + k]), oinv[k]);
      const bool lt = a < b;
      const float lo = lt ? a : b, hi = lt ? b : a;
      tn = k == 0 ? lo : (lo > tn ? lo : tn);
      tf = k == 0 ? hi : (hi < tf ? hi : tf);
    }
    const bool hit = tn <= (tm < tf ? tm : tf) && tf > 0.0f;
    const float entry = hit ? (tn > 0.0f ? tn : 0.0f) : __int_as_float(0x7f800000);
    const int m = __reduce_min_sync(0xffffffffu, __float_as_int(entry));
    if ((threadIdx.x & 31) == 0 && m != 0x7f800000) atomicMin(&best[c], m);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nc; i += SUB)
    out[static_cast<int64_t>(blockIdx.x) * nc + i] = __int_as_float(best[i]);
}

}  // namespace

extern "C" int sailor_slab_entry(const float* feats, const float* tmax,
                                 const float* cl_min, const float* cl_max,
                                 float* out, int n_sub, int nc,
                                 cudaStream_t stream) {
  if (nc > MAX_CLUSTERS) return static_cast<int>(cudaErrorInvalidValue);
  slab_entry_kernel<<<n_sub, SUB, 0, stream>>>(feats, tmax, cl_min, cl_max, out, nc);
  return static_cast<int>(cudaGetLastError());
}
