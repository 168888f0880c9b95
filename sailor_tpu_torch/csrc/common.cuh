// Shared helpers of the port's CUDA kernels.
//
// Rounding: the sources are compiled with -fmad=false, so a multiply and an
// add round separately, and a kernel calls __fmaf_rn exactly where its plain
// PyTorch twin calls core.math3d.fma (whose docstring says why). Each kernel
// thus repeats its twin's rounding operation by operation.
#pragma once

#include <cuda_runtime.h>

namespace sailor {

// torch.clamp semantics: NaN passes through (fminf/fmaxf would drop it).
__device__ __forceinline__ float clamp_lo(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp_hi(float x, float hi) {
  return x != x ? x : fminf(x, hi);
}
__device__ __forceinline__ float clamp2(float x, float lo, float hi) {
  return clamp_hi(clamp_lo(x, lo), hi);
}

}  // namespace sailor

namespace sailor {

// torch.minimum semantics: NaN from either side propagates.
__device__ __forceinline__ float min_nan(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}

}  // namespace sailor
