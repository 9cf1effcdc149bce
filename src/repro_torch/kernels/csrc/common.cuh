// Helpers shared by the port's attention kernels: dtype codes, conversions
// to and from float32, and warp reductions.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace repro_torch {

// Element type codes passed by the Python wrappers (kernels/_build.py).
constexpr int kFloat32 = 0;
constexpr int kBFloat16 = 1;

// Masked scores take this value, as in repro/kernels/*.py (never -inf: an
// all-masked row then stays finite).
constexpr float kNegInf = -1e30f;
// Floor on the softmax denominator, as in the TPU kernels.
constexpr float kMinDenom = 1e-30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

}  // namespace repro_torch
