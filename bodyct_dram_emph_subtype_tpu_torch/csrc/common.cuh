// Shared helpers for the hand-written Hopper kernels of the port.
//
// Every kernel takes float32 or bfloat16 activations (dtype code 0 / 1 at
// the C entry points), converts to float32 on load and rounds back to the
// storage type on store, only through the cuda_bf16.h intrinsics.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dram {

enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float32 through the storage type T and back (identity for f32).
template <typename T>
__device__ __forceinline__ float round_through(float v) {
  return to_f32(from_f32<T>(v));
}

}  // namespace dram
