// Shared device helpers for the port's hand-written Hopper kernels.
//
// Every kernel computes in f32 and stores in the tensor's own dtype:
// f32 (dtype code 0) or bf16 (dtype code 1). bf16 conversions use the
// round-to-nearest-even intrinsics, the same rounding as torch's
// `.to(torch.bfloat16)` and jnp's `astype(jnp.bfloat16)`. int8 KV codes
// widen to f32 exactly.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace tdt {

constexpr int kDtypeF32 = 0;
constexpr int kDtypeBF16 = 1;
// The masked-score value of the TPU kernels (-1e30, never -inf): a
// fully masked row then yields exp(0) terms instead of NaNs.
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round an f32 value through T and back: P is rounded to V's dtype
// before P·V, as the TPU kernels do.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Load N contiguous elements of T starting at p (aligned to N *
// sizeof(T) bytes) into f32 registers, as one vector load where the
// width allows.
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float (&out)[N]) {
  constexpr int kBytes = N * (int)sizeof(T);
  if constexpr (kBytes == 16) {
    uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
  } else if constexpr (kBytes == 8) {
    uint2 raw = *reinterpret_cast<const uint2*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
  } else if constexpr (kBytes == 4) {
    uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(e[i]);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = to_f32(p[i]);
  }
}

}  // namespace tdt
