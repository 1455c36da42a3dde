// The element type of the port's kernels A, B and C.
//
// Each of their sources is compiled twice (phoonnx_tpu_torch/cuda.py):
// for float32 tensors, and with -DPHX_BF16 for bfloat16 ones. elem_t is
// the type of the tensors a kernel reads and writes in device memory (its
// inputs, weights and outputs, and the scratch the TPU kernel keeps in
// the input's type); the arithmetic is float32 in both builds, and a
// bf16 value is rounded to nearest even only where it is stored.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace phx {

#ifdef PHX_BF16
using elem_t = __nv_bfloat16;
#else
using elem_t = float;
#endif
constexpr bool kElemFloat = std::is_same<elem_t, float>::value;

// bfloat16 bits -> float32 (exact)
__device__ __forceinline__ float bf16_bits(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// A read-only parameter (weights, biases) as float32.
__device__ __forceinline__ float ldg_f(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f(const __nv_bfloat16* p) {
  return bf16_bits(__ldg(reinterpret_cast<const unsigned short*>(p)));
}

// Store a float32 value in the element type (rounded to nearest even).
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// v rounded to the element type, as float32 (the identity for float32)
__device__ __forceinline__ float round_elem(float v) {
  if constexpr (kElemFloat) {
    return v;
  } else {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
}

}  // namespace phx
