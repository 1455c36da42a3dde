// The noise kernel: seeded standard normals on the card, for Hopper (sm_90a).
//
// Replaces no TPU kernel. The JAX engine draws its duration and prior noise
// with jax.random; the port drew them per lane from CPU torch.Generators on
// the dispatcher's thread, between the phases of every dispatch. This
// kernel draws a dispatch's noise on the card in one launch a draw, from
// the lanes' seeds, and the noise never crosses from the host.
//
// Semantics (ops/noise.py's normal_plain computes the same in PyTorch):
// out[b, t, c], t < rows, c < channels, element e = t * channels + c of
// lane b, is word e % 4 of Philox4x32-10 (Salmon et al., SC'11; the
// toolkit's curand_Philox4x32_10, curand_philox4x32_x.h) at the counter
// (e / 4 low 32 bits, e / 4 high 32 bits, tag, 0) under the key
// (seed + b low 32 bits, high 32 bits), turned into a normal by Box-Muller:
// the block's words (w0, w1) and (w2, w3) give
//   u = ((w0 >> 8) + 1) * 2^-24 in (0, 1], never 0, so the radius is finite,
//   v = (w1 >> 8) * 2^-24 in [0, 1),
//   z0 = sqrt(-2 log u) cos(2 pi v), z1 = sqrt(-2 log u) sin(2 pi v),
// and z2, z3 likewise. Each element depends only on (seed + b, tag, t, c):
// a draw of n rows is the first n rows of any longer draw of the same
// width, and lane b of a draw at seed s is the one-lane draw at s + b.
// Rows t >= lengths[b] are 0 (no mask when lengths is null). The
// arithmetic is float32 with the accurate logf, sqrtf and sincosf (built
// without --use_fast_math, and no sum for FMA contraction to change); a
// bfloat16 output is the float32 value rounded to nearest even once.
//
// What bounds it on this card: bytes and instructions about equally. The
// engine's largest prior draw, 16 lanes x 1,024 rows x 192 channels,
// writes 12.6 MB: 3.8 us at 3.35 TB/s. Its arithmetic, ~40 integer
// operations of Philox and the accurate logf, sqrtf and sincosf twice for
// 4 normals (~250 instructions), is ~6 M warp instructions: ~7 us for the
// 132 SMs to execute. Either way a draw costs microseconds where the host's
// generators took milliseconds, so the design stays simple.
//
// Design: one thread a Philox block, 4 consecutive elements of a lane, a
// grid of (blocks over the lane's blocks, lanes). A thread stores its 4
// values with one 16-byte (float32) or 8-byte (bfloat16) store where the
// lane's length in elements is a multiple of 4 and the output is aligned,
// element by element otherwise. A block wholly inside the masked rows
// computes no Philox.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <curand_philox4x32_x.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kTwoPow24Inv = 5.9604644775390625e-08f;  // 2^-24, exact

// Box-Muller on one block's 4 words: 4 standard normals.
__device__ __forceinline__ float4 box_muller(uint4 w) {
  const float u0 = static_cast<float>((w.x >> 8) + 1u) * kTwoPow24Inv;
  const float v0 = static_cast<float>(w.y >> 8) * kTwoPow24Inv;
  const float u1 = static_cast<float>((w.z >> 8) + 1u) * kTwoPow24Inv;
  const float v1 = static_cast<float>(w.w >> 8) * kTwoPow24Inv;
  const float r0 = sqrtf(-2.0f * logf(u0));
  const float r1 = sqrtf(-2.0f * logf(u1));
  float s0, c0, s1, c1;
  sincosf(kTwoPi * v0, &s0, &c0);
  sincosf(kTwoPi * v1, &s1, &c1);
  return make_float4(r0 * c0, r0 * s0, r1 * c1, r1 * s1);
}

__device__ __forceinline__ void store4(float* p, const float z[4],
                                       bool vector, int count) {
  if (vector) {
    *reinterpret_cast<float4*>(p) = make_float4(z[0], z[1], z[2], z[3]);
    return;
  }
  for (int j = 0; j < count; ++j) p[j] = z[j];
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float z[4],
                                       bool vector, int count) {
  __nv_bfloat16 h[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) h[j] = __float2bfloat16_rn(z[j]);
  if (vector) {
    __nv_bfloat162 lo, hi;
    lo.x = h[0];
    lo.y = h[1];
    hi.x = h[2];
    hi.y = h[3];
    uint2 bits;
    bits.x = *reinterpret_cast<unsigned*>(&lo);
    bits.y = *reinterpret_cast<unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = bits;
    return;
  }
  for (int j = 0; j < count; ++j) p[j] = h[j];
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    normal_kernel(T* __restrict__ out, const int* __restrict__ lengths,
                  unsigned long long seed, unsigned tag, int rows,
                  int channels, bool vector) {
  const int b = blockIdx.y;
  const long long n = static_cast<long long>(rows) * channels;
  const long long block =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long e0 = block * 4;
  if (e0 >= n) return;
  int valid = rows;
  if (lengths != nullptr) valid = min(max(lengths[b], 0), rows);
  const long long limit = static_cast<long long>(valid) * channels;
  float z[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (e0 < limit) {
    const unsigned long long key = seed + static_cast<unsigned long long>(b);
    const uint4 ctr = make_uint4(static_cast<unsigned>(block),
                                 static_cast<unsigned>(block >> 32), tag, 0u);
    const float4 g = box_muller(curand_Philox4x32_10(
        ctr, make_uint2(static_cast<unsigned>(key),
                        static_cast<unsigned>(key >> 32))));
    z[0] = g.x;
    z[1] = g.y;
    z[2] = g.z;
    z[3] = g.w;
#pragma unroll
    for (int j = 1; j < 4; ++j) {
      if (e0 + j >= limit) z[j] = 0.0f;
    }
  }
  const int count = static_cast<int>(min(4LL, n - e0));
  store4(out + static_cast<long long>(b) * n + e0, z, vector, count);
}

}  // namespace

extern "C" const char* phx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// out: [lanes, rows, channels] float32 (bf16 == 0) or bfloat16 (bf16 != 0);
// lengths: null or [lanes] int32 on the card. Lane b is keyed by seed + b
// (mod 2^64); tag tells one draw of a seed from another (the engine's 0:
// duration noise, 1: prior noise). Returns a cudaError_t (0 on success);
// launches on `stream_ptr`.
extern "C" int noise_normal(void* out, const int* lengths,
                            unsigned long long seed, unsigned tag, int lanes,
                            int rows, int channels, int bf16,
                            void* stream_ptr) {
  if (lanes < 1 || lanes > 65535 || rows < 1 || channels < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n = static_cast<long long>(rows) * channels;
  const long long blocks = (n + 4LL * kThreads - 1) / (4LL * kThreads);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t align = bf16 ? 8 : 16;
  const bool vector =
      n % 4 == 0 && reinterpret_cast<uintptr_t>(out) % align == 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const dim3 grid(static_cast<unsigned>(blocks), lanes);
  if (bf16) {
    normal_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<__nv_bfloat16*>(out), lengths, seed, tag, rows, channels,
        vector);
  } else {
    normal_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<float*>(out), lengths, seed, tag, rows, channels, vector);
  }
  return static_cast<int>(cudaGetLastError());
}
