// Kernel D: monotonic alignment search (MAS), for Hopper (sm_90a).
//
// Replaces the Pallas kernel phoonnx_tpu/ops/mas_pallas.py (_mas_kernel
// :36, called through maximum_path_pallas :172 from ops/mas.py:37): per
// batch element, a forward max-plus DP over the spec frames of a
// [T_y, T_x] score plane, then a backtrack that writes the 0/1 path.
//
// Semantics, bit for bit those of the JAX scan (ops/mas.py:82-112):
//   q[y, x] = value[y, x] + max(stay, advance), in float32, where
//   stay    = -1e9 if x == y else q[y-1, x]
//   advance = (y == 0 ? 0 : -1e9) if x == 0 else q[y-1, x-1]
// over the full grid, with q[-1, :] = -1e9 (-1e9 is exact in float32).
// The backtrack starts at x_len - 1 from y = T_y - 1, marks only rows
// y < y_len, and steps to x - 1 iff x != 0 and (x == y or
// q[y-1, x] < q[y-1, x-1]) strictly, so a tie stays. fmaxf would drop a
// NaN where jnp.maximum propagates it; the scores are finite (products
// of finite priors and latents), so nothing emulates that.
//
// What bounds it on this card: bytes. At the medium training shape
// (batch 16, T_y 832, T_x 320) the function reads 17 MB of scores and
// writes a 17 MB path, ~10 us at 3.35 TB/s; its ~2 float32 operations a
// cell are ~0.1 us at 67 TFLOP/s.
//
// Design: one block per batch element (the TPU grid walks the batch in
// order; here the blocks run side by side). Threads stride over x. The
// previous DP row sits in shared memory, double-buffered, so each spec
// frame costs one __syncthreads(). Every row is also written to a global
// scratch [B, T_y, T_x] (17 MB at the medium shape, held by L2), which the
// backtrack reads. The block zeroes its path plane, synchronises, and one
// thread backtracks. Only B of 132 SMs work, and the forward is a chain
// of T_y dependent rows, so the kernel runs at the latency of that chain,
// far above its bound; a later PR can keep only the decision bits and
// overlap batch elements within an SM.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e9f;
constexpr int kMaxThreads = 1024;

__global__ void mas_kernel(const float* __restrict__ value,
                           const int* __restrict__ y_lens,
                           const int* __restrict__ x_lens,
                           float* __restrict__ path, float* __restrict__ q,
                           int t_y, int t_x) {
  extern __shared__ float rows[];  // [2, t_x]: previous and current row
  const int b = blockIdx.x;
  const size_t plane = static_cast<size_t>(t_y) * t_x;
  const float* v = value + b * plane;
  float* qb = q + b * plane;
  float* pb = path + b * plane;
  float* prev = rows;
  float* cur = rows + t_x;

  for (int x = threadIdx.x; x < t_x; x += blockDim.x) prev[x] = kNegInf;
  __syncthreads();

  // forward DP: one synchronisation a row, rows double-buffered
  for (int y = 0; y < t_y; ++y) {
    const float* vrow = v + static_cast<size_t>(y) * t_x;
    float* qrow = qb + static_cast<size_t>(y) * t_x;
    for (int x = threadIdx.x; x < t_x; x += blockDim.x) {
      const float stay = (x == y) ? kNegInf : prev[x];
      const float advance =
          (x == 0) ? (y == 0 ? 0.f : kNegInf) : prev[x - 1];
      const float s = vrow[x] + fmaxf(stay, advance);
      cur[x] = s;
      qrow[x] = s;
    }
    __syncthreads();
    float* swap = prev;
    prev = cur;
    cur = swap;
  }

  for (size_t i = threadIdx.x; i < plane; i += blockDim.x) pb[i] = 0.f;
  // the barrier also makes every thread's scores visible to thread 0
  __syncthreads();

  if (threadIdx.x == 0) {
    const int y_len = y_lens[b];
    int x = min(max(x_lens[b], 1), t_x) - 1;
    for (int y = t_y - 1; y >= 0; --y) {
      const bool inside = y < y_len;
      if (inside) pb[static_cast<size_t>(y) * t_x + x] = 1.f;
      const float* qp = qb + static_cast<size_t>(y > 0 ? y - 1 : 0) * t_x;
      const float q_stay = qp[x];
      const float q_diag = qp[x > 0 ? x - 1 : 0];
      const bool advance = x != 0 && (x == y || q_stay < q_diag);
      if (inside && y > 0 && advance) --x;
    }
  }
}

}  // namespace

extern "C" const char* phx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// value, path, q: [B, T_y, T_x] float32; y_lens, x_lens: [B] int32.
// Returns a cudaError_t (0 on success); launches on `stream_ptr`.
extern "C" int mas_path(const float* value, const int* y_lens,
                        const int* x_lens, float* path, float* q, int B,
                        int T_y, int T_x, void* stream_ptr) {
  if (B <= 0 || T_y <= 0 || T_x <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t smem = 2 * sizeof(float) * static_cast<size_t>(T_x);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int threads = min(kMaxThreads, ((T_x + 31) / 32) * 32);
  mas_kernel<<<B, threads, smem, stream>>>(value, y_lens, x_lens, path, q,
                                           T_y, T_x);
  return static_cast<int>(cudaGetLastError());
}
