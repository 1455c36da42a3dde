// Shared device code for the port's persistent (one-launch) kernels.
//
// Kernels A (fused_encoder.cu) and B (fused_flow.cu) each run a whole
// layer stack in one cooperative launch: a grid of persistent blocks,
// sized from the occupancy calculator to what the card holds at once,
// walks a sequence of phases separated by grid barriers
// (cooperative_groups::this_grid().sync()). Within a phase the blocks
// take a list of small output tiles (first_item spreads them over the
// grid), so every phase covers all SMs however short the sequence; the
// activations between phases stay in caller-allocated scratch that L2
// holds.
//
// gemm_tile computes one BM x BN output tile of a stride-1 1-D
// convolution over a channels-last [B, T, Cin] tensor in tap form,
//
//   acc[t, n] = sum_{q in [q0, q1)} sum_{c in slab q}
//                   A(b, t + j_q*dil - pad, c) * W[j_q, c, base + n0 + n]
//
// where the reduction over (tap, channel) is cut into BK-deep slabs q
// (slab q is tap q / CS, channels (q % CS) * BK + [0, BK), CS =
// ceil(Cin / BK)). A slab range [q0, q1) shorter than the whole is one
// split-K part. A(b, s, c) is row s of the activation (Rows), or 0
// outside [0, T) (the conv's zero padding) and past the row's length.
// Activation and weight slabs are staged with cp.async (zero-filled past
// the conv's edges and the rows' lengths) in a ring of NS slabs, so the
// next three slabs load while one is multiplied. Each of the NT threads
// holds a TM x TN register tile: rows ty*TM + i, columns tx*TN + j
// (adjacent, so a warp reads a slab row as one 128-byte line).
// Arithmetic is float32 FMA on the SIMT cores.
//
// The work partition (tile order, split-K parts, tiles to blocks) is
// mirrored by phoonnx_tpu_torch/tiling.py, which chooses the split
// factors and the grid and whose tests check that the tiles cover every
// output once.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace phx {
namespace ps {

constexpr int NT = 128;  // threads of a persistent block
constexpr int BM = 16;   // output rows of a tile
constexpr int BN = 32;   // output columns of a tile
constexpr int BK = 32;   // reduction depth of a slab
constexpr int NS = 4;    // slabs in the ring: NS - 1 load while one is used
constexpr int TM = 2;
constexpr int TN = 2;
constexpr int TX = BN / TN;  // 16 thread columns
constexpr int TY = BM / TM;  // 8 thread rows
constexpr int AK = BK + 4;   // row pitch of the activation slab (16 B rows)
constexpr int A_CHUNKS = BM * BK / 4 / NT;
constexpr int B_CHUNKS = BK * BN / 4 / NT;
static_assert(TX * TY == NT && TM == 2 && TN == 2, "thread tile");
static_assert(A_CHUNKS * NT * 4 == BM * BK && B_CHUNKS * NT * 4 == BK * BN,
              "whole 16-byte chunks a thread");

struct GemmSmem {
  float A[NS][BM][AK];
  float B[NS][BK][BN];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy 4 floats src[0..3] to dst[0..3], of which the first `n` exist
// (n <= 0: none); the rest are zero-filled.
__device__ __forceinline__ void copy4(float* dst, const float* src, int n) {
  if (n >= 4 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(dst, src);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (e < n)
      cp_async4(dst + e, src + e);
    else
      dst[e] = 0.f;
  }
}

// A buffer another block wrote earlier in the same launch: read through
// L2 only (never the read-only path, which is not coherent within a
// launch).
__device__ __forceinline__ float ld(const float* p) { return __ldcg(p); }

// The activation operand: row s of batch element b is
// x[(b * T + s) * pitch + coff + c] for c < Cin, or all zeros when
// s >= len[b] (len null: no row is masked). Rows outside [0, T) are the
// conv's zero padding.
struct Rows {
  const float* x;
  int T, pitch, coff;
  const int* len;
  __device__ const float* row(int b, int s) const {
    if (s < 0 || s >= T || (len != nullptr && s >= len[b])) return nullptr;
    return x + ((size_t)b * T + s) * pitch + coff;
  }
};

// Column map of a tile: smem column n is output column n0 + n, at global
// column base + n0 + n of the weights. Output columns >= n_valid are
// padding.
struct Cols {
  int base, n0, n_valid;
  __device__ int out(int n) const { return n0 + n; }
};

// One product: W is [J, Cin, ldw] row-major.
struct Conv {
  const float* W;
  int Cin, ldw, J, dil, pad;
  __device__ int slabs() const { return J * ((Cin + BK - 1) / BK); }
};

__device__ __forceinline__ int thread_row() { return threadIdx.x / TX; }
__device__ __forceinline__ int thread_col() { return threadIdx.x % TX; }

// acc = the tile's product over slabs [q0, q1), a ring of NS slabs in
// flight. Ends with a block barrier, so the shared buffers are free for
// the next tile when it returns.
__device__ void gemm_tile(GemmSmem& sm, const Conv& cv, const Cols& cols,
                          const Rows& rows, int b, int t0, int q0, int q1,
                          float (&acc)[TM][TN]) {
  const int tid = threadIdx.x;
  const int ty = thread_row();
  const int tx = thread_col();
  const int cs = (cv.Cin + BK - 1) / BK;
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  auto fetch = [&](int q) {
    if (q < q1) {
      const int buf = (q - q0) % NS;
      const int j = q / cs;
      const int c0 = (q % cs) * BK;
#pragma unroll
      for (int r = 0; r < A_CHUNKS; ++r) {
        const int id = tid + r * NT;
        const int m = id / (BK / 4);
        const int k = (id % (BK / 4)) * 4;
        const float* src = rows.row(b, t0 + m + j * cv.dil - cv.pad);
        copy4(&sm.A[buf][m][k], src + c0 + k,
              src == nullptr ? 0 : cv.Cin - c0 - k);
      }
      const float* wj = cv.W + (size_t)j * cv.Cin * cv.ldw;
#pragma unroll
      for (int r = 0; r < B_CHUNKS; ++r) {
        const int id = tid + r * NT;
        const int k = id / (BN / 4);
        const int n = (id % (BN / 4)) * 4;
        const int c = c0 + k;
        copy4(&sm.B[buf][k][n], wj + (size_t)c * cv.ldw + cols.base + cols.n0 + n,
              c < cv.Cin ? cols.n_valid - cols.n0 - n : 0);
      }
    }
    cp_commit();  // empty past q1: every thread counts the same groups
  };

#pragma unroll
  for (int st = 0; st < NS - 1; ++st) fetch(q0 + st);
  for (int q = q0; q < q1; ++q) {
    cp_wait<NS - 2>();
    __syncthreads();  // slab q is in; slab q - 1's buffer is free
    fetch(q + NS - 1);
    const int buf = (q - q0) % NS;
#pragma unroll
    for (int k = 0; k < BK; k += 4) {
      float4 av[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i)
        av[i] = *reinterpret_cast<const float4*>(&sm.A[buf][ty * TM + i][k]);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float2 w = *reinterpret_cast<const float2*>(&sm.B[buf][k + kk][tx * TN]);
        const float wv[TN] = {w.x, w.y};
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          const float a = kk == 0 ? av[i].x : kk == 1 ? av[i].y
                         : kk == 2 ? av[i].z : av[i].w;
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a, wv[j], acc[i][j]);
        }
      }
    }
  }
  cp_wait<0>();
  __syncthreads();
}

// Item w of a phase of tiles_m x tiles_n tiles per batch element and
// `splits` split-K parts, in the order tiling.work_items lists them.
struct Item {
  int s, b, tm, tn;
};

__device__ __forceinline__ Item decode(int w, int B, int tiles_m,
                                       int tiles_n) {
  Item it;
  it.tn = w % tiles_n;
  w /= tiles_n;
  it.tm = w % tiles_m;
  w /= tiles_m;
  it.b = w % B;
  it.s = w / B;
  return it;
}

__device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// The first of this block's items in a phase of `items` work items; the
// next are `gridDim.x` apart. With fewer items than blocks, item w goes to
// block w * grid / items, so the items spread over the whole grid: the
// card places blocks of nearby indices on the same SMs, and items on
// blocks 0, 1, 2, ... would crowd a few SMs (tiling.first_item).
__device__ __forceinline__ int first_item(int items) {
  const int g = gridDim.x;
  const int b = blockIdx.x;
  if (items >= g) return b;
  const int w = (int)(((long long)b * items + g - 1) / g);
  return w < items && (int)((long long)w * g / items) == b ? w : items;
}

// With a trace buffer (phase times), thread 0 of block 0 notes the
// device clock (ns) as stamps[i]: the kernels stamp 0 at their start and
// i after the grid barrier that ends phase i.
__device__ __forceinline__ void stamp(long long* stamps, int i) {
  if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[i] = t;
  }
}

// n grid barriers and nothing else: what one barrier costs at a grid size
__global__ void __launch_bounds__(NT) barrier_probe(int n) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  for (int i = 0; i < n; ++i) grid.sync();
}

// Launch `kernel(args)` cooperatively on `stream` with `grid` blocks of NT
// threads and `smem` bytes of dynamic shared memory.
template <class Args>
cudaError_t launch_cooperative(void (*kernel)(Args), Args args, int grid,
                               size_t smem, cudaStream_t stream) {
  void* params[] = {&args};
  return cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                     dim3(grid), dim3(NT), params, smem,
                                     stream);
}

// Blocks of `kernel` that fit on one SM at once with `smem` bytes of
// dynamic shared memory, and the SM count: out[0], out[1].
template <class Args>
cudaError_t occupancy(void (*kernel)(Args), size_t smem, int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&out[0], kernel, NT,
                                                      smem);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(&out[1], cudaDevAttrMultiProcessorCount, dev);
}

}  // namespace ps
}  // namespace phx

// n grid barriers of `grid` blocks, one cooperative launch on `stream`
extern "C" int phx_barrier_probe(int n, int grid, void* stream) {
  return (int)phx::ps::launch_cooperative(phx::ps::barrier_probe, n, grid, 0,
                                          static_cast<cudaStream_t>(stream));
}

extern "C" const char* phx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#define PHX_TRY(expr)                                  \
  do {                                                 \
    const cudaError_t phx_err_ = (expr);               \
    if (phx_err_ != cudaSuccess) return (int)phx_err_; \
  } while (0)
