// Kernel C's tap convolution, for Hopper (sm_90a): a stride-1 1-D
// convolution over a channels-last [B, T, Cin] tensor in tap form,
//
//   Y[b, t, n] = epi(b, t, n, bias[n] + sum_j sum_c A(b, t + j*dil - pad, c)
//                                                  * W[j, c, n])
//
// with A(b, s, c) = pro(x[b, s, c]) on rows 0 <= s < pro.end(b) and 0
// elsewhere (the conv's zero padding and the masked rows). The prologue
// functor is what the caller applies to the input on load (leaky ReLU),
// the epilogue functor what it applies on store (a residual add, the
// branch mean, the output mask), so no intermediate makes an extra pass
// through device memory.
//
// What bounds it: operations. A decoder stage's convs do 2*k*C^2 FLOP a
// row against 8*C bytes of activations in and out; at C >= 32 that is far
// above the card's ~20 FLOP/byte (3xTF32 rate over the memory rate), so
// the floor is the tensor cores' rate. They take TF32 operands only, and
// the port's contract is float32, so every product is error-compensated
// 3xTF32: each operand x is split into hi = rna_tf32(x) and
// lo = rna_tf32(x - hi), and the sum takes hi*hi + hi*lo + lo*hi in
// float32 (the dropped lo*lo is ~2^-22 relative), about float32's
// accuracy at three tensor-core passes per product.
//
// Design:
// - One block owns BM output rows x BN output columns of one batch
//   element. The reduction runs channel slabs outer, taps inner: for each
//   slab of BK input channels the block stages the window rows
//   [t0 - pad, t0 + BM + (k-1)*dil - pad) once, and every tap reads it
//   shifted by j*dil rows, so an input element is loaded and transformed
//   once per block, not once per tap. The slab's tap weights
//   W[0:k, c0:c0+BK, n0:n0+BN] are staged beside it.
// - Slabs land in a ring of two stages filled with cp.async (16-byte
//   copies where the channel count is a multiple of 4), so the next slab
//   loads while this one is multiplied.
// - The prologue and the hi/lo split are applied once per window element
//   when its slab has landed (hi in place, lo beside it): the window is
//   read by all k taps and every warp column, so splitting at fragment
//   load would repeat both k times. Weights are split at fragment load:
//   each is read by the block's warp rows only (1-4 times), which costs
//   less than a pass over the slab and its barrier.
// - Warps multiply 32 x WN tiles with mma.sync m16n8k8 TF32, the A
//   fragments from ldmatrix, the three passes interleaved over the warp's
//   fragments so a product never waits on the one before it. Shared-memory
//   pitches (BK + 4 for the window, BN + 8 for the weights) put the lanes
//   of every fragment load on different banks.
// - Each accumulator element goes through the epilogue functor with its
//   bias: no split-K and no atomics, so repeated calls are bit-identical.
//   The functor loads what a fragment's stores read before any of them
//   (load, then store): called element by element, each load waited for
//   the store before it, which cost ~10 % of the convs' time on an H100
//   80GB HBM3 at 700 W (PERF.md).
// - The tile (BM, BN, warp width WN) and BK are chosen on the host side of
//   the launch from (B, T, C, k, dil) and the SM count (tap_tile, mirrored
//   by phoonnx_tpu_torch/tiling.py): the largest tile whose grid gives
//   every SM at least two blocks, and 16-channel slabs where the ring
//   still lets four blocks share an SM (else 8): at three, a 512-block
//   grid ran in two waves and its convs took up to 2.3x as long (same
//   card).
//
// bfloat16 (built with -DPHX_BF16, elem.cuh): the window, the weights and
// the outputs are bf16 in device memory. A bf16 value is exactly a TF32
// one (8 significant bits against 10) and the TPU kernel rounds each
// leaky-ReLU activation to bf16 before its products, so every lo half is
// 0 and ONE TF32 pass gives exact products with a float32 sum. The slabs
// land in bf16 (cp.async of 8 elements where the channels allow; the
// ring holds the raw window and the weights in bf16); the transform
// writes round_bf16(pro(x)) as float32 into one hi buffer after the
// ring, where float32 keeps lo; the weights become TF32 operands at
// fragment load (a shift of their bits). The epilogues round where the
// TPU kernel stores in bf16: each conv output, each residual sum, the
// branch sum and mean, and the audio.
//
// Not yet: one persistent launch per stage (each conv is one launch); a
// native bf16 mma.sync m16n8k16 path for the bf16 build.

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "elem.cuh"

namespace phx {

constexpr int TAP_STAGES = 2;        // slabs in the cp.async ring
constexpr int TAP_WARP_ROWS = 32;    // rows of a warp tile: two m16 fragments
constexpr int TAP_MIN_BLOCKS_PER_SM = 2;
constexpr int TAP_SMEM_LIMIT = 227 * 1024;  // what a block may use
constexpr int TAP_SMEM_TARGET = TAP_SMEM_LIMIT / 4;  // 4 blocks an SM

// Tile shapes (rows, columns, warp columns). Per output-width class, the
// candidates from the largest tile down (tiling.TAP_TILES).
struct TapShape {
  int bm, bn, wn;
};
constexpr TapShape TAP_SHAPES[] = {
    {64, 64, 32}, {32, 64, 32}, {32, 32, 16},   // C >= 64
    {128, 32, 32}, {64, 32, 32}, {32, 32, 16},  // 16 < C < 64 (as 32)
    {128, 16, 16}, {64, 16, 16}, {32, 16, 16},  // C <= 16
};
constexpr int TAP_CANDIDATES = 3;

struct TapTile {
  int shape;  // index into TAP_SHAPES
  int bk;     // channels of a slab: 8 or 16
  size_t smem;
};

__host__ __device__ inline int tap_cdiv(int a, int b) {
  return (a + b - 1) / b;
}

__host__ __device__ inline int tap_window_rows(int bm, int taps, int dil) {
  return bm + (taps - 1) * dil;
}

// Dynamic shared memory of a block: the ring of (window, weights) slabs
// and the window's lo half. (The bf16 build's ring of bf16 slabs and its
// float32 hi window take less; it is given the same.)
__host__ __device__ inline size_t tap_smem_bytes(int bm, int bn, int bk,
                                                 int taps, int dil) {
  const size_t win = (size_t)tap_window_rows(bm, taps, dil) * (bk + 4);
  const size_t wts = (size_t)taps * bk * (bn + 8);
  return sizeof(float) * ((TAP_STAGES + 1) * win + TAP_STAGES * wts);
}

inline int tap_class(int n) {
  const int padded = tap_cdiv(n, 16) * 16;
  return padded >= 64 ? 0 : padded >= 32 ? 1 : 2;
}

// The tile of a conv with `n` output channels (tiling.tap_tile): the
// first candidate of its class whose grid gives every SM
// TAP_MIN_BLOCKS_PER_SM blocks (else the smallest); BK 16 where the
// channels exceed 8 and the ring fits TAP_SMEM_TARGET, else 8; a smaller
// tile while the ring exceeds TAP_SMEM_LIMIT. False if none fits.
inline bool tap_tile(int B, int T, int n, int taps, int dil, int sms,
                     TapTile* tile) {
  const int first = TAP_CANDIDATES * tap_class(n);
  int pick = first + TAP_CANDIDATES - 1;
  for (int i = first; i < first + TAP_CANDIDATES; ++i) {
    const TapShape& s = TAP_SHAPES[i];
    if ((long long)B * tap_cdiv(T, s.bm) * tap_cdiv(n, s.bn) >=
        (long long)TAP_MIN_BLOCKS_PER_SM * sms) {
      pick = i;
      break;
    }
  }
  for (int i = pick; i < first + TAP_CANDIDATES; ++i) {
    const TapShape& s = TAP_SHAPES[i];
    const size_t deep = tap_smem_bytes(s.bm, s.bn, 16, taps, dil);
    const size_t shallow = tap_smem_bytes(s.bm, s.bn, 8, taps, dil);
    if (n > 8 && deep <= (size_t)TAP_SMEM_TARGET) {
      *tile = {i, 16, deep};
      return true;
    }
    if (shallow <= (size_t)TAP_SMEM_LIMIT) {
      *tile = {i, 8, shallow};
      return true;
    }
  }
  return false;
}

// ---- device helpers ---------------------------------------------------

__device__ __forceinline__ void tap_cp16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void tap_cp4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void tap_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void tap_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Copy src[0..3] to dst[0..3], of which the first `n` exist (n <= 0:
// none); the rest are zero-filled.
__device__ __forceinline__ void tap_copy4(float* dst, const float* src,
                                          int n) {
  if (n >= 4 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    tap_cp16(dst, src);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    if (e < n)
      tap_cp4(dst + e, src + e);
    else
      dst[e] = 0.f;
  }
}

// Copy 8 two-byte elements (bf16) src[0..7] to dst[0..7] (16-byte
// aligned), of which the first `n` exist; the rest are zero-filled. (A
// template so that the float32 build, which never calls it, compiles the
// bf16 branches it discards.)
template <class E>
__device__ __forceinline__ void tap_copy8(E* dst, const E* src, int n) {
  if (n >= 8 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    tap_cp16(dst, src);
    return;
  }
  const unsigned short* s = reinterpret_cast<const unsigned short*>(src);
  unsigned short* d = reinterpret_cast<unsigned short*>(dst);
#pragma unroll
  for (int e = 0; e < 8; ++e) d[e] = e < n ? __ldcg(s + e) : 0;
}

// x = hi + lo to ~2^-22 relative, hi = cvt.rna.tf32.f32(x) and
// lo = cvt.rna.tf32.f32(x - hi) for finite x: half a TF32 ulp added to
// the magnitude bits rounds to nearest, ties away from zero, and the
// tensor cores ignore an operand's 13 low bits, so only the hi that is
// subtracted needs them cleared. (The compiler lowers cvt.rna the same
// way, with a test for inf and NaN around it that costs two more
// instructions an operand; an inf input gives NaN here.)
__device__ __forceinline__ void tf32_split(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// d += a * b on the tensor cores, m16n8k8, TF32 operands, f32 sum
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// An m16k8 TF32 A fragment {(g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4)}
// in one instruction: the four 8x8 b16 matrices of ldmatrix are four 8-row
// x 4-word blocks, and lane l receives word l % 4 of row l / 4 of each.
// `p` is this lane's row address: rows l % 8 + 8 * (l / 8 % 2), words
// 4 * (l / 16) of the fragment.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const float* p) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(s)
      : "memory");
}

__device__ __forceinline__ int tap_log2(int v) { return 31 - __clz(v); }

// ---- the kernel ------------------------------------------------------------

// Shared memory (float32): stage s holds the window [R][BK + 4] (raw,
// then hi in place) and the weights [k][BK][BN + 8]; after the stages,
// the window's lo half [R][BK + 4]. (bf16: stage s holds the raw window
// [R][BK + 8] and the weights [k][BK][BN + 8] in bf16; after the stages,
// the window's hi [R][BK + 4] in float32.) Rows of the window are global
// rows t0 - pad + r.
template <int BM, int BN, int WN, class Pro, class Epi>
__global__ void __launch_bounds__((BM / TAP_WARP_ROWS) * (BN / WN) * 32)
tapconv_kernel(const elem_t* __restrict__ W, const elem_t* __restrict__ bias,
               int T, int Cin, int N, int J, int dil, int pad, int bk,
               Pro pro, Epi epi) {
  constexpr int WARPS_N = BN / WN;
  constexpr int NTHREADS = (BM / TAP_WARP_ROWS) * WARPS_N * 32;
  constexpr int MT = TAP_WARP_ROWS / 16;  // m16 fragments of a warp tile
  constexpr int NT = WN / 8;              // n8 fragments of a warp tile
  constexpr int BP = BN + 8;              // weight row pitch
  constexpr int NCH = BN / 4;             // 16-byte chunks of a weight row
  extern __shared__ __align__(16) float smem[];

  const int R = tap_window_rows(BM, J, dil);
  const int ap = bk + 4;  // window row pitch (float32)
  const int rp = bk + 8;  // raw window row pitch (bf16)
  const int log_bk = tap_log2(bk);
  const int win = R * ap;
  // a stage in floats (the bf16 one is even: rp and BP are)
  const int stage = kElemFloat ? win + J * bk * BP : (R * rp + J * bk * BP) / 2;
  // float32: the window's lo half; bf16: its hi
  float* lo = smem + TAP_STAGES * stage;

  const int b = blockIdx.z;
  const int t0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;  // fragment row group
  const int q = lane & 3;   // thread in group
  const int wm0 = (warp / WARPS_N) * TAP_WARP_ROWS;
  const int wn0 = (warp % WARPS_N) * WN;
  const int s0 = t0 - pad;  // global row of window row 0
  const int end = pro.end(b);
  const int slabs = tap_cdiv(Cin, bk);
  const elem_t* xb = pro.x + (size_t)b * T * Cin;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  // window rows outside [0, end) are not copied: the transform zeroes them
  auto fetch = [&](int slab) {
    if constexpr (!kElemFloat) {
      if (slab < slabs) {
        elem_t* raw = reinterpret_cast<elem_t*>(smem + (slab % TAP_STAGES) * stage);
        elem_t* wbf = raw + R * rp;
        const int c0 = slab * bk;
        const int log_cw = log_bk - 3;  // 8-element chunks of a window row
        for (int i = tid; i < (R << log_cw); i += NTHREADS) {
          const int r = i >> log_cw;
          const int k = (i & ((1 << log_cw) - 1)) * 8;
          const int s = s0 + r;
          if (s < 0 || s >= end) continue;
          tap_copy8(raw + r * rp + k, xb + (size_t)s * Cin + c0 + k,
                    Cin - c0 - k);
        }
        for (int i = tid; i < ((J * (BN / 8)) << log_bk); i += NTHREADS) {
          const int n = (i % (BN / 8)) * 8;
          const int jk = i / (BN / 8);  // tap * bk + channel in the slab
          const int j = jk >> log_bk;
          const int c = c0 + (jk & (bk - 1));
          tap_copy8(wbf + jk * BP + n, W + ((size_t)j * Cin + c) * N + n0 + n,
                    c < Cin ? N - n0 - n : 0);
        }
      }
      tap_commit();
      return;
    }
    if (slab < slabs) {
      float* wbuf = smem + (slab % TAP_STAGES) * stage;
      float* bbuf = wbuf + win;
      const int c0 = slab * bk;
      const int log_cw = log_bk - 2;  // 16-byte chunks of a window row
      for (int i = tid; i < (R << log_cw); i += NTHREADS) {
        const int r = i >> log_cw;
        const int k = (i & ((1 << log_cw) - 1)) * 4;
        const int s = s0 + r;
        if (s < 0 || s >= end) continue;
        tap_copy4(wbuf + r * ap + k,
                  reinterpret_cast<const float*>(xb) + (size_t)s * Cin + c0 + k,
                  Cin - c0 - k);
      }
      for (int i = tid; i < ((J * NCH) << log_bk); i += NTHREADS) {
        const int n = (i % NCH) * 4;
        const int jk = i / NCH;  // tap * bk + channel in the slab
        const int j = jk >> log_bk;
        const int c = c0 + (jk & (bk - 1));
        tap_copy4(bbuf + jk * BP + n,
                  reinterpret_cast<const float*>(W) + ((size_t)j * Cin + c) * N
                      + n0 + n,
                  c < Cin ? N - n0 - n : 0);
      }
    }
    tap_commit();
  };

  // the prologue and the hi/lo split, once per window element (bf16: the
  // prologue rounded to bf16, as float32 into hi; no lo)
  auto transform = [&](int slab) {
    if constexpr (!kElemFloat) {
      const elem_t* raw = reinterpret_cast<const elem_t*>(smem + (slab % TAP_STAGES) * stage);
      const int c0 = slab * bk;
      for (int i = tid; i < (R << log_bk); i += NTHREADS) {
        const int r = i >> log_bk;
        const int k = i & (bk - 1);
        const int s = s0 + r;
        float v = 0.f;
        if (s >= 0 && s < end && c0 + k < Cin)
          v = round_elem(pro(to_f(raw[r * rp + k])));
        lo[r * ap + k] = v;
      }
      return;
    }
    float* wbuf = smem + (slab % TAP_STAGES) * stage;
    const int c0 = slab * bk;
    for (int i = tid; i < (R << log_bk); i += NTHREADS) {
      const int r = i >> log_bk;
      const int k = i & (bk - 1);
      const int s = s0 + r;
      float v = 0.f;
      if (s >= 0 && s < end && c0 + k < Cin) v = pro(wbuf[r * ap + k]);
      uint32_t h, l;
      tf32_split(v, h, l);
      wbuf[r * ap + k] = __uint_as_float(h);
      lo[r * ap + k] = __uint_as_float(l);
    }
  };

  // this lane's ldmatrix row and column within a fragment
  const int lrow = (lane & 7) + 8 * ((lane >> 3) & 1);
  const int lcol = 4 * (lane >> 4);
  auto compute = [&](int slab) {
    if constexpr (!kElemFloat) {
      // one TF32 pass: hi holds bf16 values, the weights are bf16
      const unsigned short* wb = reinterpret_cast<const unsigned short*>(
          smem + (slab % TAP_STAGES) * stage) + R * rp;
      for (int j = 0; j < J; ++j) {
        const int row = wm0 + lrow + j * dil;
        for (int kk = 0; kk < bk; kk += 8) {
          uint32_t ah[MT][4], bh[NT][2];
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
            ldsm_x4(ah[mt], lo + (row + mt * 16) * ap + kk + lcol);
          const unsigned short* wk = wb + (j * bk + kk + q) * BP + wn0 + g;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            bh[nt][0] = static_cast<uint32_t>(wk[nt * 8]) << 16;
            bh[nt][1] = static_cast<uint32_t>(wk[nt * 8 + 4 * BP]) << 16;
          }
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
        }
      }
      return;
    }
    const float* hi = smem + (slab % TAP_STAGES) * stage;
    const float* wb = hi + win;
    for (int j = 0; j < J; ++j) {
      const int row = wm0 + lrow + j * dil;
      for (int kk = 0; kk < bk; kk += 8) {
        uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int o = (row + mt * 16) * ap + kk + lcol;
          ldsm_x4(ah[mt], hi + o);
          ldsm_x4(al[mt], lo + o);
        }
        const float* wk = wb + (j * bk + kk + q) * BP + wn0 + g;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          tf32_split(wk[nt * 8], bh[nt][0], bl[nt][0]);
          tf32_split(wk[nt * 8 + 4 * BP], bh[nt][1], bl[nt][1]);
        }
        // the three passes in turn, so each accumulator's next product
        // waits behind MT * NT independent ones, not behind its last
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[mt][nt], al[mt], bh[nt]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
      }
    }
  };

  fetch(0);
  for (int slab = 0; slab < slabs; ++slab) {
    tap_wait_all();
    __syncthreads();  // slab is in; every warp is done with slab - 1
    fetch(slab + 1);  // into the stage slab - 1 used
    transform(slab);
    __syncthreads();
    compute(slab);
  }

  // per m16 fragment, every load the stores need, then the stores: the
  // output may alias what the epilogue reads as far as the compiler
  // knows, so a load after a store would wait for it
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float2 in[2][NT][2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + wm0 + mt * 16 + g + 8 * h;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn0 + nt * 8 + 2 * q + e;
          in[h][nt][e] =
              t < T && n < N ? epi.load(b, t, n) : float2{0.f, 0.f};
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = t0 + wm0 + mt * 16 + g + 8 * h;
      if (t >= T) continue;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + wn0 + nt * 8 + 2 * q + e;
          if (n < N)
            epi.store(b, t, n,
                      acc[mt][nt][2 * h + e] +
                          (bias != nullptr ? to_f(bias[n]) : 0.f),
                      in[h][nt][e]);
        }
    }
  }
}

template <int BM, int BN, int WN, class Pro, class Epi>
cudaError_t tapconv_launch(const TapTile& tile, const elem_t* W,
                           const elem_t* bias, int B, int T, int Cin, int N,
                           int J, int dil, int pad, Pro pro, Epi epi,
                           cudaStream_t stream) {
  auto kernel = tapconv_kernel<BM, BN, WN, Pro, Epi>;
  if (tile.smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)tile.smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(tap_cdiv(T, BM), tap_cdiv(N, BN), B);
  kernel<<<grid, (BM / TAP_WARP_ROWS) * (BN / WN) * 32, tile.smem, stream>>>(
      W, bias, T, Cin, N, J, dil, pad, tile.bk, pro, epi);
  return cudaGetLastError();
}

// One conv on `stream` over a [B, T] x N output, with the tile tap_tile
// chose; returns the launch status.
template <class Pro, class Epi>
cudaError_t tapconv(const TapTile& tile, const elem_t* W, const elem_t* bias,
                    int B, int T, int Cin, int N, int J, int dil, int pad,
                    Pro pro, Epi epi, cudaStream_t stream) {
#define PHX_TAP_CASE(i)                                                     \
  case i:                                                                   \
    return tapconv_launch<TAP_SHAPES[i].bm, TAP_SHAPES[i].bn,               \
                          TAP_SHAPES[i].wn>(tile, W, bias, B, T, Cin, N, J, \
                                            dil, pad, pro, epi, stream);
  switch (tile.shape) {
    PHX_TAP_CASE(0)
    PHX_TAP_CASE(1)
    PHX_TAP_CASE(2)
    PHX_TAP_CASE(3)
    PHX_TAP_CASE(4)
    PHX_TAP_CASE(5)
    PHX_TAP_CASE(6)
    PHX_TAP_CASE(7)
    PHX_TAP_CASE(8)
  }
#undef PHX_TAP_CASE
  return cudaErrorInvalidValue;
}

// Epilogue functors take an output element in two calls: load(b, t, n)
// returns what its store reads (up to two values), store(b, t, n, v, in)
// writes it, v being the conv's sum with its bias.

// Y = v
struct StoreEpi {
  elem_t* y;
  int T, ld;
  __device__ float2 load(int, int, int) const { return {0.f, 0.f}; }
  __device__ void store(int b, int t, int n, float v, float2) const {
    st(y + ((size_t)b * T + t) * ld + n, v);
  }
};

}  // namespace phx

extern "C" const char* phx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

#define PHX_TRY(expr)                                  \
  do {                                                 \
    const cudaError_t phx_err_ = (expr);               \
    if (phx_err_ != cudaSuccess) return (int)phx_err_; \
  } while (0)
