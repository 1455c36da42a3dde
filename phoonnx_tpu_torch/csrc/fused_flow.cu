// Kernel B: the reverse of the VITS residual coupling flow, for Hopper
// (sm_90a).
//
// Replaces the Pallas kernel phoonnx_tpu/models/vits/fused_flow.py
// (_kernel :217, apply :287): n_flows mean-only couplings in reverse,
// each preceded by a channel flip. A coupling is a 1x1 `pre` conv on the
// pass-through half, an n_layers gated WaveNet (k taps, dilation
// rate**i, optional speaker term g) and a 1x1 `post` conv whose output
// m is subtracted from the coupled half.
//
// What bounds it on this card: float32 operations, on paper. Medium
// preset (half 96, hidden 192, 4 flows x 4 layers, k 5) at T 512 is
// ~7.4 GFLOP against ~29 MB of weights (the 16 in-convs alone are
// 5*192*384 floats each, ~23.6 MB) and ~2 MB of activations; weights and
// activations fit in the 50 MB L2. At batch 1 what limits it in practice
// is how much of the card each step covers and how many steps are chained.
//
// Design: the TPU kernel carries the two halves in VMEM across a
// sequential (batch, flow) grid. Here the whole reverse pass is ONE
// cooperative launch of persistent blocks (persist.cuh). The halves live
// in the output buffer, updated in place flow by flow, and each flow is a
// sequence of phases separated by grid barriers:
//   pre   hbuf = mask * (pre(x_pass) + b); the first flow reads the input
//         and copies it to the output in the same phase;
//   (a)   per WaveNet layer, the dilated in-conv with the gate in its
//         epilogue: the spec interleaves the in-conv's output columns
//         (2c and 2c + 1 are channel c's tanh and sigmoid inputs), so a
//         thread's two adjacent columns are one channel's pair and
//         tanh(a) * sigmoid(b) is taken once, in registers, with the bias
//         and speaker term g added; only the gated [B, T, hidden] acts
//         are stored;
//   (b)   the res/skip projection of the acts, the residual update
//         (masked) and the skip sum in its epilogue (the first layer
//         writes the skip sum, so it needs no zeroing; the last layer
//         emits skip columns only);
//   post  x_coupled = mask * (x_coupled - post(mask * skip) - b).
// The grid barriers between (a) and (b) and after (b) stand in for the
// dilated conv's halo across row tiles. Every phase is a list of 16-row
// output tiles that the blocks stride over, so each covers the card. The
// spec folds the flips into the weights (spec build, as on the TPU), so
// a flip is only a swap of which half is read and which is updated.
// Masking follows the TPU kernel: pre output, each residual update, the
// skip sum and the coupled half are zeroed past the length; the
// pass-through half is never masked.
//
// bfloat16 (built with -DPHX_BF16, persist.cuh): the input, the weights
// and the output are bf16 and everything else is float32, as in the TPU
// kernel (its halves live in float32 scratch across the flows and the
// output is rounded once): the halves are then a float32 scratch `xs`
// beside the output, which the last flow's post phase rounds into it. In
// the float32 build `xs` is the output itself.

#include "persist.cuh"

namespace {

using namespace phx;
using namespace phx::ps;
namespace cg = cooperative_groups;

struct FlowArgs {
  const elem_t* x;
  elem_t* out;
  const int* len;
  const float* g;  // [B, n_flows, n_layers, 2*hidden] (interleaved) or null
  const elem_t* w_pre;
  const elem_t* b_pre;
  const elem_t* w_in;
  const elem_t* b_in;
  const elem_t* w_rs;
  const elem_t* b_rs;
  const elem_t* w_post;
  const elem_t* b_post;
  float* xs;  // the halves [B, T, 2*half] (the output in float32)
  float* hbuf;
  float* acts;
  float* skip;
  long long* stamps;  // phase end times, or null
  int B, T, half, hidden, k, dil_rate, n_layers, n_flows;
};

// One product phase over [B, T] x n_valid outputs (weight columns from
// `base`): epi(b, t, n, v[TN]) gets a thread's adjacent columns n, n+1.
template <class E, class Epi>
__device__ void phase(GemmSmem& sm, const FlowArgs& a, const Conv& cv,
                      int n_valid, int base, const Rows<E>& rows, Epi epi) {
  const int tiles_m = cdiv(a.T, BM);
  const int tiles_n = cdiv(n_valid, BN);
  const int items = tiles_m * tiles_n * a.B;
  const int ty = thread_row();
  const int tx = thread_col();
  for (int w = first_item(items); w < items; w += gridDim.x) {
    const Item it = decode(w, a.B, tiles_m, tiles_n);
    const Cols cols{base, it.tn * BN, n_valid};
    float acc[TM][TN];
    gemm_tile(sm, cv, cols, rows, it.b, it.tm * BM, 0, cv.slabs(), acc);
    const int n = cols.out(tx * TN);
    if (n >= n_valid) continue;
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int t = it.tm * BM + ty * TM + i;
      if (t < a.T) epi(it.b, t, n, acc[i]);
    }
  }
}

__global__ void __launch_bounds__(NT)
flow_persistent(FlowArgs a) {
  __shared__ __align__(16) GemmSmem sm;
  cg::grid_group grid = cg::this_grid();
  const int B = a.B, T = a.T, half = a.half, h = a.hidden;
  const int C = 2 * half;
  const int h2 = 2 * h;
  const int* len = a.len;
  int n_phase = 0;
  auto sync = [&]() {
    grid.sync();
    stamp(a.stamps, ++n_phase);
  };
  stamp(a.stamps, 0);

  for (int f = 0; f < a.n_flows; ++f) {
    // folded flips: even steps read x0 from the high half and couple
    // into the low half
    const bool even = f % 2 == 0;
    const int src = even ? half : 0;
    const int dst = even ? 0 : half;

    // pre (the first flow also copies the input to the halves)
    if (f == 0) {
      const size_t n = (size_t)B * T * C;
      for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < n;
           i += (size_t)gridDim.x * NT)
        a.xs[i] = ld(a.x + i);
    }
    {
      const Conv cv{a.w_pre + (size_t)f * half * h, half, h, 1, 1, 0};
      const elem_t* bias = a.b_pre + (size_t)f * h;
      float* hbuf = a.hbuf;
      const auto epi = [=](int b, int t, int n, const float (&v)[TN]) {
#pragma unroll
        for (int j = 0; j < TN; ++j)
          if (n + j < h)
            hbuf[((size_t)b * T + t) * h + n + j] =
                t < len[b] ? v[j] + ldg_f(bias + n + j) : 0.f;
      };
      if (f == 0)
        phase(sm, a, cv, h, 0, Rows<elem_t>{a.x, T, C, src, nullptr}, epi);
      else
        phase(sm, a, cv, h, 0, Rows<float>{a.xs, T, C, src, nullptr}, epi);
    }
    sync();

    int d = 1;
    for (int i = 0; i < a.n_layers; ++i, d *= a.dil_rate) {
      const size_t fl = (size_t)f * a.n_layers + i;
      // (a) the in-conv's columns interleave the gate's halves (column
      // 2c feeds tanh, 2c + 1 sigmoid, for channel c): a thread's two
      // adjacent columns are one channel's pair
      {
        const Conv cv{a.w_in + fl * a.k * h * h2, h, h2, a.k, d,
                      (a.k * d - d) / 2};
        const elem_t* bias = a.b_in + fl * h2;
        const float* g = a.g;
        const size_t g_stride = (size_t)a.n_flows * a.n_layers * h2;
        float* acts = a.acts;
        phase(sm, a, cv, h2, 0, Rows<float>{a.hbuf, T, h, 0, nullptr},
              [=](int b, int t, int n, const float (&v)[TN]) {
                float za = v[0] + ldg_f(bias + n);
                float zb = v[1] + ldg_f(bias + n + 1);
                if (g != nullptr) {
                  const float* gr = g + b * g_stride + fl * h2;
                  za += __ldg(gr + n);
                  zb += __ldg(gr + n + 1);
                }
                acts[((size_t)b * T + t) * h + n / 2] =
                    tanhf(za) * (1.f / (1.f + expf(-zb)));
              });
      }
      sync();
      // (b) residual (masked) and skip updates; the last layer emits
      // skip columns only
      {
        const bool last = i == a.n_layers - 1;
        const bool first = i == 0;
        const Conv cv{a.w_rs + fl * h * h2, h, h2, 1, 1, 0};
        const elem_t* bias = a.b_rs + fl * h2;
        float* hbuf = a.hbuf;
        float* skip = a.skip;
        const int base = last ? h : 0;
        phase(sm, a, cv, last ? h : h2, base,
              Rows<float>{a.acts, T, h, 0, nullptr},
              [=](int b, int t, int n, const float (&v)[TN]) {
                const size_t row = (size_t)b * T + t;
#pragma unroll
                for (int j = 0; j < TN; ++j) {
                  const int c = base + n + j;
                  if (c >= h2) continue;
                  const float y = v[j] + ldg_f(bias + c);
                  if (c < h) {
                    float* p = hbuf + row * h + c;
                    *p = t < len[b] ? *p + y : 0.f;
                  } else {
                    float* p = skip + row * h + c - h;
                    *p = first ? y : *p + y;
                  }
                }
              });
      }
      sync();
    }

    // post: coupled half = mask * (x1 - m); in bf16 the last flow also
    // rounds both halves into the output (the pass-through half is final
    // and no phase writes it now)
    {
      const Conv cv{a.w_post + (size_t)f * h * half, h, half, 1, 1, 0};
      const elem_t* bias = a.b_post + (size_t)f * half;
      float* xs = a.xs;
      elem_t* out = a.out;
      const bool round_out = !kElemFloat && f == a.n_flows - 1;
      if (round_out) {
        const size_t n = (size_t)B * T * half;
        for (size_t i = (size_t)blockIdx.x * NT + threadIdx.x; i < n;
             i += (size_t)gridDim.x * NT) {
          const size_t e = (i / half) * C + src + i % half;
          st(out + e, xs[e]);
        }
      }
      phase(sm, a, cv, half, 0, Rows<float>{a.skip, T, h, 0, len},
            [=](int b, int t, int n, const float (&v)[TN]) {
#pragma unroll
              for (int j = 0; j < TN; ++j) {
                if (n + j >= half) continue;
                const size_t e = ((size_t)b * T + t) * C + dst + n + j;
                const float y =
                    t < len[b] ? xs[e] - (v[j] + ldg_f(bias + n + j)) : 0.f;
                xs[e] = y;
                if (round_out) st(out + e, y);
              }
            });
    }
    if (f + 1 < a.n_flows || a.stamps != nullptr) sync();
  }
}

}  // namespace

// Blocks of the kernel one SM holds at once, and the SM count (out[0],
// out[1]); returns the CUDA status.
extern "C" int fused_flow_occupancy(int* out) {
  return (int)occupancy(flow_persistent, 0, out);
}

// x [B, T, 2*half] -> out [B, T, 2*half]. g_all [B, n_flows, n_layers,
// 2*hidden] (interleaved as the in-conv's columns) or null. hbuf, acts and skip [B, T, hidden] are
// caller-allocated scratch; stamps, if not null, receives
// n_flows (2 n_layers + 2) + 1 device times (ns): the start and the end
// of each phase. Weights are the stacked spec
// (fused_flow.build_spec), in processing order. grid must not exceed
// what fused_flow_occupancy reports (a cooperative launch is refused
// otherwise).
//
// Tensors are of the build's element type (float32, or bf16 with
// -DPHX_BF16) but for g_all and the scratch, which are float32. xs is
// float32 scratch [B, T, 2*half] in the bf16 build; the float32 build
// takes null and keeps the halves in `out`.
extern "C" int fused_flow_reverse(
    const elem_t* x, elem_t* out, const int* lengths, const float* g_all,
    const elem_t* w_pre, const elem_t* b_pre, const elem_t* w_in,
    const elem_t* b_in, const elem_t* w_rs, const elem_t* b_rs,
    const elem_t* w_post, const elem_t* b_post, float* xs, float* hbuf,
    float* acts, float* skip, long long* stamps, int B, int T, int half,
    int hidden, int k, int dil_rate, int n_layers, int n_flows, int grid,
    void* stream_ptr) {
  float* halves = kElemFloat ? reinterpret_cast<float*>(out) : xs;
  if (halves == nullptr) return (int)cudaErrorInvalidValue;
  const FlowArgs args{x,     out,   lengths, g_all,  w_pre,  b_pre,
                      w_in,  b_in,  w_rs,    b_rs,   w_post, b_post,
                      halves, hbuf, acts,    skip,   stamps, B,      T,
                      half,  hidden, k,      dil_rate, n_layers, n_flows};
  return (int)launch_cooperative(flow_persistent, args, grid, 0,
                                 static_cast<cudaStream_t>(stream_ptr));
}
