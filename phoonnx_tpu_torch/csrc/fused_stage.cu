// Kernel C: one HiFi-GAN decoder stage's resblock group, for Hopper
// (sm_90a), with the generator's tail as an optional epilogue.
//
// Replaces the Pallas kernel phoonnx_tpu/models/vits/fused_stage.py
// (_kernel :250, _compute_group :305, apply_group :417): the mean over
// the stage's residual branches of dilated convs with leaky ReLU 0.1,
// every activation masked to [0, valid), the output rows masked too;
// optionally followed by leaky ReLU 0.01 -> conv_post -> tanh, writing
// audio instead of the group output.
//
// What bounds it on this card: operations at the tensor cores' 3xTF32
// rate. The medium preset's 30 taps cost 2*30*C^2 FLOP a sample: ~20
// GFLOP for 512 frames, three TF32 passes each (a ~0.12 ms bound at 495
// TFLOP/s), against ~0.1 ms for its activation bytes at 3.35 TB/s.
//
// Design: the TPU kernel walks time tiles in order and carries each
// tile's halo from the previous grid step. Hopper blocks run in parallel
// and in no order, so every conv here is one tapconv launch
// (tapconv.cuh: mma.sync 3xTF32 tiles that stage each input window once
// for all taps) whose blocks read their own halo rows from device memory
// (L2 holds the stage's taps and most of the activations). The masking
// and leaky ReLU are applied once per staged element (lrelu(x) * mask),
// the residual add, the branch mean and the output mask in the stores,
// so each conv is one read and one write of the stage tensor. Branch
// units are walked from a small host-side program
// (fused_stage.build_group_spec), one launch per conv; a persistent
// launch per stage is still to come.
//
// bfloat16 (built with -DPHX_BF16): the stage tensors, the weights and the
// audio are bf16, and the functors below round where the TPU kernel
// stores in bf16 (tapconv.cuh); the tail reads the bf16 group output and
// keeps its float32 dot and tanh.

#include "tapconv.cuh"

namespace {

using namespace phx;

constexpr int POST_ROWS = 128;

// A = leaky_relu(x, slope) on rows s < valid[b], 0 past it (tapconv
// reads x [B, T, C] on rows [0, end(b)) and applies the functor to each
// element it stages)
struct LreluMaskPro {
  const elem_t* x;
  int T, C;
  const int* valid;
  float slope;
  __device__ int end(int b) const { return min(T, valid[b]); }
  __device__ float operator()(float v) const { return fmaxf(v, slope * v); }
};

// Y = R + v (end of a residual unit; bf16: R + round(v), rounded)
struct ResidualEpi {
  const elem_t* r;
  elem_t* y;
  int T, C;
  __device__ float2 load(int b, int t, int n) const {
    return {to_f(r[((size_t)b * T + t) * C + n]), 0.f};
  }
  __device__ void store(int b, int t, int n, float v, float2 in) const {
    st(y + ((size_t)b * T + t) * C + n, in.x + round_elem(v));
  }
};

// End of a branch: acc = [acc +] (R + v); the last branch divides by the
// branch count and masks the output rows.
// (bf16: each sum and the mean rounded, as the TPU kernel's bf16 adds)
struct BranchEpi {
  const elem_t* r;
  elem_t* acc;
  int T, C;
  const int* valid;
  int first, last, n_branches;
  __device__ float2 load(int b, int t, int n) const {
    const size_t i = ((size_t)b * T + t) * C + n;
    return {to_f(r[i]), first ? 0.f : to_f(acc[i])};
  }
  __device__ void store(int b, int t, int n, float v, float2 in) const {
    float out = round_elem(in.x + round_elem(v));  // R + v
    if (!first) out = round_elem(in.y + out);
    if (last) out = t < valid[b] ? out / (float)n_branches : 0.f;
    st(acc + ((size_t)b * T + t) * C + n, out);
  }
};

// audio[b, t] = tanh(bias + sum_j sum_c lrelu(acc[t + j - pad], slope) * Wp[j, c])
__global__ void __launch_bounds__(POST_ROWS)
post_kernel(const elem_t* __restrict__ acc, const int* __restrict__ valid,
            const elem_t* __restrict__ wp, const elem_t* __restrict__ bias,
            int T, int C, int P, int pad, float slope,
            elem_t* __restrict__ audio) {
  extern __shared__ float win[];  // [POST_ROWS + P - 1][C]
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * POST_ROWS;
  const int rows = POST_ROWS + P - 1;
  const int vb = valid[b];
  for (int i = threadIdx.x; i < rows * C; i += POST_ROWS) {
    const int s = t0 - pad + i / C;
    float v = 0.f;
    if (s >= 0 && s < T && s < vb) {
      v = to_f(acc[((size_t)b * T + s) * C + i % C]);
      v = round_elem(fmaxf(v, slope * v));
    }
    win[i] = v;
  }
  __syncthreads();
  const int t = t0 + threadIdx.x;
  if (t >= T) return;
  float sum = 0.f;
  for (int j = 0; j < P; ++j) {
    const float* row = win + (threadIdx.x + j) * C;
    const elem_t* w = wp + j * C;
    for (int c = 0; c < C; ++c) sum = fmaf(row[c], to_f(w[c]), sum);
  }
  st(audio + (size_t)b * T + t, tanhf(sum + to_f(bias[0])));
}

}  // namespace

// Program rows (host memory), one per conv in walk order:
//   {w0, n_taps, dil, pad, bias_idx, branch, last_in_unit, last_unit}
constexpr int PROG_COLS = 8;

// x [B, T, C], valid [B] (already clamped to T) -> acc [B, T, C] (group
// mean), or audio [B, T] when post_w is set. W [n_taps, C, C] and bias
// [n_convs, C] are the stacked spec; ping/pong/tmp [B, T, C] scratch
// (tmp only for units of more than one conv, else null).
//
// Tensors are of the build's element type (float32, or bf16 with
// -DPHX_BF16); slope and post_slope as the kernel multiplies by them (in
// bf16, rounded to bf16 as the TPU kernel's weakly typed constants are).
extern "C" int fused_stage_group(
    const elem_t* x, const int* valid, const elem_t* W, const elem_t* bias,
    const int* prog, int n_convs, int n_branches, elem_t* ping, elem_t* pong,
    elem_t* tmp, elem_t* acc, const elem_t* post_w, const elem_t* post_b,
    int post_taps, int post_pad, float post_slope, elem_t* audio, int B,
    int T, int C, float slope, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int dev = 0, sms = 0;
  PHX_TRY(cudaGetDevice(&dev));
  PHX_TRY(cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev));
  const elem_t* unit_in = x;  // residual source of the current unit
  const elem_t* conv_in = x;
  for (int i = 0; i < n_convs; ++i) {
    const int* row = prog + i * PROG_COLS;
    const elem_t* w = W + (size_t)row[0] * C * C;
    const elem_t* bvec = bias + (size_t)row[4] * C;
    const int branch = row[5];
    const bool last_in_unit = row[6] != 0;
    const bool last_unit = row[7] != 0;
    TapTile tile;
    if (!tap_tile(B, T, C, row[1], row[2], sms, &tile))
      return (int)cudaErrorInvalidValue;  // the wrapper refuses such shapes
    const LreluMaskPro pro{conv_in, T, C, valid, slope};
    if (!last_in_unit) {
      PHX_TRY(tapconv(tile, w, bvec, B, T, C, C, row[1], row[2], row[3], pro,
                      StoreEpi{tmp, T, C}, stream));
      conv_in = tmp;
    } else if (last_unit) {
      PHX_TRY(tapconv(tile, w, bvec, B, T, C, C, row[1], row[2], row[3], pro,
                      BranchEpi{unit_in, acc, T, C, valid, branch == 0,
                                branch == n_branches - 1, n_branches},
                      stream));
      unit_in = conv_in = x;  // the next branch starts from the stage input
    } else {
      elem_t* next = unit_in == ping ? pong : ping;
      PHX_TRY(tapconv(tile, w, bvec, B, T, C, C, row[1], row[2], row[3], pro,
                      ResidualEpi{unit_in, next, T, C}, stream));
      unit_in = conv_in = next;
    }
  }
  if (post_w != nullptr) {
    const size_t smem = sizeof(float) * (POST_ROWS + post_taps - 1) * C;
    if (smem > 48 * 1024)
      PHX_TRY(cudaFuncSetAttribute(post_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem));
    const dim3 grid((T + POST_ROWS - 1) / POST_ROWS, B);
    post_kernel<<<grid, POST_ROWS, smem, stream>>>(
        acc, valid, post_w, post_b, T, C, post_taps, post_pad, post_slope,
        audio);
    PHX_TRY(cudaGetLastError());
  }
  return 0;
}

// The tile tapconv takes for a conv of `taps` taps at dilation `dil` over
// [B, T, C] on a card of `sms` SMs: out = {rows, columns, warp columns,
// slab channels, shared-memory bytes}; nonzero if no tile fits (the
// mirror of phoonnx_tpu_torch/tiling.py's tap_tile, compared on the card).
extern "C" int fused_stage_tile(int B, int T, int C, int taps, int dil,
                                int sms, int* out) {
  TapTile tile;
  if (!tap_tile(B, T, C, taps, dil, sms, &tile))
    return (int)cudaErrorInvalidValue;
  const TapShape& s = TAP_SHAPES[tile.shape];
  out[0] = s.bm;
  out[1] = s.bn;
  out[2] = s.wn;
  out[3] = tile.bk;
  out[4] = (int)tile.smem;
  return 0;
}
