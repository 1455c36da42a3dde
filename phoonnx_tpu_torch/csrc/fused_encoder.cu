// Kernel A: the VITS text-encoder layer stack, for Hopper (sm_90a).
//
// Replaces the Pallas kernel phoonnx_tpu/models/vits/fused_encoder.py
// (_kernel :195, apply :292): n_layers x [windowed relative-position MHA
// + residual LayerNorm + k-tap conv FFN with ReLU + residual LayerNorm].
//
// What bounds it on this card: float32 operations, on paper. At the
// medium preset (H 192, F 768, 6 layers, T 128) one request is ~1.7 GFLOP
// against 6 x (192*576 + 192*192 + 2*3*192*768) floats ~ 24.8 MB of
// weights, far above the H100's f32 ridge point, and the weights fit in
// the 50 MB L2. At batch 1 and short texts what limits it in practice is
// how much of the card each step covers and how many steps are chained.
//
// Design: the TPU kernel keeps the activation in VMEM across a sequential
// (batch, layer) grid. Here the whole stack is ONE cooperative launch of
// persistent blocks (persist.cuh) that walks seven phases per layer,
// separated by grid barriers:
//   1. QKV projection (x -> qkv [B, T, 3H]);
//   2. attention, one work item per (batch, head, 16-query tile);
//   3. output projection, split-K into partial sums;
//   4. x <- LayerNorm(x + sum of the parts + bias), one warp per row;
//   5. FFN first conv (masked input, ReLU and mask on store);
//   6. FFN second conv, split-K into partial sums;
//   7. x <- LayerNorm(x + mask * (sum of the parts + bias)); the last
//      layer also writes the masked output.
// Every phase is a list of 16 x 32 output tiles (or rows, or attention
// items) that the blocks stride over, so each phase covers the card; the
// split-K parts are summed in a fixed order (no atomics), so results
// repeat from run to run. Layer 0 reads the input directly (no copy).
// The intermediates (qkv, attn, parts, h, x) stay in scratch that L2 holds.
//
// The attention item stages the query tile in shared memory, then the
// keys in 32-key slabs (16 for the longest texts) double-buffered with
// cp.async (16-byte copies into rows of dk + 4 floats), computes each
// slab's scores as a register-tiled product into the [16, T] score strip,
// adds the relative-key bias on the +-window band and fills padded keys
// with -1e4 (not -inf, as the TPU kernel and the reference do), takes the
// row softmax, and multiplies by the values, staged the same way, with
// each thread holding 4 queries x ceil(dk / 32) channels; the
// relative-value term comes from the same band of the probabilities. The
// relative-key and -value tables are staged in the second slab buffer
// while it is free.
// Shared memory per block is that of the strip, so the longest text is
// set by the 227 KB a block may hold (attention_smem_bytes).

#include "persist.cuh"

namespace {

using namespace phx::ps;
namespace cg = cooperative_groups;

constexpr int QT = 16;       // query rows of an attention item
constexpr int MAX_DK = 128;  // attention channels a head
constexpr int MAX_H = 256;   // LayerNorm row width (8 columns a lane)
constexpr int MAX_SPLIT = 8; // split-K parts (tiling.MAX_SPLIT)
constexpr size_t MAX_SMEM = 227 * 1024;  // a block's shared memory

// Row pitch of a staged key or value slab: 32-key slabs are filled by
// 16-byte copies (rows of dk + 4 floats); 16-key slabs, used only where
// those would not fit, by 4-byte copies into rows of dk + 1 floats, which
// keeps the longest text what it was before the 32-key slabs.
__host__ __device__ int slab_pitch(int sk, int dk) {
  return sk == 32 ? dk + 4 : dk + 1;
}

// Shared memory of an attention item with `sk`-key slabs: the query tile,
// the [16, T] score strip, the relative-key logits and two key slabs.
__host__ __device__ size_t attention_smem_bytes(int T, int dk, int window,
                                                int sk) {
  return sizeof(float) *
         ((size_t)QT * dk + (size_t)QT * T + (size_t)QT * (2 * window + 1) +
          (size_t)2 * sk * slab_pitch(sk, dk));
}

// 32-key slabs, or 16 where those would not fit beside the strip (T
// above ~3,200), so the longest text is that of 16-key slabs
__host__ __device__ int slab_keys(int T, int dk, int window) {
  return attention_smem_bytes(T, dk, window, 32) <= MAX_SMEM ? 32 : 16;
}

struct EncArgs {
  const float* x;
  const int* len;
  const float* w_qkv;
  const float* b_qkv;
  const float* w_o;
  const float* b_o;
  const float* rel_k;
  const float* rel_v;
  const float* ln;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  float* xbuf;
  float* qkv;
  float* attn;
  float* part;
  float* hbuf;
  float* out;
  long long* stamps;  // phase end times, or null
  int B, T, H, F, L, n_heads, window, ffn_k;
  int split_o, per_o, split_2, per_2;
  float scale;
};

// One tap-form product phase over [B, T] x N outputs: tile w of the
// phase's list, its epilogue called per output element with the raw sum.
template <class Epi>
__device__ void gemm_phase(GemmSmem& sm, const Conv& cv, int B, int T, int N,
                           int splits, int per, const Rows& rows, Epi epi) {
  const int tiles_m = cdiv(T, BM);
  const int tiles_n = cdiv(N, BN);
  const int items = tiles_m * tiles_n * B * splits;
  const int ty = thread_row();
  const int tx = thread_col();
  for (int w = first_item(items); w < items; w += gridDim.x) {
    const Item it = decode(w, B, tiles_m, tiles_n);
    const Cols cols{0, it.tn * BN, N};
    const int q0 = it.s * per;
    const int q1 = min(q0 + per, cv.slabs());
    float acc[TM][TN];
    gemm_tile(sm, cv, cols, rows, it.b, it.tm * BM, q0, q1, acc);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int t = it.tm * BM + ty * TM + i;
      if (t >= T) continue;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = cols.out(tx * TN + j);
        if (n < N) epi(it.s, it.b, t, n, acc[i][j]);
      }
    }
  }
}

// qkv [B, T, 3H] -> attn [B, T, H] for one (batch, head, query tile),
// keys and values staged SK at a time; DJ = ceil(dk / 32) channel groups.
template <int SK, int DJ>
__device__ void attention_item(float* smem, const EncArgs& a, int layer,
                               int b, int hd, int q0) {
  constexpr int KJ = SK / 16;  // keys a thread scores in a slab
  const int T = a.T, H = a.H, dk = H / a.n_heads, window = a.window;
  const int nrel = 2 * window + 1;
  const int ldq = 3 * H;
  const int kp = slab_pitch(SK, dk);
  float* qs = smem;              // [dk][QT]: a thread's two rows, one float2
  float* ps = qs + QT * dk;      // [QT][T] scores, then probabilities
  float* rl = ps + QT * T;       // [QT][nrel] relative-key logits
  float* ks = rl + QT * nrel;    // [2][SK][kp] key, then value, slabs
  const float* rel_k = a.rel_k + (size_t)layer * nrel * dk;
  const float* rel_v = a.rel_v + (size_t)layer * nrel * dk;
  const int tid = threadIdx.x;
  const int L = a.len[b];
  const float* base = a.qkv + (size_t)b * T * ldq + hd * dk;
  const int n_slabs = cdiv(T, SK);
  const int r_first = tid / dk;
  const int d_first = tid % dk;

  // slab `sl` of the key (coff H) or value (coff 2H) columns -> buffer
  auto fetch = [&](int sl, int coff) {
    float* dst = ks + (sl & 1) * SK * kp;
    const int s0 = sl * SK;
    if (SK == 32) {
      for (int i = tid; i < SK * dk / 4; i += NT) {
        const int r = i / (dk / 4);
        const int d = (i % (dk / 4)) * 4;
        if (s0 + r < T) cp_async16(dst + r * kp + d, base + (size_t)(s0 + r) * ldq + coff + d);
      }
    } else {
      for (int r = r_first, d = d_first; r < SK;) {
        if (s0 + r < T) cp_async4(dst + r * kp + d, base + (size_t)(s0 + r) * ldq + coff + d);
        d += NT;
        while (d >= dk) {
          d -= dk;
          ++r;
        }
      }
    }
    cp_commit();
  };

  // a relative table [nrel][dk] -> the second slab buffer, pitch kp
  float* rel_s = ks + SK * kp;
  auto stage_rel = [&](const float* table) {
    for (int i = tid; i < nrel * dk; i += NT)
      cp_async4(rel_s + (i / dk) * kp + i % dk, table + i);
    cp_commit();
  };

  fetch(0, H);  // key slab 0 -> the first buffer
  stage_rel(rel_k);
  for (int i = tid; i < QT * dk; i += NT) {
    const int r = i / dk;
    const int d = i % dk;
    qs[d * QT + r] = q0 + r < T ? ld(base + (size_t)(q0 + r) * ldq + d) * a.scale : 0.f;
  }
  cp_wait<0>();
  __syncthreads();
  for (int i = tid; i < QT * nrel; i += NT) {
    const int r = i / nrel;
    const int j = i % nrel;
    float acc = 0.f;
#pragma unroll 8
    for (int d = 0; d < dk; ++d) acc = fmaf(qs[d * QT + r], rel_s[j * kp + d], acc);
    rl[i] = acc;
  }
  __syncthreads();  // the second buffer is free for key slab 1

  // scores: thread = (key kk + 16 u, query rows 2 rp and 2 rp + 1)
  {
    const int kk = tid % 16;
    const int r0 = (tid / 16) * 2;
    for (int sl = 0; sl < n_slabs; ++sl) {
      if (sl + 1 < n_slabs) {
        fetch(sl + 1, H);
        cp_wait<1>();
      } else {
        cp_wait<0>();
      }
      __syncthreads();
      const float* kr = ks + (sl & 1) * SK * kp + kk * kp;
      float acc[2][KJ];
#pragma unroll
      for (int u = 0; u < KJ; ++u) acc[0][u] = acc[1][u] = 0.f;
#pragma unroll 8
      for (int d = 0; d < dk; ++d) {
        const float2 q = *reinterpret_cast<const float2*>(&qs[d * QT + r0]);
#pragma unroll
        for (int u = 0; u < KJ; ++u) {
          const float kv = kr[u * 16 * kp + d];
          acc[0][u] = fmaf(q.x, kv, acc[0][u]);
          acc[1][u] = fmaf(q.y, kv, acc[1][u]);
        }
      }
#pragma unroll
      for (int u = 0; u < KJ; ++u) {
        const int s = sl * SK + kk + 16 * u;
        if (s >= T) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = r0 + e;
          float v = acc[e][u];
          const int c = s - (q0 + r);
          if (c >= -window && c <= window) v += rl[r * nrel + c + window];
          ps[r * T + s] = s < L ? v : -1e4f;
        }
      }
      __syncthreads();
    }
  }

  // the first value slab loads under the softmax
  fetch(0, 2 * H);
  // row softmax: warp w takes rows w, w + 4, w + 8, w + 12 together
  {
    constexpr int RW = QT / (NT / 32);
    const int warp = tid / 32;
    const int lane = tid % 32;
    float* row[RW];
    float m[RW], sum[RW];
#pragma unroll
    for (int i = 0; i < RW; ++i) {
      row[i] = ps + (warp + i * (NT / 32)) * T;
      m[i] = -3.0e38f;
      sum[i] = 0.f;
    }
    for (int s = lane; s < T; s += 32)
#pragma unroll
      for (int i = 0; i < RW; ++i) m[i] = fmaxf(m[i], row[i][s]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < RW; ++i) m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], o));
    for (int s = lane; s < T; s += 32)
#pragma unroll
      for (int i = 0; i < RW; ++i) {
        const float e = expf(row[i][s] - m[i]);
        row[i][s] = e;
        sum[i] += e;
      }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int i = 0; i < RW; ++i) sum[i] += __shfl_xor_sync(0xffffffffu, sum[i], o);
    for (int s = lane; s < T; s += 32)
#pragma unroll
      for (int i = 0; i < RW; ++i) row[i][s] = row[i][s] / sum[i];
  }

  // out = p v + banded relative-value term: thread = 4 queries x DJ
  // channels (dg + 32 j)
  const int dg = tid % 32;
  const int rq = (tid / 32) * 4;
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  for (int sl = 0; sl < n_slabs; ++sl) {
    if (sl + 1 < n_slabs) {
      fetch(sl + 1, 2 * H);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const float* vs = ks + (sl & 1) * SK * kp;
    const float* pr = ps + rq * T + sl * SK;
    const int n = min(SK, T - sl * SK);
#pragma unroll 4
    for (int u = 0; u < n; ++u) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = pr[i * T + u];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const int d = dg + 32 * j;
        if (d < dk) {
          const float v = vs[u * kp + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], v, acc[i][j]);
        }
      }
    }
    __syncthreads();
  }
  stage_rel(rel_v);  // the value slabs are done with the second buffer
  cp_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rq + i;
    const int qi = q0 + r;
    if (qi >= T) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int d = dg + 32 * j;
      if (d >= dk) continue;
      float v = acc[i][j];
#pragma unroll 3
      for (int k = 0; k < nrel; ++k) {
        const int s = qi + k - window;
        if (s >= 0 && s < T) v = fmaf(ps[r * T + s], rel_s[k * kp + d], v);
      }
      a.attn[((size_t)b * T + qi) * H + hd * dk + d] = v;
    }
  }
  __syncthreads();
}

template <int SK>
__device__ void attention_groups(int dj, float* smem, const EncArgs& a,
                                 int layer, int b, int hd, int q0) {
  if (dj == 1)
    attention_item<SK, 1>(smem, a, layer, b, hd, q0);
  else if (dj == 2)
    attention_item<SK, 2>(smem, a, layer, b, hd, q0);
  else if (dj == 3)
    attention_item<SK, 3>(smem, a, layer, b, hd, q0);
  else
    attention_item<SK, 4>(smem, a, layer, b, hd, q0);
}

// x <- LayerNorm(res + y) per row, y = sum of `splits` parts + bias
// (zero past the length when `mask_y`); one warp per row over the grid.
// With `out` set the result is also written there, zeroed past the
// length.
__device__ void add_layernorm_phase(const EncArgs& a, const float* res,
                                    const float* bias, const float* gamma,
                                    const float* beta, int splits,
                                    bool mask_y, float* out) {
  const int H = a.H;
  const int rows = a.B * a.T;
  const size_t plane = (size_t)rows * H;
  const int lane = threadIdx.x % 32;
  const int groups = cdiv(rows, NT / 32);  // a block's warps take a group
  for (int g = first_item(groups); g < groups; g += gridDim.x) {
    const int row = g * (NT / 32) + threadIdx.x / 32;
    if (row >= rows) continue;
    const bool valid = (row % a.T) < a.len[row / a.T];
    const float* rr = res + (size_t)row * H;
    // every load of the row starts before the first is used
    float v[MAX_H / 32];
#pragma unroll
    for (int k = 0; k < MAX_H / 32; ++k) {
      const int c = lane + 32 * k;
      v[k] = c < H ? ld(rr + c) : 0.f;
    }
    if (valid || !mask_y) {
#pragma unroll
      for (int s = 0; s < MAX_SPLIT; ++s) {
        if (s >= splits) break;
#pragma unroll
        for (int k = 0; k < MAX_H / 32; ++k) {
          const int c = lane + 32 * k;
          if (c < H) v[k] += ld(a.part + s * plane + (size_t)row * H + c);
        }
      }
#pragma unroll
      for (int k = 0; k < MAX_H / 32; ++k) {
        const int c = lane + 32 * k;
        if (c < H) v[k] += __ldg(bias + c);
      }
    }
    float sum = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_H / 32; ++k) sum += v[k];
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / H;
    float sq = 0.f;
#pragma unroll
    for (int k = 0; k < MAX_H / 32; ++k) {
      const float d = lane + 32 * k < H ? v[k] - mean : 0.f;
      sq += d * d;
    }
    for (int o = 16; o > 0; o >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, o);
    const float inv = 1.f / sqrtf(sq / H + 1e-5f);
    // each lane writes only the columns it read (res may be xbuf itself)
    float* xr = a.xbuf + (size_t)row * H;
#pragma unroll
    for (int k = 0; k < MAX_H / 32; ++k) {
      const int c = lane + 32 * k;
      if (c >= H) continue;
      const float y = (v[k] - mean) * inv * __ldg(gamma + c) + __ldg(beta + c);
      xr[c] = y;
      if (out != nullptr) out[(size_t)row * H + c] = valid ? y : 0.f;
    }
  }
}

__global__ void __launch_bounds__(NT)
encoder_persistent(EncArgs a) {
  extern __shared__ __align__(16) float smem[];
  GemmSmem& sm = *reinterpret_cast<GemmSmem*>(smem);
  cg::grid_group grid = cg::this_grid();
  const int B = a.B, T = a.T, H = a.H, F = a.F, K = a.ffn_k;
  const int pad = (K - 1) / 2;
  const size_t plane = (size_t)B * T * H;
  int phase = 0;
  auto sync = [&]() {
    grid.sync();
    stamp(a.stamps, ++phase);
  };
  stamp(a.stamps, 0);

  for (int l = 0; l < a.L; ++l) {
    const float* x = l == 0 ? a.x : a.xbuf;
    const float* lnl = a.ln + (size_t)l * 4 * H;
    // 1. qkv = x W_qkv + b
    {
      const Conv cv{a.w_qkv + (size_t)l * H * 3 * H, H, 3 * H, 1, 1, 0};
      const float* bias = a.b_qkv + (size_t)l * 3 * H;
      float* qkv = a.qkv;
      gemm_phase(sm, cv, B, T, 3 * H, 1, cv.slabs(), Rows{x, T, H, 0, nullptr},
                 [=](int, int b, int t, int n, float v) {
                   qkv[((size_t)b * T + t) * 3 * H + n] = v + __ldg(bias + n);
                 });
    }
    sync();
    // 2. attention
    {
      const int qtiles = cdiv(T, QT);
      const int items = qtiles * a.n_heads * B;
      const bool wide = slab_keys(T, H / a.n_heads, a.window) == 32;
      const int dj = cdiv(H / a.n_heads, 32);
      // items on blocks 0, 1, 2, ... (not first_item): spread over the
      // grid, these few latency-bound items measured slower on the card
      for (int w = blockIdx.x; w < items; w += gridDim.x) {
        const int b = w / (qtiles * a.n_heads);
        const int hd = (w / qtiles) % a.n_heads;
        const int q0 = (w % qtiles) * QT;
        if (wide)
          attention_groups<32>(dj, smem, a, l, b, hd, q0);
        else
          attention_groups<16>(dj, smem, a, l, b, hd, q0);
      }
    }
    sync();
    // 3. output projection, split-K parts
    {
      const Conv cv{a.w_o + (size_t)l * H * H, H, H, 1, 1, 0};
      float* part = a.part;
      gemm_phase(sm, cv, B, T, H, a.split_o, a.per_o,
                 Rows{a.attn, T, H, 0, nullptr},
                 [=](int s, int b, int t, int n, float v) {
                   part[s * plane + ((size_t)b * T + t) * H + n] = v;
                 });
    }
    sync();
    // 4. x = LN(x + y)
    add_layernorm_phase(a, x, a.b_o + (size_t)l * H, lnl, lnl + H, a.split_o,
                        false, nullptr);
    sync();
    // 5. h = mask * relu(conv(mask * x))
    {
      const Conv cv{a.w1 + (size_t)l * K * H * F, H, F, K, 1, pad};
      const float* bias = a.b1 + (size_t)l * F;
      float* hbuf = a.hbuf;
      const int* len = a.len;
      gemm_phase(sm, cv, B, T, F, 1, cv.slabs(), Rows{a.xbuf, T, H, 0, a.len},
                 [=](int, int b, int t, int n, float v) {
                   hbuf[((size_t)b * T + t) * F + n] =
                       t < len[b] ? fmaxf(v + __ldg(bias + n), 0.f) : 0.f;
                 });
    }
    sync();
    // 6. FFN second conv, split-K parts
    {
      const Conv cv{a.w2 + (size_t)l * K * F * H, F, H, K, 1, pad};
      float* part = a.part;
      gemm_phase(sm, cv, B, T, H, a.split_2, a.per_2,
                 Rows{a.hbuf, T, F, 0, a.len},
                 [=](int s, int b, int t, int n, float v) {
                   part[s * plane + ((size_t)b * T + t) * H + n] = v;
                 });
    }
    sync();
    // 7. x = LN(x + mask * y)
    add_layernorm_phase(a, a.xbuf, a.b2 + (size_t)l * H, lnl + 2 * H,
                        lnl + 3 * H, a.split_2, true,
                        l == a.L - 1 ? a.out : nullptr);
    if (l + 1 < a.L || a.stamps != nullptr) sync();
  }
}

size_t kernel_smem(int T, int dk, int window) {
  const size_t att =
      attention_smem_bytes(T, dk, window, slab_keys(T, dk, window));
  return att > sizeof(GemmSmem) ? att : sizeof(GemmSmem);
}

}  // namespace

// Dynamic shared memory the kernel needs for T keys; the card grants at
// most 227 KB a block.
extern "C" long long fused_encoder_smem_bytes(int T, int dk, int window) {
  return (long long)kernel_smem(T, dk, window);
}

// Blocks of the kernel one SM holds at once for this T, and the SM count
// (out[0], out[1]); returns the CUDA status.
extern "C" int fused_encoder_occupancy(int T, int dk, int window, int* out) {
  return (int)occupancy(encoder_persistent, kernel_smem(T, dk, window), out);
}

// x [B, T, H] (masked) -> out [B, T, H]; xbuf, attn [B, T, H], qkv
// [B, T, 3H], hbuf [B, T, F] and part [max(split_o, split_2), B, T, H]
// are caller-allocated scratch; stamps, if not null, receives 7 L + 1
// device times (ns): the start and the end of each phase. grid must not exceed what
// fused_encoder_occupancy reports (a cooperative launch is refused
// otherwise); split_* x per_* cover each product's slabs
// (phoonnx_tpu_torch/tiling.py).
extern "C" int fused_encoder_forward(
    const float* x, const int* lengths, const float* w_qkv,
    const float* b_qkv, const float* w_o, const float* b_o,
    const float* rel_k, const float* rel_v, const float* ln, const float* w1,
    const float* b1, const float* w2, const float* b2, float* xbuf,
    float* qkv, float* attn, float* part, float* hbuf, float* out,
    long long* stamps, int B,
    int T, int H, int F, int L, int n_heads, int window, int ffn_k,
    int grid, int split_o, int per_o, int split_2, int per_2, float scale,
    void* stream_ptr) {
  if (H > MAX_H || H % n_heads != 0 || H / n_heads > MAX_DK ||
      (H / n_heads) % 4 != 0 ||
      2 * window + 1 > 16 || split_o > MAX_SPLIT || split_2 > MAX_SPLIT)
    return (int)cudaErrorInvalidValue;
  const size_t smem = kernel_smem(T, H / n_heads, window);
  if (smem > 48 * 1024)
    PHX_TRY(cudaFuncSetAttribute(encoder_persistent,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem));
  const EncArgs args{x,    lengths, w_qkv, b_qkv, w_o,  b_o,     rel_k,
                     rel_v, ln,     w1,    b1,    w2,   b2,      xbuf,
                     qkv,  attn,    part,  hbuf,  out,  stamps,  B,       T,
                     H,    F,       L,     n_heads, window, ffn_k, split_o,
                     per_o, split_2, per_2, scale};
  return (int)launch_cooperative(encoder_persistent, args, grid, smem,
                                 static_cast<cudaStream_t>(stream_ptr));
}
