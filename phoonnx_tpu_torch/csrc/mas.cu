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
// of finite priors and latents), so nothing emulates that. Built without
// --use_fast_math: the add and the max round as the plain version's do.
//
// What bounds it on this card: bytes. At the medium training shape
// (batch 16, T_y 832, T_x 320) the function reads 17 MB of scores and
// writes a 17 MB path, ~10 us at 3.35 TB/s; its ~2 float32 operations a
// cell are ~0.1 us at 67 TFLOP/s. What holds it above that is the chain
// of y_len dependent rows a batch element walks twice, forward and back.
//
// Design: one block per batch element. Rows past y_len and cells past
// x_len feed nothing the backtrack reads (a cell depends only on cells
// to its left and above), so the DP walks rows [0, y_len) only.
// 1. Forward, rows in registers. The first `warps` warps carry the row:
//    thread g holds cells x = g*K + j, j < K. Its left neighbour
//    q[y-1, g*K - 1] comes from the lane below by __shfl_up_sync, or
//    across a warp boundary from a two-slot exchange behind one named
//    barrier (bar.sync 1) a row; one warp needs no barrier. The row loop
//    is unrolled by K rows: thread g holds the diagonal x == y for rows
//    [gK, gK + K), so only cell r of unrolled row r tests for it.
//    The scores come through a ring of S rows in shared memory, copied
//    S - 1 rows ahead with cp.async (16 bytes a copy where rows are
//    16-byte aligned), each warp copying the columns its lanes hold, so
//    cp.async.wait_group and __syncwarp() order them with no block
//    barrier; row y + 1's cells are read while row y is computed.
// 2. One decision bit a cell instead of the scores. Row y records
//    d[y, x] = x != 0 && (x == y || q[y-1, x] < q[y-1, x-1]), the
//    backtrack's own test on the same float32 values, so the path stays
//    bit-identical (a tie stays). Thread g's K bits of a row are one
//    word (bit j for cell g*K + j), stored to a caller-allocated int32
//    buffer [B, T_y, warps*32]: 5.1 MB for the medium batch (3 warps),
//    against the 17 MB float32 score scratch of the first port. (Packing with
//    __ballot_sync, a word a (warp, j), costs a vote and a select a cell;
//    a word a lane costs one OR.) The other warps meanwhile zero the path
//    rows past y_len.
// 3. Backtrack from shared memory. Thread 0 walks down one chunk of rows
//    at a time over bits staged in a shared double buffer, in blocks of
//    K rows whose two-word windows it loads together (walk). Meanwhile
//    the other warps load the next chunk's bits and write the dense path
//    rows of the chunk walked before from its columns (1 at x == idx[y],
//    0 elsewhere, a warp a row, float4 where rows are 16-byte aligned);
//    one __syncthreads() a chunk. No row pays a global load on the chain,
//    and the path plane is written once, with no zeroing pass before it.
// Builds: K = 1..4 cells a lane on 8-warp blocks (T_x <= 1024, a ring of
// 8 rows), and K = 32 on 1024-thread blocks for wider rows (T_x <= 32768,
// a ring of one row, so each row waits for its copy; registers spill
// there). ops/mas.py `plan` picks the warps, K and the chunk rows;
// mas_path checks them. With `stamps`, block 0 notes the device clock at
// its start and at the end of the forward, of the walk (with the path
// rows written behind it) and of the last chunk's path rows.

#include <cuda_runtime.h>

namespace {

constexpr float kNegInf = -1e9f;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kFastThreads = 256;
constexpr int kFastMaxCells = 4;
constexpr int kFastRing = 8;  // rows of scores in flight ahead of the DP
constexpr int kWideThreads = 1024;
constexpr int kWideCells = 32;
constexpr int kWideRing = 1;  // a 32768-cell row is 128 KB
constexpr int kMaxChunkRows = 128;
constexpr int kMaxChunkWords = 8192;

// thread 0 of block 0 notes the device clock (ns) as stamps[i]
__device__ __forceinline__ void stamp(long long* stamps, int i) {
  if (stamps != nullptr && blockIdx.x == 0 && threadIdx.x == 0) {
    long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    stamps[i] = t;
  }
}

// the DP warps' barrier, which the other warps do not join
__device__ __forceinline__ void dp_barrier(int threads) {
  asm volatile("bar.sync 1, %0;" ::"r"(threads) : "memory");
}

// Rows [lo, hi) of a path plane: 1 at x == idx[y - lo], else 0 (all 0
// without idx); warp w of n writes rows lo + w, lo + w + n, ..., its lanes
// on neighbouring columns (float4 where rows are 16-byte aligned).
__device__ void write_rows(float* plane, int t_x, int lo, int hi,
                           const int* idx, int w, int n) {
  const int lane = threadIdx.x & 31;
  const bool vec = t_x % 4 == 0;
  for (int y = lo + w; y < hi; y += n) {
    const int at = idx ? idx[y - lo] : -1;
    float* row = plane + (size_t)y * t_x;
    if (vec) {
      for (int c = 4 * lane; c < t_x; c += 128) {
        const int d = at - c;
        *reinterpret_cast<float4*>(row + c) =
            make_float4(d == 0, d == 1, d == 2, d == 3);
      }
    } else {
      for (int c = lane; c < t_x; c += 32) row[c] = c == at ? 1.f : 0.f;
    }
  }
}

// One commit group of row copies, empty past y_n, so every thread counts
// the same groups. `src` is this lane's first column of the row, `dst`
// its shared address in the slot; `n` copies of `bytes` each, 32 lanes
// apart.
template <int N, int BYTES>
__device__ __forceinline__ void copy_row(unsigned dst, const float* src,
                                         bool row_inside, unsigned live) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    if (row_inside && (live >> i & 1)) {
      if constexpr (BYTES == 16) {
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                         dst + i * 32 * BYTES),
                     "l"(src + i * 32 * (BYTES / 4))
                     : "memory");
      } else {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                         dst + i * 32 * BYTES),
                     "l"(src + i * 32 * (BYTES / 4))
                     : "memory");
      }
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Forward DP of one batch element on the first `warps` warps (design 1
// and 2 above): row y's decision bits to bits[y * warps*32 + g].
template <int K, int S, int BYTES>
__device__ void forward_rows(const float* v, unsigned* bits, float* ring,
                             float* xch, int y_n, int t_x, int warps) {
  constexpr int N = (K * 4 + BYTES - 1) / BYTES;  // copies a lane a row
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int threads = warps * 32;
  const int cols = threads * K;  // a slot's floats: every lane's cells
  const int x0 = threadIdx.x * K;
  const int c0 = warp * 32 * K;  // this warp's columns [c0, c0 + 32 K)
  // cells past T_x read 0: the copies never reach them
  for (int r = 0; r < S; ++r) {
    for (int c = max(t_x, c0) + lane; c < c0 + 32 * K; c += 32) {
      ring[r * cols + c] = 0.f;
    }
  }
  const int first = c0 + lane * (BYTES / 4);  // this lane's first copy
  unsigned live = 0;                          // which of its N copies
  for (int i = 0; i < N; ++i) {
    live |= (first + i * 32 * (BYTES / 4) < min(c0 + 32 * K, t_x)) << i;
  }
  const unsigned ring0 = static_cast<unsigned>(
      __cvta_generic_to_shared(ring + first));
  const float* src = v + first;
  float q[K];
#pragma unroll
  for (int j = 0; j < K; ++j) q[j] = kNegInf;  // row -1
  if (lane == 31) xch[warp] = kNegInf;  // slot 0: row -1's last cell
  if (warps > 1) dp_barrier(threads);
#pragma unroll
  for (int r = 0; r < S; ++r) {
    copy_row<N, BYTES>(ring0 + r * cols * 4, src + (size_t)r * t_x, r < y_n,
                       live);
  }
  const unsigned keep = threadIdx.x == 0 ? ~1u : ~0u;  // x == 0 stays
  unsigned* out = bits + threadIdx.x;           // row y's word of this thread
  unsigned fill = ring0;                        // its copies' slot y % S
  const float* ahead = src + (size_t)S * t_x;   // its copies of row y + S
  const float* next_slot = ring + x0;           // its cells, slot (y+1) % S
  int slot = 0;
  float val[K];  // row y's scores of this thread's cells
  asm volatile("cp.async.wait_group %0;" ::"n"(S - 1) : "memory");
  __syncwarp();
#pragma unroll
  for (int j = 0; j < K; ++j) val[j] = next_slot[j];
  if (S > 1) next_slot += cols;

  // Thread g holds the cell x == y for rows [gK, gK + K): unrolled by K
  // rows, the forced advance is cell r of row y0 + r on the one thread
  // with x0 == y0, so no other cell tests for it.
  for (int y0 = 0; y0 < y_n; y0 += K) {
    const bool on_diagonal = x0 == y0;
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int y = y0 + r;
      if (y >= y_n) break;  // y_n is the block's: every DP thread leaves
      // row y + 1's cells, read while row y is computed: it has landed
      // once at most S - 2 later groups are pending, and the warp's lanes
      // copied each other's cells
      float val_next[K];
      if constexpr (S > 1) {
        asm volatile("cp.async.wait_group %0;" ::"n"(S > 1 ? S - 2 : 0)
                     : "memory");
        __syncwarp();
#pragma unroll
        for (int j = 0; j < K; ++j) val_next[j] = next_slot[j];
      }
      // q[y-1, x0 - 1]: the lane below, or the warp below's last lane
      // (slot y % 2 of the exchange); for x == 0 the advance, 0 on the
      // first row and -1e9 after it
      const float below = xch[(y & 1) * 32 + max(warp - 1, 0)];
      const float up_left = __shfl_up_sync(kFull, q[K - 1], 1);
      const float start = y == 0 ? 0.f : kNegInf;
      const float left = lane > 0 ? up_left : (warp > 0 ? below : start);
      unsigned word = 0;
      float next[K];
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const float up = q[j];                        // q[y-1, x]
        const float diag = j == 0 ? left : q[j - 1];  // q[y-1, x-1]
        // steps back iff q[y-1, x] < q[y-1, x-1], or x == y
        unsigned back;
        asm("set.lt.u32.f32 %0, %1, %2;" : "=r"(back) : "f"(up), "f"(diag));
        float stay = up;
        if (j == r) {
          stay = on_diagonal ? kNegInf : up;
          back |= on_diagonal ? ~0u : 0u;
        }
        word |= back & (1u << j);
        next[j] = val[j] + fmaxf(stay, diag);
      }
#pragma unroll
      for (int j = 0; j < K; ++j) q[j] = next[j];
      *out = word & keep;
      out += threads;
      if (warps > 1) {
        // one barrier a row: slot (y + 1) % 2 is written, slot y % 2 read
        if (lane == 31) xch[((y + 1) & 1) * 32 + warp] = q[K - 1];
        dp_barrier(threads);
      }
      // refill slot y % S, which every lane read before its last
      // __syncwarp() (with one slot, before this one)
      if constexpr (S == 1) __syncwarp();
      copy_row<N, BYTES>(fill, ahead, y + S < y_n, live);
      ahead += t_x;
      if (++slot == S) {
        slot = 0;
        fill = ring0;
      } else {
        fill += cols * 4;
      }
      if constexpr (S > 1) {
#pragma unroll
        for (int j = 0; j < K; ++j) val[j] = val_next[j];
        next_slot = slot == S - 1 ? ring + x0 : next_slot + cols;
      } else {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
        __syncwarp();
#pragma unroll
        for (int j = 0; j < K; ++j) val[j] = next_slot[j];
      }
    }
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// 16-byte copies where every row starts 16-byte aligned, else 4-byte ones
template <int K, int S>
__device__ void forward(const float* v, unsigned* bits, float* ring,
                        float* xch, int y_n, int t_x, int warps) {
  if (t_x % 4 == 0 && reinterpret_cast<size_t>(v) % 16 == 0) {
    forward_rows<K, S, 16>(v, bits, ring, xch, y_n, t_x, warps);
  } else {
    forward_rows<K, S, 4>(v, bits, ring, xch, y_n, t_x, warps);
  }
}

// Thread 0 walks rows [lo, hi) of one chunk down from x (its column at
// row hi - 1) over the staged bits `bw`, noting each row's column in
// `idx`; returns the column at row lo - 1. A block of K rows keeps to
// [x - K + 1, x], which words g0 and g0 + 1 from g0 = (x - K) / K hold:
// the block's 2K loads go out together (rows below lo repeat row lo, and
// a word past a row's end belongs to the next row or the idx buffer:
// neither is read), so the chain a row is a shift, a mask and a
// subtract. Row 0 needs no test: its bits are all 0 (q[-1, :] is -1e9
// everywhere, and x == 0 is masked).
template <int K>
__device__ int walk(const unsigned* bw, int* idx, int words, int lo, int hi,
                    int x) {
  for (int top = hi - 1; top >= lo; top -= K) {
    const int g0 = max(x - K, 0) / K;
    const int first = g0 * K;
    unsigned long long win[K];
#pragma unroll
    for (int r = 0; r < K; ++r) {
      const unsigned* w = bw + (max(top - r, lo) - lo) * words + g0;
      win[r] = w[0] | (unsigned long long)w[1] << K;
    }
    int p = x - first;  // the column within the window
#pragma unroll
    for (int r = 0; r < K; ++r) {
      if (top - r < lo) break;
      idx[top - r - lo] = first + p;
      p -= static_cast<int>((win[r] >> p) & 1);
    }
    x = first + p;
  }
  return x;
}

template <int K, int NT, int S>
__global__ void __launch_bounds__(NT)
    mas_kernel(const float* __restrict__ value, const int* __restrict__ y_lens,
               const int* __restrict__ x_lens, float* __restrict__ path,
               unsigned* bits, long long* stamps, int t_y, int t_x, int warps,
               int chunk) {
  extern __shared__ unsigned smem[];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int words = warps * 32;  // a row's decision words
  const size_t plane = (size_t)t_y * t_x;
  float* pb = path + b * plane;
  // written by this block's forward, read back after a __syncthreads():
  // plain (coherent) loads, never the read-only path
  unsigned* bb = bits + (size_t)b * t_y * words;
  const int y_n = min(max(y_lens[b], 0), t_y);
  const int dp_threads = warps * 32;
  float* ring = reinterpret_cast<float*>(smem);  // [S][K][dp_threads]
  unsigned* bitbuf = smem + S * K * dp_threads;  // [2][chunk * words]
  // then idx [2][chunk], the exchange [2][32]
  int* idxbuf = reinterpret_cast<int*>(bitbuf + 2 * chunk * words);
  float* xch = reinterpret_cast<float*>(idxbuf + 2 * chunk);  // [2][32]
  stamp(stamps, 0);

  if (tid < dp_threads) {
    forward<K, S>(value + b * plane, bb, ring, xch, y_n, t_x, warps);
  } else {
    write_rows(pb, t_x, y_n, t_y, nullptr, (tid - dp_threads) >> 5,
               (NT - dp_threads) >> 5);
  }
  __syncthreads();
  stamp(stamps, 1);
  if (dp_threads == NT) {
    write_rows(pb, t_x, y_n, t_y, nullptr, tid >> 5, NT >> 5);
  }

  // Backtrack, chunk c = rows [max(y_n - (c+1)*chunk, 0), y_n - c*chunk):
  // at step s the other warps stage chunk s's bits and write chunk
  // s-2's path rows while thread 0 walks chunk s-1.
  const int n_chunks = (y_n + chunk - 1) / chunk;
  int x = min(max(x_lens[b], 1), t_x) - 1;
  for (int s = 0; s <= n_chunks + 1; ++s) {
    if (tid == 0 && s >= 1 && s <= n_chunks) {
      const int c = s - 1;
      const int hi = y_n - c * chunk;
      const int lo = max(hi - chunk, 0);
      x = walk<K>(bitbuf + (c & 1) * chunk * words, idxbuf + (c & 1) * chunk,
                  words, lo, hi, x);
    } else if (tid >= 32) {
      // the next chunk's bits: loaded first, stored after this step's
      // path rows, so their latency hides behind the writes
      constexpr int L = (kMaxChunkWords + NT - 33) / (NT - 32);
      const int hi = y_n - s * chunk;
      const int lo = max(hi - chunk, 0);
      const int n = s < n_chunks ? (hi - lo) * words : 0;
      const unsigned* src = bb + (size_t)lo * words;
      unsigned staged[L];
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const int at = tid - 32 + i * (NT - 32);
        if (at < n) staged[i] = src[at];
      }
      if (s >= 2) {
        const int c = s - 2;
        const int top = y_n - c * chunk;
        write_rows(pb, t_x, max(top - chunk, 0), top,
                   idxbuf + (c & 1) * chunk, (tid >> 5) - 1, NT / 32 - 1);
      }
      unsigned* dst = bitbuf + (s & 1) * chunk * words;
#pragma unroll
      for (int i = 0; i < L; ++i) {
        const int at = tid - 32 + i * (NT - 32);
        if (at < n) dst[at] = staged[i];
      }
    }
    __syncthreads();
    if (s == n_chunks) stamp(stamps, 2);
  }
  stamp(stamps, 3);
}

template <int K, int NT, int S>
cudaError_t run(const float* value, const int* y_lens, const int* x_lens,
                float* path, unsigned* bits, long long* stamps, int B,
                int T_y, int T_x, int warps, int chunk, cudaStream_t stream) {
  // the scores' ring, the bits' and idx's double buffers and the DP
  // warps' exchange: at most 193 KB (8 rows of 1024 cells or one of
  // 32768, and 2 x 8192 words of bits)
  const size_t smem =
      sizeof(unsigned) * (static_cast<size_t>(S) * warps * 32 * K +
                          2 * static_cast<size_t>(chunk) * warps * 32 +
                          2 * chunk + 2 * 32);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mas_kernel<K, NT, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  mas_kernel<K, NT, S><<<B, NT, smem, stream>>>(
      value, y_lens, x_lens, path, bits, stamps, T_y, T_x, warps, chunk);
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* phx_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// value, path: [B, T_y, T_x] float32; y_lens, x_lens: [B] int32; bits:
// [B, T_y, warps*32] int32 scratch; stamps: null or 4 int64 (start,
// forward, backtrack and path write ends, device ns, block 0). `warps`
// warps of `cells` cells a lane carry a row (cells 1..4 with warps <= 8,
// or cells 32 with warps <= 32; warps*32*cells >= T_x); the backtrack
// stages `chunk` rows of bits at a time (chunk <= 128, chunk*warps*32
// <= 8192). Returns a cudaError_t (0 on success); launches on
// `stream_ptr`.
extern "C" int mas_path(const float* value, const int* y_lens,
                        const int* x_lens, float* path, unsigned* bits,
                        long long* stamps, int B, int T_y, int T_x, int warps,
                        int cells, int chunk, void* stream_ptr) {
  const bool fast = cells >= 1 && cells <= kFastMaxCells &&
                    warps * 32 <= kFastThreads;
  const bool wide = cells == kWideCells && warps * 32 <= kWideThreads;
  if (B <= 0 || T_y <= 0 || T_x <= 0 || warps < 1 || !(fast || wide) ||
      static_cast<long long>(warps) * 32 * cells < T_x || chunk < 1 ||
      chunk > kMaxChunkRows || chunk * warps * 32 > kMaxChunkWords) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (wide) {
    return static_cast<int>(run<kWideCells, kWideThreads, kWideRing>(
        value, y_lens, x_lens, path, bits, stamps, B, T_y, T_x, warps, chunk,
        stream));
  }
#define PHX_MAS_CASE(K)                                                \
  case K:                                                              \
    return static_cast<int>(run<K, kFastThreads, kFastRing>(           \
        value, y_lens, x_lens, path, bits, stamps, B, T_y, T_x, warps, \
        chunk, stream));
  switch (cells) {
    PHX_MAS_CASE(1)
    PHX_MAS_CASE(2)
    PHX_MAS_CASE(3)
    PHX_MAS_CASE(4)
  }
#undef PHX_MAS_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
