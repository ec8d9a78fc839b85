// Flash attention forward for Hopper (sm_90a): causal with a runtime sliding
// window, or non-causal, with grouped-query heads.
//
// Replaces the TPU kernel repro/kernels/flash_attention/flash_attention.py ::
// flash_attention_bnh (body _flash_kernel), reached through
// repro/kernels/flash_attention/ops.py :: flash_attention, and computes the same
// function at the same public layout:
//   q (B, S, N, hd), k and v (B, T, K, hd), all fp32 or all bf16; out (B, S, N, hd)
//   in q's dtype. Query head n attends with kv head n / G (G = N / K): the K/V
//   heads are indexed, never repeated as the reference's wrapper repeats them.
// Scores are (q . k) * scale in fp32, masked to -1e30 unless kpos < T,
// qpos - kpos < window and, when causal, qpos >= kpos; an fp32 online softmax
// (m, l, acc) runs over the k tiles and the output is acc / max(l, 1e-20),
// rounded once to q's dtype. A row that has seen only masked scores has
// m = -1e30 and takes exp(0) = 1 for them, as the reference does; its first
// unmasked score scales those terms by exp(-1e30 - m) = 0.
//
// Both kernels walk, for one (b * N + n, 64-row q tile), the k tiles from the
// first one the window reaches to the causal end: the reference's block
// reachability rule (k_end >= q_start - window + 1, and k_start <= q_end when
// causal), so a sliding layer costs O(S * window), not O(S^2). A loop inside
// the block takes the place of the TPU's sequential k grid axis. The entry
// point chooses the kernel by dtype alone, never as a fallback.
//
// bf16: tensor cores (flash_attention_tc_kernel), the FA2 design.
//   Four warps, each owning 16 query rows. Q·K^T and P·V run as
//   mma.sync.m16n8k16 bf16 x bf16 -> fp32, operands from shared memory through
//   ldmatrix (V through ldmatrix.trans). Q is loaded once and the K/V tiles are
//   double-buffered with 16-byte cp.async; each 16-byte chunk of a row is
//   stored at chunk ^ (row & 7) (hd 32: chunk ^ ((row >> 1) & 3)), so the eight
//   rows one ldmatrix reads fall in distinct banks. The online softmax keeps
//   (m, l) in registers, reduces rows over the four lanes of a quad, and works
//   in base 2 with scale * log2(e) folded into the scores. The S accumulator's
//   fragment is already the A operand of the P·V mma, so P never goes through
//   shared memory. Masks are evaluated only on tiles that cross the causal
//   diagonal, the window's first key or T.
//   Precision: the plain version computes P and P·V in fp32, and the path's
//   check holds the bf16 output within one bf16 ulp. One bf16 rounding of P
//   costs 2^-9 of each term, so P is split as P_hi = bf16(P) and
//   P_lo = bf16(P - P_hi), and both run into the same fp32 accumulator: the
//   split is exact to 2^-17 of P, for 1.5x the tensor-core work. Q·K^T of bf16
//   inputs has exact products and fp32 sums, as the plain version does.
//   Tiles: BK = 32 keys at hd 256 and 192 (96 KB and 72 KB of shared memory;
//   at hd 256 the O accumulator alone is 128 registers a thread), 64 below
//   (80 KB at hd 128). The q tiles launch in reverse order, so the longest
//   causal tiles start first.
//   Head dims: 32, 64, 128 and 256 fill rows of 4 or a multiple of 8 chunks
//   of 16 bytes, as the swizzle needs; so does 192 (24 chunks), loaded in 12
//   or 6 passes of the 128 threads. hd 80 (10 chunks) sits in rows of 128
//   (the template's DH = 80 in HD = 128): the tiles' loads copy its 10
//   chunks a row, and every mma walks DH / 16 = 5 steps of 16 columns, so
//   the 6 chunks past them are never read and need no zero fill; the output
//   writes the 80 columns.
// fp32: CUDA cores (flash_attention_fp32_kernel). The tensor cores cannot
//   hold the reference's 2e-5 fp32 tolerance. 256 threads as a 16 x 16 grid,
//   each owning 4 query rows and BK / 16 score columns; K, V and P tiles in
//   shared memory, rows padded by one word. It takes the same head dims, each
//   a multiple of 16.
//
// Bound. By operations: 4 * hd flops per unmasked (q, k) pair against 2 bytes
// read per element of q, k, v (bf16); at S = 2048 that is far above the card's
// ridge point, so the least time is the flops over the tensor-core bf16 rate
// (989 TFLOP/s). mma.sync reaches a fraction of that rate, and the P split
// adds half again. Left for later: wgmma with TMA loads and a producer warp
// (the only way to the full rate), and packing the G query heads that share a
// kv head into one tile, so each K/V tile is read once for all of them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;
constexpr float kNegInf = -1.0e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------- fp32 kernel
constexpr int kThreads = 256;
constexpr int kRows = kBlockQ / 16;   // query rows per thread

// Reductions over the 16 lanes that share a query row (lanes tx = 0..15 of one ty).
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int HD, int BK>
struct Tiles {
  static constexpr int kQStride = HD + 1;
  static constexpr int kKStride = HD + 1;
  static constexpr int kPStride = BK + 1;
  static constexpr int kFloats =
      kBlockQ * kQStride + BK * kKStride + BK * HD + kBlockQ * kPStride;
  static constexpr size_t kBytes = static_cast<size_t>(kFloats) * sizeof(float);
};

template <int HD, int BK>
__global__ void __launch_bounds__(kThreads) flash_attention_fp32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int S, int T_len, int N, int K, int window, int causal,
    float scale) {
  using L = Tiles<HD, BK>;
  constexpr int kCols = BK / 16;     // score columns per thread
  constexpr int kOutCols = HD / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;                          // kBlockQ x kQStride
  float* k_s = q_s + kBlockQ * L::kQStride;   // BK x kKStride
  float* v_s = k_s + BK * L::kKStride;        // BK x HD
  float* p_s = v_s + BK * HD;                 // kBlockQ x kPStride

  const int bn = blockIdx.x;
  const int b = bn / N;
  const int n = bn % N;
  const int kv = n / (N / K);
  const int q_start = blockIdx.y * kBlockQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const long long q_row = static_cast<long long>(N) * HD;    // stride between positions
  const long long kv_row = static_cast<long long>(K) * HD;
  const float* q_base = q + (static_cast<long long>(b) * S * N + n) * HD;
  const float* k_base = k + (static_cast<long long>(b) * T_len * K + kv) * HD;
  const float* v_base = v + (static_cast<long long>(b) * T_len * K + kv) * HD;
  float* o_base = out + (static_cast<long long>(b) * S * N + n) * HD;

  for (int i = tid; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int s = q_start + r;
    q_s[r * L::kQStride + d] = s < S ? q_base[s * q_row + d] : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][kOutCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kOutCols; ++c) acc[i][c] = 0.f;
  }

  // k tiles the block can reach. window >= 1 and q_start < S, so lo stays in
  // int32 even for the global layers' window of 2^30.
  const int q_end = min(q_start + kBlockQ, S) - 1;
  const int lo = q_start - window + 1;
  const int first = lo <= 0 ? 0 : lo / BK;
  int stop = (T_len + BK - 1) / BK;
  if (causal) stop = min(stop, q_end / BK + 1);

  for (int kt = first; kt < stop; ++kt) {
    const int k_start = kt * BK;
    __syncthreads();  // the Q tile is stored; the last tile's K, V, P are consumed
    for (int i = tid; i < BK * HD; i += kThreads) {
      const int r = i / HD, d = i % HD;
      const int t = k_start + r;
      const bool in = t < T_len;
      k_s[r * L::kKStride + d] = in ? k_base[t * kv_row + d] : 0.f;
      v_s[r * HD + d] = in ? v_base[t * kv_row + d] : 0.f;
    }
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[kRows], kv_d[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i) qv[i] = q_s[(ty + 16 * i) * L::kQStride + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) kv_d[j] = k_s[(tx + 16 * j) * L::kKStride + d];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) s[i][j] = fmaf(qv[i], kv_d[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int r = ty + 16 * i;
      const int qpos = q_start + r;
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k_start + tx + 16 * j;
        const bool keep = kpos < T_len && qpos - kpos < window && (!causal || qpos >= kpos);
        s[i][j] = keep ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(row_max));
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(s[i][j] - m_new);
        p_s[r * L::kPStride + tx + 16 * j] = p;
        row_sum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum16(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOutCols; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) pv[i] = p_s[(ty + 16 * i) * L::kPStride + c];
#pragma unroll
      for (int o = 0; o < kOutCols; ++o) {
        const float vv = v_s[c * HD + tx + 16 * o];
#pragma unroll
        for (int i = 0; i < kRows; ++i) acc[i][o] = fmaf(pv[i], vv, acc[i][o]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int s_pos = q_start + ty + 16 * i;
    if (s_pos < S) {
      const float denom = fmaxf(l[i], 1e-20f);
#pragma unroll
      for (int o = 0; o < kOutCols; ++o) o_base[s_pos * q_row + tx + 16 * o] = acc[i][o] / denom;
    }
  }
}

// ------------------------------------------------------- bf16 tensor-core kernel
constexpr int kTcWarps = kBlockQ / 16;
constexpr int kTcThreads = kTcWarps * 32;

// Swizzle key of row r in a tile with CH 16-byte chunks a row: chunk c of the
// row is stored at c ^ key, so the eight rows one ldmatrix reads fall in
// distinct banks (hd 32 puts two rows in each 128-byte line).
template <int CH>
__device__ __forceinline__ int swizzle_key(int r) {
  static_assert(CH == 4 || CH % 8 == 0, "rows of 4 or a multiple of 8 chunks");
  return CH == 4 ? (r >> 1) & 3 : r & 7;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int bytes = valid ? 16 : 0;   // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Four 8 x 8 b16 matrices from shared-memory address `a`; lanes 8 i .. 8 i + 7
// give the rows of matrix i.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a)
               : "memory");
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// bf16 pair (x0 in the low half, as the mma fragments hold it), rounded to nearest.
__device__ __forceinline__ unsigned pack_bf16(float x0, float x1) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(x1), "f"(x0));
  return r;
}

// (x0, x1) as bf16 pairs hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x0, float x1, unsigned& hi, unsigned& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

// Byte offsets, within a swizzled row, of the 16-byte chunks 2 j + h for
// j = 0..3, where h is the lane's chunk within the pair and `key` its row's
// swizzle key; chunk pair j >= 4 adds (j >> 2) * 128 bytes to entry j & 3.
__device__ __forceinline__ void chunk_offsets(unsigned (&off)[4], int h, int key) {
#pragma unroll
  for (int j = 0; j < 4; ++j) off[j] = static_cast<unsigned>((((j << 1) | h) ^ key) << 4);
}

template <int HD, int BK>
struct TcTiles {   // HD: the width of a tile's rows in shared memory
  static constexpr int kChunks = HD / 8;    // 16-byte chunks a row
  static constexpr int kQElems = kBlockQ * HD;
  static constexpr int kKVElems = BK * HD;
  // Q, then two stages of (K, V).
  static constexpr size_t kBytes =
      static_cast<size_t>(kQElems + 4 * kKVElems) * sizeof(__nv_bfloat16);
};

// Copy rows [row0, row0 + ROWS) of a (rows, DH) bf16 matrix with row stride
// `stride` into a swizzled tile of rows HD wide (DH <= HD); rows at or past
// `limit` are zero-filled. Where the DH / 8 chunks of a row divide the
// threads, a thread copies one chunk column of every kTcThreads / DC-th row,
// walking a single pointer, so the copies cost no address registers beyond
// it; otherwise (hd 80 and 192) the threads walk the tile's chunks in order.
template <int ROWS, int DH, int HD>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long stride, int row0, int limit, int tid) {
  constexpr int CH = HD / 8;
  constexpr int DC = DH / 8;
  if constexpr (kTcThreads % DC == 0) {
    constexpr int kRowsPerPass = kTcThreads / DC;
    static_assert(ROWS % kRowsPerPass == 0, "whole passes");
    const int c = tid % DC;
    int r = tid / DC;
    const __nv_bfloat16* from = src + (row0 + r) * stride + c * 8;
    const long long step = kRowsPerPass * stride;
#pragma unroll
    for (; r < ROWS; r += kRowsPerPass, from += step) {
      const bool valid = row0 + r < limit;
      cp_async16(dst + r * HD + (c ^ swizzle_key<CH>(r)) * 8, valid ? from : src, valid);
    }
  } else {
    static_assert(ROWS * DC % kTcThreads == 0, "whole passes");
#pragma unroll
    for (int i = tid; i < ROWS * DC; i += kTcThreads) {
      const int r = i / DC, c = i % DC;
      const bool valid = row0 + r < limit;
      cp_async16(dst + r * HD + (c ^ swizzle_key<CH>(r)) * 8,
                 valid ? src + (row0 + r) * stride + c * 8 : src, valid);
    }
  }
}

// DH: the head dim of q, k, v and out in memory; HD: the width of the tiles'
// rows in shared memory, DH rounded up to a width the swizzle takes.
template <int DH, int HD, int BK>
__global__ void __launch_bounds__(kTcThreads) flash_attention_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int S, int T_len,
    int N, int K, int window, int causal, float scale_log2) {
  using L = TcTiles<HD, BK>;
  constexpr int CH = L::kChunks;
  constexpr int kSTiles = BK / 8;   // n8 tiles of the score row block
  constexpr int kOTiles = DH / 8;   // n8 tiles of the output row block
  static_assert(DH % 16 == 0 && DH <= HD, "mma steps of 16 columns within the row");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* kv_s = q_s + L::kQElems;   // stage st: K at 2 st, V at 2 st + 1

  const int bn = blockIdx.x;
  const int b = bn / N;
  const int n = bn % N;
  const int kv = n / (N / K);
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kBlockQ;   // longest tiles first
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int quad_row = lane >> 2;    // row g of the mma fragments
  const int quad_col = lane & 3;     // column pair 2 tg of the mma fragments
  const int w_row = warp * 16;       // the warp's first row in the q tile

  const long long q_row = static_cast<long long>(N) * DH;
  const long long kv_row = static_cast<long long>(K) * DH;
  const __nv_bfloat16* q_base = q + (static_cast<long long>(b) * S * N + n) * DH;
  const __nv_bfloat16* k_base = k + (static_cast<long long>(b) * T_len * K + kv) * DH;
  const __nv_bfloat16* v_base = v + (static_cast<long long>(b) * T_len * K + kv) * DH;
  __nv_bfloat16* o_base = out + (static_cast<long long>(b) * S * N + n) * DH;

  // ldmatrix addresses. Each lane reads one row of one 8 x 8 matrix: for
  // Q (A operand) row w_row + lane % 16, chunk 2 kk + lane / 16; for K (B
  // operand) row 16 np + lane % 8 + 8 (lane / 16), chunk 2 kk + (lane / 8) % 2;
  // for V (B operand, transposed) row 16 kt + lane % 8 + 8 ((lane / 8) % 2),
  // chunk 2 dp + lane / 16. Adding 16 rows keeps a row's swizzle key, so each
  // operand needs one row address and four chunk offsets a lane.
  constexpr unsigned kRowBytes = HD * sizeof(__nv_bfloat16);
  const unsigned smem = static_cast<unsigned>(__cvta_generic_to_shared(smem_raw));
  const int q_r = w_row + (lane & 15);
  const int k_r = (lane & 7) + ((lane >> 4) << 3);
  const int v_r = (lane & 7) + (((lane >> 3) & 1) << 3);
  const unsigned q_addr = smem + q_r * kRowBytes;
  unsigned q_off[4], k_off[4], v_off[4];
  chunk_offsets(q_off, lane >> 4, swizzle_key<CH>(q_r));
  chunk_offsets(k_off, (lane >> 3) & 1, swizzle_key<CH>(k_r));
  chunk_offsets(v_off, lane >> 4, swizzle_key<CH>(v_r));

  const int q_end = min(q_start + kBlockQ, S) - 1;
  const int lo = q_start - window + 1;
  const int first = lo <= 0 ? 0 : lo / BK;
  int stop = (T_len + BK - 1) / BK;
  if (causal) stop = min(stop, q_end / BK + 1);

  load_tile<kBlockQ, DH, HD>(q_s, q_base, q_row, q_start, S, tid);
  if (first < stop) {
    load_tile<BK, DH, HD>(kv_s, k_base, kv_row, first * BK, T_len, tid);
    load_tile<BK, DH, HD>(kv_s + L::kKVElems, v_base, kv_row, first * BK, T_len, tid);
  }
  cp_async_commit();

  float o[kOTiles][4];
#pragma unroll
  for (int j = 0; j < kOTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // Rows quad_row and quad_row + 8 of the warp's 16; l is this lane's partial
  // sum, reduced over the quad at the end (alpha is the same across the quad).
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};

  for (int kt = first; kt < stop; ++kt) {
    const int stage = (kt - first) & 1;
    if (kt + 1 < stop) {
      __nv_bfloat16* next = kv_s + (stage ^ 1) * 2 * L::kKVElems;
      load_tile<BK, DH, HD>(next, k_base, kv_row, (kt + 1) * BK, T_len, tid);
      load_tile<BK, DH, HD>(next + L::kKVElems, v_base, kv_row, (kt + 1) * BK, T_len, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const unsigned k_addr = smem + (L::kQElems + stage * 2 * L::kKVElems) * 2 + k_r * kRowBytes;
    const unsigned v_addr =
        smem + (L::kQElems + (stage * 2 + 1) * L::kKVElems) * 2 + v_r * kRowBytes;
    const int k_start = kt * BK;

    // S = Q K^T for the warp's 16 rows and the tile's BK keys.
    float s[kSTiles][4];
#pragma unroll
    for (int j = 0; j < kSTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      unsigned a[4];
      ldmatrix_x4(a, q_addr + q_off[kk & 3] + (kk >> 2) * 128);
#pragma unroll
      for (int np = 0; np < BK / 16; ++np) {
        unsigned bk[4];
        ldmatrix_x4(bk, k_addr + np * 16 * kRowBytes + k_off[kk & 3] + (kk >> 2) * 128);
        mma_bf16(s[2 * np], a, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], a, bk[2], bk[3]);
      }
    }

    // Scale into base 2, and mask where the tile crosses an edge.
    const bool edge = k_start + BK > T_len || (causal && k_start + BK - 1 > q_start) ||
                      q_start + kBlockQ - 1 - k_start >= window;
    if (edge) {
#pragma unroll
      for (int j = 0; j < kSTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kpos = k_start + 8 * j + 2 * quad_col + (e & 1);
          const int qpos = q_start + w_row + quad_row + 8 * (e >> 1);
          const bool keep =
              kpos < T_len && qpos - kpos < window && (!causal || qpos >= kpos);
          s[j][e] = keep ? s[j][e] * scale_log2 : kNegInf;
        }
    } else {
#pragma unroll
      for (int j = 0; j < kSTiles; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
    }

    // Online softmax, rows quad_row (e = 0, 1) and quad_row + 8 (e = 2, 3).
    float alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      alpha[h] = exp2f(m[h] - m_new);
      m[h] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kSTiles; ++j) {
        s[j][2 * h] = exp2f(s[j][2 * h] - m_new);
        s[j][2 * h + 1] = exp2f(s[j][2 * h + 1] - m_new);
        sum += s[j][2 * h] + s[j][2 * h + 1];
      }
      l[h] = l[h] * alpha[h] + sum;
    }
#pragma unroll
    for (int j = 0; j < kOTiles; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }

    // O += P V, P = P_hi + P_lo taken straight from the S fragments.
#pragma unroll
    for (int kt16 = 0; kt16 < BK / 16; ++kt16) {
      unsigned p_hi[4], p_lo[4];
      split_bf16(s[2 * kt16][0], s[2 * kt16][1], p_hi[0], p_lo[0]);
      split_bf16(s[2 * kt16][2], s[2 * kt16][3], p_hi[1], p_lo[1]);
      split_bf16(s[2 * kt16 + 1][0], s[2 * kt16 + 1][1], p_hi[2], p_lo[2]);
      split_bf16(s[2 * kt16 + 1][2], s[2 * kt16 + 1][3], p_hi[3], p_lo[3]);
#pragma unroll
      for (int dp = 0; dp < DH / 16; ++dp) {
        unsigned bv[4];
        ldmatrix_x4_trans(bv, v_addr + kt16 * 16 * kRowBytes + v_off[dp & 3] + (dp >> 2) * 128);
        mma_bf16(o[2 * dp], p_hi, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], p_hi, bv[2], bv[3]);
        mma_bf16(o[2 * dp], p_lo, bv[0], bv[1]);
        mma_bf16(o[2 * dp + 1], p_lo, bv[2], bv[3]);
      }
    }
    __syncthreads();   // this stage is consumed before the next load overwrites it
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = 1.f / fmaxf(l[h], 1e-20f);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s_pos = q_start + w_row + quad_row + 8 * h;
    if (s_pos < S) {
      __nv_bfloat16* row = o_base + s_pos * q_row + 2 * quad_col;
#pragma unroll
      for (int j = 0; j < kOTiles; ++j)
        *reinterpret_cast<__nv_bfloat162*>(row + 8 * j) =
            __floats2bfloat162_rn(o[j][2 * h] * l[h], o[j][2 * h + 1] * l[h]);
    }
  }
}

// ---------------------------------------------------------------- launchers
template <int HD, int BK>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* out, int B, int S,
                        int T_len, int N, int K, int window, int causal, float scale,
                        cudaStream_t stream) {
  constexpr size_t bytes = Tiles<HD, BK>::kBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_fp32_kernel<HD, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * N, (S + kBlockQ - 1) / kBlockQ), block(kThreads);
  flash_attention_fp32_kernel<HD, BK><<<grid, block, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), S, T_len, N, K, window, causal,
      scale);
  return cudaGetLastError();
}

template <int DH, int HD, int BK>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* out, int B, int S,
                      int T_len, int N, int K, int window, int causal, float scale,
                      cudaStream_t stream) {
  constexpr size_t bytes = TcTiles<HD, BK>::kBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_tc_kernel<DH, HD, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * N, (S + kBlockQ - 1) / kBlockQ), block(kTcThreads);
  flash_attention_tc_kernel<DH, HD, BK><<<grid, block, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), S, T_len, N, K,
      window, causal, scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t launch_hd(int hd, bool is_bf16, const void* q, const void* k, const void* v,
                      void* out, int B, int S, int T_len, int N, int K, int window, int causal,
                      float scale, cudaStream_t stream) {
#define FLASH_ARGS q, k, v, out, B, S, T_len, N, K, window, causal, scale, stream
  switch (hd) {
    case 32:
      return is_bf16 ? launch_tc<32, 32, 64>(FLASH_ARGS) : launch_fp32<32, 64>(FLASH_ARGS);
    case 64:
      return is_bf16 ? launch_tc<64, 64, 64>(FLASH_ARGS) : launch_fp32<64, 64>(FLASH_ARGS);
    case 80:
      return is_bf16 ? launch_tc<80, 128, 64>(FLASH_ARGS) : launch_fp32<80, 64>(FLASH_ARGS);
    case 128:
      return is_bf16 ? launch_tc<128, 128, 64>(FLASH_ARGS) : launch_fp32<128, 32>(FLASH_ARGS);
    case 192:
      return is_bf16 ? launch_tc<192, 192, 32>(FLASH_ARGS) : launch_fp32<192, 32>(FLASH_ARGS);
    case 256:
      return is_bf16 ? launch_tc<256, 256, 32>(FLASH_ARGS) : launch_fp32<256, 32>(FLASH_ARGS);
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not synchronise
// and allocates nothing; returns the launch's CUDA error (0 on success). bf16
// inputs take the tensor-core kernel and fp32 inputs the CUDA-core kernel.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int B, int S, int T, int N, int K, int hd, int window,
                                   int causal, float scale, int is_bf16, void* stream) {
  const bool shape_ok = B > 0 && S > 0 && T > 0 && K > 0 && N % K == 0 && window >= 1 &&
                        (S + kBlockQ - 1) / kBlockQ <= 65535;
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any earlier error so the result is this launch's
  return static_cast<int>(launch_hd(hd, is_bf16 != 0, q, k, v, out, B, S, T, N, K, window,
                                    causal, scale, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
