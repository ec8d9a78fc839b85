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
// Both kernels walk, for one (b * N + n, q tile), the k tiles from the first
// one the window reaches to the causal end: the reference's block
// reachability rule (k_end >= q_start - window + 1, and k_start <= q_end when
// causal), so a sliding layer costs O(S * window), not O(S^2). A loop inside
// the block takes the place of the TPU's sequential k grid axis. The entry
// point chooses the kernel by dtype alone, never as a fallback.
//
// Bound. By operations: 4 * hd flops per unmasked (q, k) pair against 2 bytes
// read per element of q, k, v (bf16); at S = 2048 that is far above the card's
// ridge point, so the least time is the flops over the tensor-core bf16 rate
// (989 TFLOP/s), which only wgmma reaches.
//
// bf16: flash_attention_wgmma_kernel, built on Hopper's own units.
//   A block takes 128 query rows of one head: two consumer warpgroups of 64
//   rows each, and a producer warpgroup (setmaxnreg: 24 registers a thread,
//   the consumers 240) whose first thread starts every load. Q is loaded once
//   and the K and V tiles stream through a ring of 3 (hd 32: 4) shared-memory
//   stages, each a cp.async.bulk.tensor (TMA) load over a 4-D view
//   (hd, heads, rows, B) of the tensor, encoded on the host with
//   cuTensorMapEncodeTiled (looked up through the CUDA runtime's entry
//   point query, so nothing links libcuda) and passed as a __grid_constant__
//   parameter. Each load completes on an mbarrier (full K, full V); each
//   consumer warp releases a stage on its empty mbarrier once its products
//   have read it. TMA fills rows past S or T with zeros, which score 0, so
//   the kpos < T mask stays.
//   Rows of a tile are boxes of one swizzle atom: 64 columns under the
//   128-byte swizzle (32 under the 64-byte one at hd 32; hd 80's 160-byte
//   rows as five boxes of 16 under the 32-byte one). The wgmma descriptors
//   name the same swizzle, so what TMA writes is what the tensor cores read.
//   S = Q K^T is wgmma.mma_async m64nBKk16 with both operands K-major in
//   shared memory, a k16 step 32 bytes into a box's row. O += P V is one
//   m64nHDk16 a k16 step with P from registers, the S accumulator's fragment
//   converted to bf16, and V from shared memory as an MN-major B.
//   Overlap: inside a warpgroup, S(j) and then P(j-1) V(j-1) are started
//   together, and the softmax of S(j) runs while the P V product does;
//   between the two warpgroups, a named barrier each hands the turn to start
//   products back and forth (ping-pong), so one's softmax runs while the
//   other's products do. Both walk every tile of the block, so the turns
//   pair up; a tile past one's diagonal or before its window adds exact
//   zeros.
//   Numerics as the plain version's to one bf16 ulp: the online softmax
//   works in base 2 with scale * log2(e) folded in (into exp2's FFMA on a
//   tile with no mask), takes 2^x on the SFU (ex2.approx.ftz), keeps (m, l)
//   in fp32 over the four lanes of a quad that share a row, and masks only
//   tiles that cross the diagonal, the window's first key or T. One bf16
//   rounding of P costs 2^-9 of each term, past the path's one-ulp check,
//   so P is split as P_hi = bf16(P) and P_lo = bf16(P - P_hi) into the same
//   fp32 accumulator: exact to 2^-17 of P, for 1.5x the tensor-core work of
//   Q K^T plus one P V.
//   Q K^T of bf16 inputs has exact products and fp32 sums.
//   Tiles: BK = 128 keys at hd 32, 64 and 80, 96 at hd 128, 64 at hd 192 and
//   48 at hd 256: a consumer thread holds O, one tile's S and the previous
//   tile's P halves at once, hd / 2 + BK registers, which BK keeps within
//   240 with no spill. Shared memory: 72-208 KB. The output is divided,
//   rounded, staged in the warpgroup's own Q tile (swizzled, so the stores
//   meet no bank conflict) and written in 16-byte stores, rows past S
//   clipped.
//   Scheduling: the q tiles launch in reverse order, so the longest causal
//   tiles start first; blockIdx.x = b * N + n puts the G query heads of one
//   kv head in adjacent blocks, which run together and read each K/V tile
//   once from device memory, the rest from L2. Two warpgroups on two heads of
//   one kv head would share the stages instead, but need G >= 2, and half the
//   path's shapes (olmoe, zamba2, hubert) have G = 1.
// fp32: CUDA cores (flash_attention_fp32_kernel). The tensor cores cannot
//   hold the reference's 2e-5 fp32 tolerance. 256 threads as a 16 x 16 grid,
//   each owning 4 query rows of a 64-row tile and BK / 16 score columns; K,
//   V and P tiles in shared memory, rows padded by one word. It takes the
//   same head dims, each a multiple of 16.

#include <cuda.h>   // CUtensorMap and its enums only: the encoder comes from the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// ---------------------------------------------------------- bf16 Hopper kernel
// Two consumer warpgroups of kWgRows query rows each, then one producer
// warpgroup whose first thread starts every TMA load.
constexpr int kWgRows = 64;
constexpr int kConsumers = 2;
constexpr int kWgBlockQ = kWgRows * kConsumers;
constexpr int kWgThreads = (kConsumers + 1) * 128;
constexpr int kProducerRegs = 24;    // setmaxnreg: 128 x 24 + 256 x 240 <= 65536
constexpr int kConsumerRegs = 240;
// Named barriers: 0 is __syncthreads; 1 + w stages warpgroup w's output;
// kTurnBarrier + w is warpgroup w's turn to start products.
constexpr int kTurnBarrier = 1 + kConsumers;

// The tiles and the shared-memory layout by head dim.
template <int HD>
struct WgTiles {
  // Key tile and ring depth. A consumer thread holds O (hd / 2 fp32), one
  // tile's S (BK / 2) and the previous tile's P halves (BK / 2 as bf16
  // pairs) at once; BK keeps that within 240 registers with no spill (96
  // keys at hd 128, 48 at hd 256).
  static constexpr int kBlockK = HD <= 80 ? 128 : HD == 128 ? 96 : HD == 192 ? 64 : 48;
  static constexpr int kStages = HD == 32 ? 4 : 3;
  // Columns of one TMA box: a row of one swizzle atom (128 bytes; 64 at hd 32,
  // 32 at hd 80, whose 160-byte rows are five boxes of 16 columns).
  static constexpr int kBox = HD == 80 ? 16 : (HD == 32 ? 32 : 64);
  static constexpr int kBoxes = HD / kBox;
  static constexpr int kRowBytes = kBox * 2;
  // wgmma descriptor layout type: 1 = 128-byte swizzle, 2 = 64, 3 = 32.
  static constexpr int kLayout = kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static constexpr int kQBytes = kWgRows * HD * 2;     // one warpgroup's Q, later its O
  static constexpr int kKVBytes = kBlockK * HD * 2;    // one K or V tile
  static constexpr int kKOff = kConsumers * kQBytes;
  static constexpr int kVOff = kKOff + kStages * kKVBytes;
  static constexpr int kBarOff = kVOff + kStages * kKVBytes;
  static constexpr int kBars = 1 + 3 * kStages;        // full Q; full K, full V, empty a stage
  static constexpr int kBytes = kBarOff + kBars * 8 + 1024;   // + the 1024-byte alignment
  static_assert(HD % kBox == 0 && kBlockK % 16 == 0, "whole boxes and k16 steps");
  static_assert(kQBytes % 1024 == 0 && kKVBytes % 1024 == 0, "tiles on swizzle repeats");
  static_assert(kBytes <= 232448, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A box of a 4-D tensor map at (c0, c1, c2, c3), innermost first, into shared
// memory at `dst`; completes its bytes on the mbarrier `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N of this warpgroup's wgmma groups are pending.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving a register across an asynchronous wgmma's
// start (its fence) or its wait.
template <int N>
__device__ __forceinline__ void pin_registers(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void pin_registers(uint32_t* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// bf16 pair (x0 in the low half, as the fragments hold it), rounded to nearest.
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(x1), "f"(x0));
  return r;
}

// (x0, x1) as bf16 pairs hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi, uint32_t& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

// Shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout type in bits 62-63.
template <int LAYOUT>
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(LAYOUT) << 62);
}

// d (64 x 48, fp32) = or += A (64 x 16, K-major, shared) * B (48 x 16, K-major, shared).
__device__ __forceinline__ void wgmma_ss_n48(float* d, uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23}, "
      "%24, %25, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, fp32) = or += A (64 x 16, K-major, shared) * B (64 x 16, K-major, shared).
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 96, fp32) = or += A (64 x 16, K-major, shared) * B (96 x 16, K-major, shared).
__device__ __forceinline__ void wgmma_ss_n96(float* d, uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %50, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "%48, %49, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 128, fp32) = or += A (64 x 16, K-major, shared) * B (128 x 16, K-major, shared).
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t desc_a, uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 32, fp32) += A (64 x 16, bf16 registers) * B (16 x 32, MN-major, shared).
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 64, fp32) += A (64 x 16, bf16 registers) * B (16 x 64, MN-major, shared).
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 80, fp32) += A (64 x 16, bf16 registers) * B (16 x 80, MN-major, shared).
__device__ __forceinline__ void wgmma_rs_n80(float* d, const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 128, fp32) += A (64 x 16, bf16 registers) * B (16 x 128, MN-major, shared).
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 192, fp32) += A (64 x 16, bf16 registers) * B (16 x 192, MN-major, shared).
__device__ __forceinline__ void wgmma_rs_n192(float* d, const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95}, "
      "{%96, %97, %98, %99}, %100, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d (64 x 256, fp32) += A (64 x 16, bf16 registers) * B (16 x 256, MN-major, shared).
__device__ __forceinline__ void wgmma_rs_n256(float* d, const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
      "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
      "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
      "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
      "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
      "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
      "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
      "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
      "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
      "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
      "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
      "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
      "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
      "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
      "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
      "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
      "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
      "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// S (64 x BK) = or += Q K^T over one k16 step, both operands K-major in shared memory.
template <int BK>
__device__ __forceinline__ void wgmma_scores(float* s, uint64_t desc_q, uint64_t desc_k,
                                             int accumulate) {
  static_assert(BK == 48 || BK == 64 || BK == 96 || BK == 128, "a key tile wgmma takes");
  if constexpr (BK == 48) wgmma_ss_n48(s, desc_q, desc_k, accumulate);
  if constexpr (BK == 64) wgmma_ss_n64(s, desc_q, desc_k, accumulate);
  if constexpr (BK == 96) wgmma_ss_n96(s, desc_q, desc_k, accumulate);
  if constexpr (BK == 128) wgmma_ss_n128(s, desc_q, desc_k, accumulate);
}

// O (64 x HD) += P V over one k16 step: P from registers, V MN-major in
// shared memory, its hd columns in boxes of kBox, LBO apart.
template <int HD>
__device__ __forceinline__ void wgmma_pv(float* o, const uint32_t (&p)[4], uint64_t desc_v) {
  if constexpr (HD == 32) wgmma_rs_n32(o, p, desc_v);
  if constexpr (HD == 64) wgmma_rs_n64(o, p, desc_v);
  if constexpr (HD == 80) wgmma_rs_n80(o, p, desc_v);
  if constexpr (HD == 128) wgmma_rs_n128(o, p, desc_v);
  if constexpr (HD == 192) wgmma_rs_n192(o, p, desc_v);
  if constexpr (HD == 256) wgmma_rs_n256(o, p, desc_v);
}

// Start S = Q K^T as one wgmma group: k16 steps along hd, each 32 bytes
// into a box's swizzled row, the next box after kBox columns.
template <int HD>
__device__ __forceinline__ void start_scores(float (&s)[WgTiles<HD>::kBlockK / 2],
                                             uint32_t q_tile, uint32_t k_tile) {
  using L = WgTiles<HD>;
  constexpr int BK = L::kBlockK;
  constexpr uint32_t kSbo = 8 * L::kRowBytes;   // the next 8 rows
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const uint32_t box = (kk * 16) / L::kBox, off = (kk * 16) % L::kBox * 2;
    const uint64_t dq =
        smem_desc<L::kLayout>(q_tile + box * kWgRows * L::kRowBytes + off, 16, kSbo);
    const uint64_t dk = smem_desc<L::kLayout>(k_tile + box * BK * L::kRowBytes + off, 16, kSbo);
    wgmma_scores<BK>(s, dq, dk, kk > 0);
  }
  wgmma_commit();
}

// Start O += P_hi V + P_lo V as one wgmma group; a k16 step is 16 keys of
// every box of V.
template <int HD>
__device__ __forceinline__ void start_pv(float (&o)[HD / 2],
                                         uint32_t (&p_hi)[WgTiles<HD>::kBlockK / 16][4],
                                         uint32_t (&p_lo)[WgTiles<HD>::kBlockK / 16][4],
                                         uint32_t v_tile) {
  using L = WgTiles<HD>;
  constexpr int BK = L::kBlockK;
  pin_registers<HD / 2>(o);   // the rescale and the split land before the fence
  pin_registers<BK / 4>(&p_hi[0][0]);
  pin_registers<BK / 4>(&p_lo[0][0]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    const uint64_t dv = smem_desc<L::kLayout>(v_tile + kk * 16 * L::kRowBytes,
                                              BK * L::kRowBytes, 8 * L::kRowBytes);
    wgmma_pv<HD>(o, p_hi[kk], dv);
    wgmma_pv<HD>(o, p_lo[kk], dv);
  }
  wgmma_commit();
}

// 2^x as one SFU instruction: a result below 2^-126 flushes to 0, which no
// fp32 sum of P with its largest term 1 can see. (exp2f adds a fix-up of
// the subnormal range around it.)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Scale one tile's scores into base 2 (masked where the tile crosses an
// edge), update the online softmax of rows row0 (entries 4 j + e, e = 0, 1)
// and row0 + 8 (e = 2, 3), and leave P = exp2(s - m) in s; each row's
// rescale of O goes to alpha. Entry 4 j + 2 h + e is key k_start + 8 j +
// 2 quad_col + e. An unmasked tile folds the scale into exp2's FFMA; a
// masked one scales first, so a masked score is exactly -1e30 and a row
// that has seen only masked scores keeps m = -1e30, as the reference does.
template <int BK>
__device__ __forceinline__ void softmax_tile(float (&s)[BK / 2], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], bool edge, int k_start,
                                             int row0, int quad_col, int T_len, int window,
                                             int causal, float scale_log2) {
  const float sl = edge ? 1.f : scale_log2;
  if (edge) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k_start + 8 * j + 2 * quad_col + (e & 1);
        const int qpos = row0 + 8 * (e >> 1);
        const bool keep = kpos < T_len && qpos - kpos < window && (!causal || qpos >= kpos);
        s[4 * j + e] = keep ? s[4 * j + e] * scale_log2 : kNegInf;
      }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) mx = fmaxf(mx, fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[h], mx * sl);
    alpha[h] = exp2_ftz(m[h] - m_new);
    m[h] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[4 * j + 2 * h] = exp2_ftz(fmaf(s[4 * j + 2 * h], sl, -m_new));
      s[4 * j + 2 * h + 1] = exp2_ftz(fmaf(s[4 * j + 2 * h + 1], sl, -m_new));
      sum += s[4 * j + 2 * h] + s[4 * j + 2 * h + 1];
    }
    l[h] = l[h] * alpha[h] + sum;
  }
}

// P = P_hi + P_lo, each the A operand of a k16 step straight from the S
// fragment (keys 16 kk .. 16 kk + 15 are groups j = 2 kk, 2 kk + 1).
template <int BK>
__device__ __forceinline__ void split_p(const float (&s)[BK / 2], uint32_t (&p_hi)[BK / 16][4],
                                        uint32_t (&p_lo)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], p_hi[kk][r], p_lo[kk][r]);
}

// Swizzle key of row r in the O staging tile (rows of HD / 8 16-byte chunks,
// chunk c stored at c ^ key): the eight rows a warp's store writes at once
// fall in distinct banks, and the key keeps every chunk inside its row.
template <int HD>
__device__ __forceinline__ int out_key(int r) {
  constexpr int CH = HD / 8;
  static_assert(CH % 8 == 0 || CH == 4 || CH == 10, "hd 32, 80 or a multiple of 64");
  return CH % 8 == 0 ? r & 7 : (CH == 4 ? (r >> 1) & 3 : (r >> 2) & 1);
}

// One (b * N + n, 128-row q tile) a block: warpgroups 0 and 1 own rows
// [0, 64) and [64, 128) of the tile, warpgroup 2 loads.
template <int HD>
__global__ void __launch_bounds__(kWgThreads, 1) flash_attention_wgmma_kernel(
    const __grid_constant__ CUtensorMap q_map, const __grid_constant__ CUtensorMap k_map,
    const __grid_constant__ CUtensorMap v_map, __nv_bfloat16* __restrict__ out, int S,
    int T_len, int N, int K, int window, int causal, float scale_log2) {
  using L = WgTiles<HD>;
  constexpr int BK = L::kBlockK;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;   // the 128-byte swizzle repeats every 1024
  const uint32_t bars = base + L::kBarOff;
  const uint32_t full_q = bars;
  auto full_k = [&](int st) { return bars + 8u * (1 + st); };
  auto full_v = [&](int st) { return bars + 8u * (1 + kStages + st); };
  auto empty = [&](int st) { return bars + 8u * (1 + 2 * kStages + st); };

  const int bn = blockIdx.x;   // the G heads of one kv head are adjacent blocks
  const int b = bn / N;
  const int n = bn % N;
  const int kv = n / (N / K);
  const int q_start = (gridDim.y - 1 - blockIdx.y) * kWgBlockQ;   // longest tiles first

  // k tiles the block reaches. window >= 1 and q_start < S, so lo stays in
  // int32 even for the global window of 2^30.
  const int q_end = min(q_start + kWgBlockQ, S) - 1;
  const int lo = q_start - window + 1;
  const int first = lo <= 0 ? 0 : lo / BK;
  int stop = (T_len + BK - 1) / BK;
  if (causal) stop = min(stop, q_end / BK + 1);
  auto stage_of = [&](int kt) { return (kt - first) % kStages; };
  auto parity_of = [&](int kt) { return static_cast<uint32_t>(((kt - first) / kStages) & 1); };

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty(st), kConsumers * 4);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == kConsumers) {
    // ------------------------------------------------------------ producer
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == kConsumers * 128) {
      mbar_expect_tx(full_q, kConsumers * L::kQBytes);
#pragma unroll
      for (int w = 0; w < kConsumers; ++w)
#pragma unroll
        for (int bx = 0; bx < L::kBoxes; ++bx)
          tma_load_4d(base + w * L::kQBytes + bx * kWgRows * L::kRowBytes, &q_map, full_q,
                      bx * L::kBox, n, q_start + w * kWgRows, b);
      for (int kt = first; kt < stop; ++kt) {
        const int st = stage_of(kt);
        if (kt - first >= kStages) mbar_wait(empty(st), parity_of(kt) ^ 1);
        const uint32_t k_tile = base + L::kKOff + st * L::kKVBytes;
        const uint32_t v_tile = base + L::kVOff + st * L::kKVBytes;
        mbar_expect_tx(full_k(st), L::kKVBytes);
#pragma unroll
        for (int bx = 0; bx < L::kBoxes; ++bx)
          tma_load_4d(k_tile + bx * BK * L::kRowBytes, &k_map, full_k(st), bx * L::kBox, kv,
                      kt * BK, b);
        mbar_expect_tx(full_v(st), L::kKVBytes);
#pragma unroll
        for (int bx = 0; bx < L::kBoxes; ++bx)
          tma_load_4d(v_tile + bx * BK * L::kRowBytes, &v_map, full_v(st), bx * L::kBox, kv,
                      kt * BK, b);
      }
    }
  } else {
    // ----------------------------------------------------------- consumers
    setmaxnreg_inc<kConsumerRegs>();
    const int t = threadIdx.x & 127;
    const int warp = t >> 5;
    const int lane = t & 31;
    const int quad_row = lane >> 2;   // row g of the accumulator fragments
    const int quad_col = lane & 3;    // column pair 2 tg of the accumulator fragments
    const int q0 = q_start + wg * kWgRows;
    const int row0 = q0 + warp * 16 + quad_row;   // this thread's rows: row0 and row0 + 8

    // Both warpgroups walk all the block's tiles, so their turns pair up: a
    // tile past one's diagonal or before its window is computed masked (it
    // adds exact zeros), and rows past S are computed and never stored.
    auto k_tile = [&](int kt) { return base + L::kKOff + stage_of(kt) * L::kKVBytes; };
    auto v_tile = [&](int kt) { return base + L::kVOff + stage_of(kt) * L::kKVBytes; };
    auto release = [&](int kt) {   // this warp's products have read the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(empty(stage_of(kt)));
    };
    auto edge_of = [&](int kt) {
      const int k_start = kt * BK;
      return k_start + BK > T_len || (causal && k_start + BK - 1 > q0) ||
             q0 + kWgRows - 1 - k_start >= window;
    };
    // Ping-pong: a warpgroup starts its products on its turn and then hands
    // the turn over, so one's softmax runs while the other's products do.
    auto my_turn = [&]() { named_barrier_sync(kTurnBarrier + wg, 2 * 128); };
    auto your_turn = [&]() { named_barrier_arrive(kTurnBarrier + (wg ^ 1), 2 * 128); };
    if (wg == 1) your_turn();   // warpgroup 0 goes first

    const uint32_t q_tile = base + wg * L::kQBytes;
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};   // this lane's partial sums, reduced over the quad at the end

    mbar_wait(full_q, 0);
    if (first < stop) {
      // Software pipeline: S(j) is started, then O += P(j-1) V(j-1), and the
      // softmax of S(j) runs while that product does.
      float s[BK / 2];
      uint32_t p_hi[BK / 16][4], p_lo[BK / 16][4];
      float alpha[2];
      mbar_wait(full_k(stage_of(first)), parity_of(first));
      my_turn();
      start_scores<HD>(s, q_tile, k_tile(first));
      your_turn();
      wgmma_wait<0>();
      pin_registers<BK / 2>(s);
      softmax_tile<BK>(s, m, l, alpha, edge_of(first), first * BK, row0, quad_col, T_len, window,
                       causal, scale_log2);   // O is 0: no rescale
      split_p<BK>(s, p_hi, p_lo);
      for (int kt = first + 1; kt < stop; ++kt) {
        mbar_wait(full_k(stage_of(kt)), parity_of(kt));
        mbar_wait(full_v(stage_of(kt - 1)), parity_of(kt - 1));
        my_turn();
        start_scores<HD>(s, q_tile, k_tile(kt));
        start_pv<HD>(o, p_hi, p_lo, v_tile(kt - 1));
        your_turn();
        wgmma_wait<1>();   // S(j) is done; P(j-1) V may still run
        pin_registers<BK / 2>(s);
        softmax_tile<BK>(s, m, l, alpha, edge_of(kt), kt * BK, row0, quad_col, T_len, window,
                         causal, scale_log2);
        wgmma_wait<0>();
        pin_registers<HD / 2>(o);
        release(kt - 1);
#pragma unroll
        for (int j = 0; j < HD / 8; ++j) {
          o[4 * j] *= alpha[0];
          o[4 * j + 1] *= alpha[0];
          o[4 * j + 2] *= alpha[1];
          o[4 * j + 3] *= alpha[1];
        }
        split_p<BK>(s, p_hi, p_lo);
      }
      mbar_wait(full_v(stage_of(stop - 1)), parity_of(stop - 1));
      my_turn();
      start_pv<HD>(o, p_hi, p_lo, v_tile(stop - 1));
      your_turn();
      wgmma_wait<0>();
      pin_registers<HD / 2>(o);
      release(stop - 1);
    }

    // Epilogue: O / max(l, 1e-20) rounded once to bf16, staged in the
    // warpgroup's own Q tile (its last reader, the final S product, has
    // completed), then copied out in 16-byte stores, rows past S clipped.
    if (q0 < S) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
        l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
        l[h] = 1.f / fmaxf(l[h], 1e-20f);
      }
      unsigned char* stage = smem_raw + (q_tile - raw);
      constexpr int CH = HD / 8;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * 16 + quad_row + 8 * h;
        unsigned char* row = stage + r * HD * 2 + quad_col * 4;
#pragma unroll
        for (int j = 0; j < CH; ++j)
          *reinterpret_cast<__nv_bfloat162*>(row + ((j ^ out_key<HD>(r)) << 4)) =
              __floats2bfloat162_rn(o[4 * j + 2 * h] * l[h], o[4 * j + 2 * h + 1] * l[h]);
      }
      named_barrier_sync(1 + wg, 128);
      const long long row_stride = static_cast<long long>(N) * HD;
      __nv_bfloat16* o_base = out + (static_cast<long long>(b) * S * N + n) * HD;
      for (int idx = t; idx < kWgRows * CH; idx += 128) {
        const int r = idx / CH, c = idx % CH;
        if (q0 + r < S)
          *reinterpret_cast<uint4*>(o_base + (q0 + r) * row_stride + c * 8) =
              *reinterpret_cast<const uint4*>(stage + r * HD * 2 + ((c ^ out_key<HD>(r)) << 4));
      }
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

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so the
// library links no libcuda of its own.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (B, rows, heads, hd) bf16 tensor as a 4-D map, innermost first, whose
// boxes are `box_rows` rows of one head by `box_cols` columns, swizzled over
// the box's row of box_cols * 2 bytes; rows past `rows` read as zeros.
bool encode_4d(EncodeTiled encode, CUtensorMap* map, const void* ptr, int B, int rows,
               int heads, int hd, int box_cols, int box_rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(B)};
  const cuuint64_t row_bytes = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t strides[3] = {row_bytes, row_bytes * heads, row_bytes * heads * rows};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = box_cols == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                      : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int B, int S,
                         int T_len, int N, int K, int window, int causal, float scale,
                         cudaStream_t stream) {
  using L = WgTiles<HD>;
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  CUtensorMap q_map, k_map, v_map;
  if (!encode_4d(encode, &q_map, q, B, S, N, HD, L::kBox, kWgRows) ||
      !encode_4d(encode, &k_map, k, B, T_len, K, HD, L::kBox, L::kBlockK) ||
      !encode_4d(encode, &v_map, v, B, T_len, K, HD, L::kBox, L::kBlockK))
    return cudaErrorInvalidValue;
  const cudaError_t attr =
      cudaFuncSetAttribute(flash_attention_wgmma_kernel<HD>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * N, (S + kWgBlockQ - 1) / kWgBlockQ), block(kWgThreads);
  flash_attention_wgmma_kernel<HD><<<grid, block, L::kBytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), S, T_len, N, K, window, causal,
      scale * kLog2e);
  return cudaGetLastError();
}

cudaError_t launch_hd(int hd, bool is_bf16, const void* q, const void* k, const void* v,
                      void* out, int B, int S, int T_len, int N, int K, int window, int causal,
                      float scale, cudaStream_t stream) {
#define FLASH_ARGS q, k, v, out, B, S, T_len, N, K, window, causal, scale, stream
  switch (hd) {
    case 32:
      return is_bf16 ? launch_wgmma<32>(FLASH_ARGS) : launch_fp32<32, 64>(FLASH_ARGS);
    case 64:
      return is_bf16 ? launch_wgmma<64>(FLASH_ARGS) : launch_fp32<64, 64>(FLASH_ARGS);
    case 80:
      return is_bf16 ? launch_wgmma<80>(FLASH_ARGS) : launch_fp32<80, 64>(FLASH_ARGS);
    case 128:
      return is_bf16 ? launch_wgmma<128>(FLASH_ARGS) : launch_fp32<128, 32>(FLASH_ARGS);
    case 192:
      return is_bf16 ? launch_wgmma<192>(FLASH_ARGS) : launch_fp32<192, 32>(FLASH_ARGS);
    case 256:
      return is_bf16 ? launch_wgmma<256>(FLASH_ARGS) : launch_fp32<256, 32>(FLASH_ARGS);
    default:
      return cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not synchronise
// and allocates nothing; returns the launch's CUDA error (0 on success). bf16
// inputs take the wgmma kernel and fp32 inputs the CUDA-core kernel.
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
