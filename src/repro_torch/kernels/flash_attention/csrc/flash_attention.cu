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
// rounded once to q's dtype.
//
// Design. One block per (b * N + n, 64-row q tile); 256 threads as a 16 x 16
// grid, each thread owning 4 query rows (ty + 16 i) and, per k tile, BK / 16
// score columns (tx + 16 j) and hd / 16 output columns (tx + 16 c). A loop in
// the block walks the k tiles in order, which takes the place of the TPU's
// sequential k grid axis. It starts at the first tile the window reaches and
// stops at the causal end, the reference's block-reachability rule
// (k_end >= q_start - window + 1, and k_start <= q_end when causal), so a
// sliding layer costs O(S * window), not O(S^2). Per k tile:
//   1. K and V rows are loaded (converted to fp32) into shared memory;
//   2. each thread computes its 4 x BK/16 scores from shared Q and K;
//   3. row max and row sum are reduced across the 16 threads of a row with
//      warp shuffles; the thread rescales its accumulators and writes P;
//   4. acc += P V from shared memory.
// Tiles are fp32 in shared memory with rows padded by one word, so the column
// reads of steps 2 and 4 fall in distinct banks. hd = 256 takes BK = 32 and
// hd = 128 BK = 32 (140 KB and 74 KB of dynamic shared memory); hd <= 64 takes
// BK = 64 (66 KB at hd = 64).
//
// Bound. By operations: 4 * hd flops per unmasked (q, k) pair against 2 bytes
// read per element of q, k, v (bf16); at S = 2048 that is far above the card's
// ridge point, so the least time is the flops over the tensor-core bf16 rate.
// This kernel does its arithmetic in fp32 on the CUDA cores (67 TFLOP/s at
// most) from shared memory, one load per FMA or so, so it runs well below
// even that rate. Tensor cores (mma/wgmma on bf16 tiles), TMA loads and more
// than one block per SM at hd = 256 are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlockQ = 64;
constexpr int kRows = kBlockQ / 16;   // query rows per thread
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

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

template <typename T, int HD, int BK>
__global__ void __launch_bounds__(kThreads) flash_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, int S, int T_len, int N, int K, int window, int causal,
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
  const T* q_base = q + (static_cast<long long>(b) * S * N + n) * HD;
  const T* k_base = k + (static_cast<long long>(b) * T_len * K + kv) * HD;
  const T* v_base = v + (static_cast<long long>(b) * T_len * K + kv) * HD;
  T* o_base = out + (static_cast<long long>(b) * S * N + n) * HD;

  for (int i = tid; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    const int s = q_start + r;
    q_s[r * L::kQStride + d] = s < S ? to_float(q_base[s * q_row + d]) : 0.f;
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
      k_s[r * L::kKStride + d] = in ? to_float(k_base[t * kv_row + d]) : 0.f;
      v_s[r * HD + d] = in ? to_float(v_base[t * kv_row + d]) : 0.f;
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
      // The reference's update, term for term: a row that has seen only masked
      // scores has m = -1e30 and takes exp(0) = 1 for them; its first unmasked
      // score then scales those terms by exp(-1e30 - m) = 0.
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
      for (int o = 0; o < kOutCols; ++o)
        store(o_base + s_pos * q_row + tx + 16 * o, acc[i][o] / denom);
    }
  }
}

template <typename T, int HD, int BK>
cudaError_t launch(const void* q, const void* k, const void* v, void* out, int B, int S,
                   int T_len, int N, int K, int window, int causal, float scale,
                   cudaStream_t stream) {
  constexpr size_t bytes = Tiles<HD, BK>::kBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * N, (S + kBlockQ - 1) / kBlockQ), block(kThreads);
  flash_attention_kernel<T, HD, BK><<<grid, block, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), S, T_len, N, K, window, causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, void* out, int B,
                      int S, int T_len, int N, int K, int window, int causal, float scale,
                      cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32, 64>(q, k, v, out, B, S, T_len, N, K, window, causal, scale, stream);
    case 64:
      return launch<T, 64, 64>(q, k, v, out, B, S, T_len, N, K, window, causal, scale, stream);
    case 128:
      return launch<T, 128, 32>(q, k, v, out, B, S, T_len, N, K, window, causal, scale, stream);
    case 256:
      return launch<T, 256, 32>(q, k, v, out, B, S, T_len, N, K, window, causal, scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not synchronise
// and allocates nothing; returns the launch's CUDA error (0 on success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* out,
                                   int B, int S, int T, int N, int K, int hd, int window,
                                   int causal, float scale, int is_bf16, void* stream) {
  const bool shape_ok = B > 0 && S > 0 && T > 0 && K > 0 && N % K == 0 && window >= 1 &&
                        (S + kBlockQ - 1) / kBlockQ <= 65535;
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any earlier error so the result is this launch's
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_hd<__nv_bfloat16>(hd, q, k, v, out, B, S, T, N, K, window, causal,
                                         scale, s)
              : launch_hd<float>(hd, q, k, v, out, B, S, T, N, K, window, causal, scale, s);
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
