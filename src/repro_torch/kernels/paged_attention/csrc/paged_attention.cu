// Paged-attention decode for Hopper (sm_90a): one new token per sequence
// against a paged fp32 KV pool.
//
// Replaces the TPU kernel repro/kernels/paged_attention/paged_attention.py ::
// paged_attention (body _paged_kernel) and computes the same function at the
// same public layout:
//   q (B, N, hd) fp32 or bf16; k_pages, v_pages (P, page, K, hd) fp32;
//   block_table (B, max_pages) int32; lengths (B,) int32; window int;
//   out (B, N, hd) in q's dtype.
// Query head n attends with kv head n / G (G = N / K), over positions pos with
// pos < length and q_pos - pos < window (q_pos = length - 1), in an fp32
// online softmax; masked scores are -1e30 and the output is acc / max(l, 1e-20).
//
// Design. One block per (b, kv head); its G query heads are handled together,
// so each K/V row is read once for the whole group. A loop inside the block
// takes the place of the TPU's sequential page grid axis. It walks tokens in
// chunks of kChunk, starting at the first page the window reaches (the
// reference's whole-page skip test page_start + page - 1 > q_pos - window) and
// stopping at length, so the block table is never read past length: its
// unused entries are 0, which is a real slot of another sequence. Per chunk:
//   1. scores: each warp takes tokens, dots the K row with the G query heads
//      (lanes stride over hd, warp-shuffle sum);
//   2. softmax: warp g folds chunk scores into head g's running max/normaliser;
//   3. accumulate: each thread owns one column d of a few heads and adds
//      p * V[t][d] over the chunk, in registers.
//
// Bound. By bytes: every live K and V element is read once, 2 * length * K *
// hd * 4 B of fp32 pages per sequence, plus q and the output; the arithmetic
// is 4 * G flops per element read, far below the card's fp32 rate. What this
// simple design leaves on the table: the grid is only B * K blocks (4 blocks on
// 132 SMs at the serving shape), so one SM streams a whole sequence and the
// kernel is launch- and occupancy-bound; loads are plain 4-byte loads with no
// cp.async/TMA pipelining. Splitting the pages of a sequence over several
// blocks (flash-decoding) and vectorised, pipelined loads are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 64;              // tokens per iteration; 2 per lane in step 2
constexpr int kMaxG = 8;
constexpr int kMaxHd = 256;
constexpr int kLaneCols = kMaxHd / 32;  // hd columns each lane holds in step 1
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) paged_attention_kernel(
    const T* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ block_table,
    const int* __restrict__ lengths, T* __restrict__ out, int N, int K, int hd,
    int page_size, int max_pages, int window, float scale) {
  __shared__ float q_s[kMaxG * kMaxHd];
  __shared__ float p_s[kMaxG][kChunk];   // scores, then probabilities
  __shared__ long long row_s[kChunk];    // element offset of a token's K/V row; -1 if masked
  __shared__ float m_s[kMaxG], l_s[kMaxG], alpha_s[kMaxG];

  const int b = blockIdx.x / K;
  const int kv = blockIdx.x % K;
  const int G = N / K;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  const int length = lengths[b];
  const int q_pos = length - 1;
  const int* table = block_table + static_cast<long long>(b) * max_pages;
  const long long row_stride = static_cast<long long>(K) * hd;
  const long long head_base = (static_cast<long long>(b) * N + kv * G) * hd;

  for (int i = tid; i < G * hd; i += kThreads) q_s[i] = to_float(q[head_base + i]);
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  // Step 3 layout: thread owns column d for heads g0, g0 + gstep, ...
  const int d = tid % hd;
  const int g0 = tid / hd;
  const int gstep = kThreads / hd;
  float acc[kMaxG];
#pragma unroll
  for (int j = 0; j < kMaxG; ++j) acc[j] = 0.f;

  // First page the window reaches: smallest p with p*page + page - 1 > q_pos - window.
  const int edge = q_pos - window - page_size + 1;
  const int first_page = edge < 0 ? 0 : edge / page_size + 1;
  __syncthreads();

  for (int start = first_page * page_size; start < length; start += kChunk) {
    // 1. scores
    for (int t = warp; t < kChunk; t += kWarps) {
      const int pos = start + t;
      const bool valid = pos < length && q_pos - pos < window;  // warp-uniform
      long long row = -1;
      if (valid) {
        const int slot = table[pos / page_size];
        row = (static_cast<long long>(slot) * page_size + pos % page_size) * row_stride +
              static_cast<long long>(kv) * hd;
        const float* krow = k_pages + row;
        float kreg[kLaneCols];
#pragma unroll
        for (int j = 0; j < kLaneCols; ++j) {
          const int c = lane + 32 * j;
          kreg[j] = c < hd ? krow[c] : 0.f;
        }
        for (int g = 0; g < G; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < kLaneCols; ++j) {
            const int c = lane + 32 * j;
            if (c < hd) dot += q_s[g * hd + c] * kreg[j];
          }
          dot = warp_sum(dot);
          if (lane == 0) p_s[g][t] = dot * scale;
        }
      } else if (lane < G) {
        p_s[lane][t] = kNegInf;
      }
      if (lane == 0) row_s[t] = row;
    }
    __syncthreads();

    // 2. online softmax, warp g for query head g of the group
    if (warp < G) {
      const int g = warp;
      const float s0 = p_s[g][lane];
      const float s1 = p_s[g][lane + 32];
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      // Every chunk holds at least one unmasked token (q_pos itself is in the
      // last one), so masked tokens' exp(-1e30 - m_new) is exactly 0, as in
      // the reference; writing the 0 directly skips their exp.
      const float e0 = row_s[lane] >= 0 ? expf(s0 - m_new) : 0.f;
      const float e1 = row_s[lane + 32] >= 0 ? expf(s1 - m_new) : 0.f;
      const float alpha = expf(m_prev - m_new);
      const float sum = warp_sum(e0 + e1);
      p_s[g][lane] = e0;
      p_s[g][lane + 32] = e1;
      if (lane == 0) {
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        alpha_s[g] = alpha;
      }
    }
    __syncthreads();

    // 3. acc = acc * alpha + sum_t p[t] * V[t][d]
#pragma unroll
    for (int j = 0; j < kMaxG; ++j) {
      const int g = g0 + j * gstep;
      if (g < G) acc[j] *= alpha_s[g];
    }
#pragma unroll 8
    for (int t = 0; t < kChunk; ++t) {
      const long long row = row_s[t];   // block-uniform
      const float v = row >= 0 ? v_pages[row + d] : 0.f;
#pragma unroll
      for (int j = 0; j < kMaxG; ++j) {
        const int g = g0 + j * gstep;
        if (g < G) acc[j] += p_s[g][t] * v;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kMaxG; ++j) {
    const int g = g0 + j * gstep;
    if (g < G) store(out + head_base + g * hd + d, acc[j] / fmaxf(l_s[g], 1e-20f));
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not synchronise
// and allocates nothing; returns cudaGetLastError() (0 on success).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                                   const void* block_table, const void* lengths, void* out,
                                   int B, int N, int K, int hd, int page_size, int max_pages,
                                   int window, float scale, int q_is_bf16, void* stream) {
  const bool shape_ok = B > 0 && K > 0 && N % K == 0 && N / K <= kMaxG && hd >= 32 &&
                        hd <= kMaxHd && kThreads % hd == 0 && page_size > 0 &&
                        kChunk % page_size == 0 && max_pages > 0;
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any earlier error so the result is this launch's
  const dim3 grid(B * K), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_is_bf16) {
    paged_attention_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const float*>(k_pages),
        static_cast<const float*>(v_pages), static_cast<const int*>(block_table),
        static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), N, K, hd,
        page_size, max_pages, window, scale);
  } else {
    paged_attention_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pages),
        static_cast<const float*>(v_pages), static_cast<const int*>(block_table),
        static_cast<const int*>(lengths), static_cast<float*>(out), N, K, hd, page_size,
        max_pages, window, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
