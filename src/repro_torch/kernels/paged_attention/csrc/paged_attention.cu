// Paged-attention decode for Hopper (sm_90a): one new token per sequence
// against a paged fp32 KV pool, split over the sequence's pages
// (flash-decoding).
//
// Replaces the TPU kernel repro/kernels/paged_attention/paged_attention.py ::
// paged_attention (body _paged_kernel) and computes the same function at the
// same public layout:
//   q (B, N, hd) fp32 or bf16; k_pages, v_pages (P, page, K, hd) fp32;
//   block_table (B, max_pages) int32; lengths (B,) int32; window int;
//   out (B, N, hd) in q's dtype.
// Query head n attends with kv head n / G (G = N / K), over positions pos with
// pos < length and q_pos - pos < window (q_pos = length - 1), in an fp32
// softmax; masked scores are -1e30 and the output is acc / max(l, 1e-20).
//
// Design. Grid (B * K, parts): each block takes one (sequence, kv head) and one
// partition of kPartition tokens (whole pages), with the G query heads of the
// kv head together, so each K/V row is read once for the group. The wrapper
// sizes `parts` from the table's width on the host and never reads `lengths`
// there. A block reads only the pages the reference's whole-page skip keeps
// (page_start < length and page_start + page - 1 > q_pos - window), so the
// block table is never read past `length` (its unused entries are 0, a real
// slot of another sequence). Every page kept holds at least one unmasked
// position, so a partition with pages has a real maximum; one with none
// writes the empty partial m = -1e30, l = 0, acc = 0. In a block:
//   1. the partition's table entries go to shared memory once; q's G rows go
//      to registers, each lane holding the columns it multiplies; the
//      partition's V rows start on their way to shared memory (16-byte
//      cp.async), to arrive while the scores are computed;
//   2. scores: a group of lanes takes a token and reads its K row as 16-byte
//      loads, up to eight tokens a group in flight before any is used (at
//      hd 256 and G <= 4 the whole partition in one round); the G partial dot
//      products are reduced together, a butterfly that halves the heads a
//      lane carries at each step (G - 1 + log2(lanes / G) shuffles in place of
//      G log2(lanes));
//   3. softmax: warp g takes head g's scores, max, exp and sum, once for the
//      partition (no rescaling inside it);
//   4. acc: each thread owns four columns of a token group and reads the V
//      rows from shared memory, for all G heads; the token groups are summed
//      through shared memory.
// Four barriers a partition. With one partition (the serving path: contexts
// of at most kPartition tokens) the block writes the output itself. Otherwise
// it writes (m, l, acc) to fp32 scratch, and paged_combine_kernel merges the
// partials: out = sum_p e^(m_p - M) acc_p / max(sum_p e^(m_p - M) l_p, 1e-20),
// M = max_p m_p, where an empty partial weighs exp(-1e30 - M) = 0.
//
// Bound. By bytes: every live K and V element is read once, 2 * length * K *
// hd * 4 B of fp32 pages per sequence, plus q and the output; the arithmetic
// is 4 * G flops per element read, far below the card's fp32 rate. The
// partials add 8 * (G + G * hd) bytes a partition (written, then read).
// Left for later: TMA gathers of whole pages, and bf16 pools (half the bytes).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPartition = 64;           // tokens a block takes; a multiple of every page size
constexpr int kMinPage = 8;
constexpr int kCombineThreads = 128;
constexpr float kNegInf = -1.0e30f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

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

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float4 load_q4(const void* q, long long i, bool bf16) {
  if (bf16) {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(
        static_cast<const __nv_bfloat16*>(q) + i);
    const float2 a = __bfloat1622float2(p[0]);
    const float2 b = __bfloat1622float2(p[1]);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  return *reinterpret_cast<const float4*>(static_cast<const float*>(q) + i);
}

__device__ __forceinline__ void store_out(void* out, long long i, float x, bool bf16) {
  if (bf16) {
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16(x);
  } else {
    static_cast<float*>(out)[i] = x;
  }
}

// Sum G partial values over the LANES lanes of a group at once. Each step
// halves the heads a lane carries, keeping the upper half where the lane's bit
// is set; returns the full sum of head `head`, which lanes that differ only
// below bit LANES / G share.
template <int G, int LANES>
__device__ __forceinline__ float reduce_heads(float (&v)[G], int lane, int& head) {
  head = 0;
#pragma unroll
  for (int n = G, o = LANES / 2; n > 1; n >>= 1, o >>= 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int j = 0; j < n / 2; ++j) {
      const float send = upper ? v[j] : v[j + n / 2];
      const float keep = upper ? v[j + n / 2] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    if (upper) head += n / 2;
  }
  float x = v[0];
#pragma unroll
  for (int o = LANES / (2 * G); o >= 1; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD, int G>
struct Smem {   // dynamic shared memory: the partition's V rows, then the acc partials
  static constexpr int kGroups = kThreads / (HD / 4);
  static constexpr size_t kBytes =
      static_cast<size_t>(kPartition * HD + kGroups * G * HD) * sizeof(float);
};

template <int HD, int G>
__global__ void __launch_bounds__(kThreads, 2) paged_partition_kernel(
    const void* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, const int* __restrict__ block_table,
    const int* __restrict__ lengths, void* __restrict__ out, float* __restrict__ part_ml,
    float* __restrict__ part_acc, int N, int K, int page_size, int max_pages, int window,
    float scale, int q_is_bf16) {
  constexpr int kVec = HD / 4;                            // float4 in a row
  constexpr int kLanes = kVec < 32 ? kVec : 32;           // lanes a token takes (step 2)
  constexpr int kTokPerWarp = 32 / kLanes;
  constexpr int kVecPerLane = kVec / kLanes;
  constexpr int kGroups = Smem<HD, G>::kGroups;            // token groups (step 4)
  // Tokens a lane group has in flight in step 2: the whole partition where K
  // and q fit in 24 float4 registers a lane (at most 4 with eight heads,
  // whose accumulators take the room).
  constexpr int kBudget = G >= 8 ? 4 : 24 / kVecPerLane - G;
  constexpr int kWant = kPartition / (kWarps * kTokPerWarp);
  constexpr int kKUnroll = kWant < kBudget ? kWant : kBudget;
  static_assert(kLanes >= G && kKUnroll >= 1, "lanes cover the heads; K fits");
  __shared__ float s_s[G][kPartition];                    // scores, then probabilities
  __shared__ int table_s[kPartition / kMinPage];
  __shared__ float m_s[G], l_s[G];
  extern __shared__ __align__(16) float smem[];
  float* v_s = smem;                                      // kPartition x HD
  float* red_s = smem + kPartition * HD;                  // kGroups x (G x HD)

  const int bk = blockIdx.x;
  const int b = bk / K;
  const int kv = bk % K;
  const int part = blockIdx.y;
  const int parts = gridDim.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool bf16 = q_is_bf16 != 0;
  const long long out_base = (static_cast<long long>(b) * N + kv * G) * HD;
  const long long part_base = (static_cast<long long>(bk) * parts + part) * G;

  // The partition's live tokens [start, end): from the first page the window
  // reaches (smallest p with p * page + page - 1 > q_pos - window) to length,
  // within the table's pages.
  const int length = lengths[b];
  const int q_pos = length - 1;
  const long long edge = static_cast<long long>(q_pos) - window - page_size + 1;
  const int first_page = edge < 0 ? 0 : static_cast<int>(edge / page_size) + 1;
  const int t0 = part * kPartition;
  const int start = max(t0, first_page * page_size);
  const int end = min(min(t0 + kPartition, length), max_pages * page_size);
  const int n = end - start;
  if (n <= 0) {   // block-uniform: an empty partial, or a zero output
    for (int i = tid; i < G * HD; i += kThreads) {
      if (parts == 1) {
        store_out(out, out_base + i, 0.f, bf16);
      } else {
        part_acc[part_base * HD + i] = 0.f;
      }
    }
    if (parts > 1 && tid < G) {
      part_ml[(part_base + tid) * 2] = kNegInf;
      part_ml[(part_base + tid) * 2 + 1] = 0.f;
    }
    return;
  }

  // 1. table entries and q.
  const int page_shift = __ffs(page_size) - 1;
  const int first_slot_page = start >> page_shift;
  const int* table = block_table + static_cast<long long>(b) * max_pages;
  if (tid <= (end - 1 - start) >> page_shift) table_s[tid] = table[first_slot_page + tid];
  const long long row_stride = static_cast<long long>(K) * HD;
  const int page_mask = page_size - 1;

  const int tok = lane / kLanes;    // step 2: the lane group's token in a pass
  const int sub = lane % kLanes;    // and the lane's place in the group
  float4 q_r[G][kVecPerLane];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int j = 0; j < kVecPerLane; ++j)
      q_r[g][j] = load_q4(q, out_base + g * HD + 4 * (sub + kLanes * j), bf16);
  __syncthreads();

  auto row_of = [&](int i) {   // element offset of token start + i's K/V row
    const int pos = start + i;
    const int slot = table_s[(pos >> page_shift) - first_slot_page];
    return (static_cast<long long>(slot) * page_size + (pos & page_mask)) * row_stride +
           static_cast<long long>(kv) * HD;
  };
  for (int c = tid; c < n * kVec; c += kThreads) {
    const int i = c / kVec, v4 = c % kVec;
    cp_async16(v_s + i * HD + 4 * v4, v_pages + row_of(i) + 4 * v4);
  }

  // 2. scores.
  for (int base = warp * kTokPerWarp * kKUnroll; base < n;
       base += kWarps * kTokPerWarp * kKUnroll) {
    float4 k_r[kKUnroll][kVecPerLane];
#pragma unroll
    for (int u = 0; u < kKUnroll; ++u) {
      const int i = base + u * kTokPerWarp + tok;
      const long long row = i < n ? row_of(i) : -1;
#pragma unroll
      for (int j = 0; j < kVecPerLane; ++j)
        k_r[u][j] = row >= 0
                        ? *reinterpret_cast<const float4*>(k_pages + row + 4 * (sub + kLanes * j))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kKUnroll; ++u) {
      float dots[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float d = 0.f;
#pragma unroll
        for (int j = 0; j < kVecPerLane; ++j) d += dot4(q_r[g][j], k_r[u][j]);
        dots[g] = d;
      }
      int head;
      const float dot = reduce_heads<G, kLanes>(dots, lane, head);
      const int i = base + u * kTokPerWarp + tok;
      if (i < n && (sub & (kLanes / G - 1)) == 0)
        s_s[head][i] = q_pos - (start + i) < window ? dot * scale : kNegInf;
    }
  }
  __syncthreads();

  // 3. softmax of each head over the partition.
  if (warp < G) {
    float mx = kNegInf;
    for (int i = lane; i < n; i += 32) mx = fmaxf(mx, s_s[warp][i]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int i = lane; i < n; i += 32) {
      const float p = expf(s_s[warp][i] - mx);   // masked: exp(-1e30 - mx) = 0
      s_s[warp][i] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[warp] = mx;
      l_s[warp] = sum;
    }
  }
  cp_async_wait_all();   // this thread's V copies; the barrier publishes everyone's
  __syncthreads();

  // 4. acc[g][4 c .. 4 c + 3] over the thread's token group.
  const int grp = tid / kVec;
  const int c4 = tid % kVec;
  float4 acc[G];
#pragma unroll
  for (int g = 0; g < G; ++g) acc[g] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int i = grp; i < n; i += kGroups) {
    const float4 v = reinterpret_cast<const float4*>(v_s + i * HD)[c4];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = s_s[g][i];
      acc[g].x += p * v.x;
      acc[g].y += p * v.y;
      acc[g].z += p * v.z;
      acc[g].w += p * v.w;
    }
  }
#pragma unroll
  for (int g = 0; g < G; ++g)
    reinterpret_cast<float4*>(red_s + (grp * G + g) * HD)[c4] = acc[g];
  __syncthreads();

  for (int i = tid; i < G * HD; i += kThreads) {
    float a = 0.f;
#pragma unroll 4
    for (int t = 0; t < kGroups; ++t) a += red_s[t * G * HD + i];
    if (parts == 1) {
      store_out(out, out_base + i, a / fmaxf(l_s[i / HD], 1e-20f), bf16);
    } else {
      part_acc[part_base * HD + i] = a;
    }
  }
  if (parts > 1 && tid < G) {
    part_ml[(part_base + tid) * 2] = m_s[tid];
    part_ml[(part_base + tid) * 2 + 1] = l_s[tid];
  }
}

// Merge the partials of one (sequence, kv head): out = sum_p w_p acc_p /
// max(sum_p w_p l_p, 1e-20) with w_p = exp(m_p - max_p m_p).
__global__ void __launch_bounds__(kCombineThreads) paged_combine_kernel(
    const float* __restrict__ part_ml, const float* __restrict__ part_acc,
    void* __restrict__ out, int N, int K, int G, int hd, int parts, int q_is_bf16) {
  const int bk = blockIdx.x;
  const int b = bk / K;
  const int kv = bk % K;
  const long long out_base = (static_cast<long long>(b) * N + kv * G) * hd;
  const int i = blockIdx.y * kCombineThreads + threadIdx.x;   // element g * hd + d
  if (i < G * hd) {
    const int g = i / hd;
    const float* ml = part_ml + (static_cast<long long>(bk) * parts * G + g) * 2;
    float mx = kNegInf;
    for (int p = 0; p < parts; ++p) mx = fmaxf(mx, ml[p * G * 2]);
    float l = 0.f, a = 0.f;
#pragma unroll 8
    for (int p = 0; p < parts; ++p) {
      const float w = expf(ml[p * G * 2] - mx);
      l += w * ml[p * G * 2 + 1];
      a += w * part_acc[(static_cast<long long>(bk) * parts + p) * G * hd + i];
    }
    store_out(out, out_base + i, a / fmaxf(l, 1e-20f), q_is_bf16 != 0);
  }
}

template <int HD, int G>
cudaError_t launch_partitions(const void* q, const float* k_pages, const float* v_pages,
                              const int* table, const int* lengths, void* out, float* part_ml,
                              float* part_acc, int B, int N, int K, int page_size,
                              int max_pages, int window, float scale, int q_is_bf16,
                              int parts, cudaStream_t stream) {
  constexpr size_t bytes = Smem<HD, G>::kBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      paged_partition_kernel<HD, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(B * K, parts), block(kThreads);
  paged_partition_kernel<HD, G><<<grid, block, bytes, stream>>>(
      q, k_pages, v_pages, table, lengths, out, part_ml, part_acc, N, K, page_size,
      max_pages, window, scale, q_is_bf16);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_g(int G, const void* q, const float* k_pages, const float* v_pages,
                     const int* table, const int* lengths, void* out, float* part_ml,
                     float* part_acc, int B, int N, int K, int page_size, int max_pages,
                     int window, float scale, int q_is_bf16, int parts, cudaStream_t stream) {
#define PAGED_ARGS q, k_pages, v_pages, table, lengths, out, part_ml, part_acc, B, N, K, \
                   page_size, max_pages, window, scale, q_is_bf16, parts, stream
  switch (G) {
    case 1: return launch_partitions<HD, 1>(PAGED_ARGS);
    case 2: return launch_partitions<HD, 2>(PAGED_ARGS);
    case 4: return launch_partitions<HD, 4>(PAGED_ARGS);
    case 8: return launch_partitions<HD, 8>(PAGED_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef PAGED_ARGS
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not synchronise
// and allocates nothing: with parts > 1, part_ml (B * K * parts * G * 2) and
// part_acc (B * K * parts * G * hd) are the caller's fp32 scratch, and the
// combine kernel follows the partition kernel; with parts == 1 they are not
// read. `part_tokens` must equal the kernel's partition. Returns
// cudaGetLastError() (0 on success).
extern "C" int paged_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                                   const void* block_table, const void* lengths, void* out,
                                   void* part_ml, void* part_acc, int B, int N, int K, int hd,
                                   int page_size, int max_pages, int window, float scale,
                                   int q_is_bf16, int parts, int part_tokens, void* stream) {
  const int G = K > 0 ? N / K : 0;
  const bool shape_ok = B > 0 && K > 0 && N % K == 0 && page_size >= kMinPage &&
                        (page_size & (page_size - 1)) == 0 &&
                        kPartition % page_size == 0 && max_pages > 0 && parts >= 1 &&
                        parts <= 65535 && part_tokens == kPartition &&
                        (parts == 1 || (part_ml != nullptr && part_acc != nullptr));
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any earlier error so the result is this launch's
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* kp = static_cast<const float*>(k_pages);
  const float* vp = static_cast<const float*>(v_pages);
  const int* table = static_cast<const int*>(block_table);
  const int* lens = static_cast<const int*>(lengths);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  cudaError_t err;
#define PAGED_ARGS G, q, kp, vp, table, lens, out, ml, acc, B, N, K, page_size, max_pages, \
                   window, scale, q_is_bf16, parts, s
  switch (hd) {
    case 32: err = launch_g<32>(PAGED_ARGS); break;
    case 64: err = launch_g<64>(PAGED_ARGS); break;
    case 128: err = launch_g<128>(PAGED_ARGS); break;
    case 256: err = launch_g<256>(PAGED_ARGS); break;
    default: err = cudaErrorInvalidValue;
  }
#undef PAGED_ARGS
  if (err != cudaSuccess || parts == 1) return static_cast<int>(err);
  const dim3 grid(B * K, (G * hd + kCombineThreads - 1) / kCombineThreads);
  paged_combine_kernel<<<grid, kCombineThreads, 0, s>>>(ml, acc, out, N, K, G, hd, parts,
                                                        q_is_bf16);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* paged_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
