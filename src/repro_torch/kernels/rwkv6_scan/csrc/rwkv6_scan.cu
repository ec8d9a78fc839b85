// WKV6 chunked scan for Hopper (sm_90a): RWKV6 "Finch" recurrence with a
// data-dependent decay per channel, the bonus u, and a carried state.
//
// Replaces the TPU kernel repro/kernels/rwkv6_scan/rwkv6_scan.py :: wkv6_pallas
// (body _wkv6_kernel) and computes the same function at the public layout,
// with no transposes around the call:
//   r, k (B, T, H, K) and v (B, T, H, V), all fp32 or all bf16; w (B, T, H, K),
//   u (H, K) and state (B, H, K, V) fp32; y (B, T, H, V) and the final state
//   (B, H, K, V) fp32.
// Within a chunk of c positions, with cum the inclusive cumsum of
// log max(w, 1e-38) and cum_prev = cum - log w (both <= 0):
//   y_t = (r_t * exp(cum_prev_t)) . S
//         + sum_{s<t} (sum_i r_t,i k_s,i exp(min(cum_prev_t,i - cum_s,i, 0))) v_s
//         + (sum_i r_t,i u_i k_t,i) v_t
//   S  <- exp(cum_last) * S + sum_s (k_s * exp(cum_last - cum_s)) (x) v_s
// The pair sum runs over the STRICT lower triangle: the diagonal is the u
// term. Every exponent is <= 0, so exp never overflows, and the min() keeps
// it so for pairs a reordering of the sums could touch. Positions past T are
// never read: they act as k = v = 0 and w = 1, which leaves the state as it
// was, as the reference's padding does.
//
// Design: two passes, so that the work that does not depend on the carried
// state runs for every chunk at once.
//   Pass 1, one block per (chunk, b, head), 10240 blocks at rwkv6-3b's shape
//   (B 2, T 2048, H 40, chunk 16): one thread per channel scans log2 w; one
//   thread per pair (t, s <= t) sums its score over the K channels; the
//   within-chunk part of y (the pair and u terms) goes to y; r * exp(cum_prev),
//   k * exp(cum_last - cum) and exp(cum_last) go to fp32 scratch.
//   Pass 2, one block per (b, head, 16 columns of V), 320 blocks, three to an
//   SM: a loop walks the chunks in order, in place of the TPU's sequential
//   chunk grid axis, with the fp32 state slice (K x 16) in shared memory from
//   the first chunk to the last; per chunk it adds (r * exp(cum_prev)) . S to
//   y and updates S, each thread four columns at two positions or channels (a
//   row of the state or of v is one 16-byte read for eight products). The next
//   chunk's inputs are loaded into registers while this one computes. Both
//   passes read rows of r, k, w and the scratch 16 bytes a load.
// The chunk length (16 or 32) and the key head dim (16, 32 or 64) are
// template arguments, so that index arithmetic and the channel loops compile
// to constants. The decays are kept in base 2 (log2f, exp2f: 2^x is one
// hardware instruction), the same function as the reference's natural
// exponent. Rows of the (c x K) tiles are padded by one word, so that threads
// reading different rows at one channel fall in distinct banks.
//
// Bound. Per (b, head, chunk): 3 K flops for each of the c(c-1)/2 strict
// pairs and the c diagonal terms, 2 V for each of their products with v,
// 2 c K V for y from the state and 2 c K V for the state update, all fp32 on
// the CUDA cores: 3.1 GFLOP at rwkv6-3b's prefill shape, 46 us at 67
// TFLOP/s, against 149 MB read and written (r, k, v bf16, w and y fp32), 44 us
// at 3.35 TB/s. The scratch adds 2 x 42 MB written and read and y is written
// twice, so the two passes move about 2.5 times the bytes the function needs;
// pass 2 is still a chain of dependent chunk steps. Tensor cores for the
// c x c and c x K products, and fusing the passes, are later work.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSlice = 16;   // columns of V per block of pass 2
constexpr int kQuads = kSlice / 4;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

// 16-byte loads: element e of a uint4 holding 16 / sizeof(T) values of T.
template <typename T>
__device__ __forceinline__ float elem(const uint4& q, int e) {
  return to_float(reinterpret_cast<const T*>(&q)[e]);
}

// acc += a * (the four floats at p, 16-byte aligned)
__device__ __forceinline__ void fma4(float4& acc, float a, const float* p) {
  const float4 b = *reinterpret_cast<const float4*>(p);
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// Pair p of the c (c + 1) / 2 pairs s <= t, row by row: p = t (t + 1) / 2 + s.
__device__ __forceinline__ void pair_of(int p, int& t, int& s) {
  t = static_cast<int>((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
  while (t * (t + 1) / 2 > p) --t;
  while ((t + 1) * (t + 2) / 2 <= p) ++t;
  s = p - t * (t + 1) / 2;
}

__host__ __device__ inline size_t intra_smem_bytes(int K, int V, int chunk) {
  const size_t kp = static_cast<size_t>(K) + 1;
  const size_t c = static_cast<size_t>(chunk);
  return sizeof(float) * (4 * c * kp + c * V + c * (c + 1) + K);
}

__host__ __device__ inline size_t state_smem_bytes(int K, int chunk) {
  const size_t kp = static_cast<size_t>(K) + 1;
  const size_t c = static_cast<size_t>(chunk);
  return sizeof(float) * (2 * c * kp + c * kSlice + static_cast<size_t>(K) * kSlice + K);
}

// Pass 1: everything of chunk blockIdx.x of (b, head) blockIdx.y that does not
// depend on the carried state.
template <int C, int K, typename T>
__global__ void __launch_bounds__(kThreads) wkv6_intra_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, float* __restrict__ y,
    float* __restrict__ rt_g, float* __restrict__ kw_g, float* __restrict__ al_g, int T_len,
    int H, int V) {
  extern __shared__ float smem[];
  constexpr int kp = K + 1;
  constexpr int cs = C + 1;
  float* r_s = smem;               // C x kp: r
  float* k_s = r_s + C * kp;       // C x kp: k
  float* cum_s = k_s + C * kp;     // C x kp: log2 w, then its inclusive cumsum
  float* cp_s = cum_s + C * kp;    // C x kp: cum_prev
  float* v_s = cp_s + C * kp;      // C x V
  float* sc_s = v_s + C * V;       // C x cs: scores, s < t, and the u term at s = t
  float* u_s = sc_s + C * cs;      // K

  const int n = blockIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int c0 = n * C;
  const int tid = threadIdx.x;
  const long long row_k = static_cast<long long>(H) * K;   // stride of a position
  const long long row_v = static_cast<long long>(H) * V;
  const long long base_k = static_cast<long long>(b) * T_len * row_k + static_cast<long long>(h) * K;
  const long long base_v = static_cast<long long>(b) * T_len * row_v + static_cast<long long>(h) * V;

  // The chunk into shared memory, fp32; log2 w with the reference's 1e-38
  // floor. Positions past T act as r = k = v = 0, w = 1.
  for (int i = tid; i < K; i += kThreads) u_s[i] = u[h * K + i];
  for (int i = tid; i < C * cs; i += kThreads) sc_s[i] = 0.f;   // s > t stays 0
  // Every load starts before the first is used: a loop that stored each
  // element as it arrived would wait out one memory latency per iteration.
  // Rows of K values are read 16 bytes at a time: kVr values of r and k,
  // four of w (K is a multiple of 16 and every row starts 16-byte aligned).
  constexpr int kVr = 16 / sizeof(T);
  constexpr int kPerR = (C * K / kVr + kThreads - 1) / kThreads;
  constexpr int kPerW = (C * K / 4 + kThreads - 1) / kThreads;
  uint4 lr[kPerR], lk[kPerR];
  float4 lw[kPerW];
#pragma unroll
  for (int m = 0; m < kPerR; ++m) {
    const int idx = tid + m * kThreads;
    const int pos = c0 + idx / (K / kVr);
    const long long off = base_k + pos * row_k + (idx % (K / kVr)) * kVr;
    const bool live = idx < C * K / kVr && pos < T_len;
    lr[m] = live ? *reinterpret_cast<const uint4*>(r + off) : make_uint4(0, 0, 0, 0);
    lk[m] = live ? *reinterpret_cast<const uint4*>(k + off) : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int m = 0; m < kPerW; ++m) {
    const int idx = tid + m * kThreads;
    const int pos = c0 + idx / (K / 4);
    const long long off = base_k + pos * row_k + (idx % (K / 4)) * 4;
    const bool live = idx < C * K / 4 && pos < T_len;
    lw[m] = live ? *reinterpret_cast<const float4*>(w + off) : make_float4(1.f, 1.f, 1.f, 1.f);
  }
  constexpr int kBatch = 8;
  for (int base = tid; base < C * V; base += kBatch * kThreads) {
    T lv[kBatch];
#pragma unroll
    for (int m = 0; m < kBatch; ++m) {
      const int idx = base + m * kThreads;
      const int pos = c0 + idx / V;
      lv[m] = idx < C * V && pos < T_len ? v[base_v + pos * row_v + idx % V] : T(0.f);
    }
#pragma unroll
    for (int m = 0; m < kBatch; ++m)
      if (base + m * kThreads < C * V) v_s[base + m * kThreads] = to_float(lv[m]);
  }
#pragma unroll
  for (int m = 0; m < kPerR; ++m) {
    const int idx = tid + m * kThreads;
    if (idx < C * K / kVr) {
      const int o = (idx / (K / kVr)) * kp + (idx % (K / kVr)) * kVr;
#pragma unroll
      for (int e = 0; e < kVr; ++e) {
        r_s[o + e] = elem<T>(lr[m], e);
        k_s[o + e] = elem<T>(lk[m], e);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kPerW; ++m) {
    const int idx = tid + m * kThreads;
    if (idx < C * K / 4) {
      const int o = (idx / (K / 4)) * kp + (idx % (K / 4)) * 4;
      cum_s[o] = log2f(fmaxf(lw[m].x, 1e-38f));
      cum_s[o + 1] = log2f(fmaxf(lw[m].y, 1e-38f));
      cum_s[o + 2] = log2f(fmaxf(lw[m].z, 1e-38f));
      cum_s[o + 3] = log2f(fmaxf(lw[m].w, 1e-38f));
    }
  }
  __syncthreads();

  for (int i = tid; i < K; i += kThreads) {
    float lg[C];
#pragma unroll
    for (int t = 0; t < C; ++t) lg[t] = cum_s[t * kp + i];
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < C; ++t) {
      acc += lg[t];
      cum_s[t * kp + i] = acc;
      cp_s[t * kp + i] = acc - lg[t];
    }
  }
  __syncthreads();

  // Scores: one thread per pair s <= t, summed over the K channels.
  for (int p = tid; p < C * (C + 1) / 2; p += kThreads) {
    int t, s;
    pair_of(p, t, s);
    const float* rt = r_s + t * kp;
    const float* ks = k_s + s * kp;
    float a0 = 0.f, a1 = 0.f;
    if (s < t) {
      const float* cpt = cp_s + t * kp;
      const float* cms = cum_s + s * kp;
#pragma unroll 4
      for (int i = 0; i < K; i += 2) {
        a0 = fmaf(rt[i] * ks[i], exp2f(fminf(cpt[i] - cms[i], 0.f)), a0);
        a1 = fmaf(rt[i + 1] * ks[i + 1], exp2f(fminf(cpt[i + 1] - cms[i + 1], 0.f)), a1);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < K; ++i) a0 = fmaf(rt[i] * u_s[i], ks[i], a0);
    }
    sc_s[t * cs + s] = a0 + a1;
  }
  __syncthreads();

  // y within the chunk: the pair terms and the u term.
  for (int idx = tid; idx < C * V; idx += kThreads) {
    const int t = idx / V;
    const int j = idx % V;
    if (c0 + t >= T_len) continue;
    float acc = 0.f;
    for (int s = 0; s <= t; ++s) acc = fmaf(sc_s[t * cs + s], v_s[s * V + j], acc);
    y[base_v + (c0 + t) * row_v + j] = acc;
  }
  // What pass 2 needs: r * exp(cum_prev), k * exp(cum_last - cum), exp(cum_last).
  for (int idx = tid; idx < C * K; idx += kThreads) {
    const int pos = c0 + idx / K;
    if (pos >= T_len) continue;
    const int i = idx % K;
    const int o = (idx / K) * kp + i;
    const long long off = base_k + pos * row_k + i;
    rt_g[off] = r_s[o] * exp2f(cp_s[o]);
    kw_g[off] = k_s[o] * exp2f(cum_s[(C - 1) * kp + i] - cum_s[o]);
  }
  for (int i = tid; i < K; i += kThreads)
    al_g[(static_cast<long long>(bh) * gridDim.x + n) * K + i] = exp2f(cum_s[(C - 1) * kp + i]);
}

// Pass 2: the carried state of (b, head) blockIdx.x at columns
// blockIdx.y * kSlice .. of V, chunk after chunk. Three blocks of 256 threads
// fit an SM at chunk 16 (at most 85 registers a thread), so rwkv6-3b's 320
// blocks run in one wave on 132 SMs.
template <int C, int K, typename T>
__global__ void __launch_bounds__(kThreads, C == 16 ? 3 : 1) wkv6_state_kernel(
    const float* __restrict__ rt_g, const float* __restrict__ kw_g,
    const float* __restrict__ al_g, const T* __restrict__ v, const float* __restrict__ state,
    float* __restrict__ y, float* __restrict__ state_out, int T_len, int H, int V) {
  extern __shared__ float smem[];
  constexpr int kp = K + 1;
  float* rt_s = smem;              // C x kp: r * exp(cum_prev)
  float* kw_s = rt_s + C * kp;     // C x kp: k * exp(cum_last - cum)
  float* v_s = kw_s + C * kp;      // C x kSlice
  float* s_s = v_s + C * kSlice;   // K x kSlice: the state's columns j0 ..
  float* al_s = s_s + K * kSlice;  // K: exp(cum_last)

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int j0 = blockIdx.y * kSlice;
  const int tid = threadIdx.x;
  const int nc = (T_len + C - 1) / C;
  const long long row_k = static_cast<long long>(H) * K;
  const long long row_v = static_cast<long long>(H) * V;
  const long long base_k = static_cast<long long>(b) * T_len * row_k + static_cast<long long>(h) * K;
  const long long base_v = static_cast<long long>(b) * T_len * row_v + static_cast<long long>(h) * V;
  const float* st_in = state + static_cast<long long>(bh) * K * V;
  float* st_out = state_out + static_cast<long long>(bh) * K * V;

  for (int i = tid; i < K * kSlice; i += kThreads) {
    const int j = j0 + i % kSlice;
    s_s[i] = j < V ? st_in[(i / kSlice) * V + j] : 0.f;
  }

  // Each y task is two positions by four columns, each state task two
  // channels by four columns: one 16-byte read of a row of the state (or of
  // v) then feeds eight products, which halves the shared-memory reads that
  // bound this pass.
  constexpr int kYTasks = C / 2 * kQuads;
  constexpr int kSTasks = K / 2 * kQuads;
  const int yt = 2 * (tid / kQuads);        // this thread's first position in the chunk
  const int yj = j0 + 4 * (tid % kQuads);   // and its first column
  const bool y_task = tid < kYTasks;
  // The next chunk, in registers: thread tid holds float4s tid + m * kThreads
  // of the (c x K) tiles, elements of the v slice, a decay, and the eight
  // values of y (pass 1's part) of its task.
  constexpr int kPerK = (C * K / 4 + kThreads - 1) / kThreads;
  constexpr int kPerV = (C * kSlice + kThreads - 1) / kThreads;
  float4 prt[kPerK], pkw[kPerK];
  float pal = 0.f, py[8];
  T pv[kPerV];
  auto load = [&](int n) {
    const int c0 = n * C;
#pragma unroll
    for (int m = 0; m < kPerK; ++m) {
      const int idx = tid + m * kThreads;
      const int pos = c0 + idx / (K / 4);
      const bool live = idx < C * K / 4 && pos < T_len;
      const long long off = base_k + pos * row_k + (idx % (K / 4)) * 4;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      prt[m] = live ? *reinterpret_cast<const float4*>(rt_g + off) : zero;
      pkw[m] = live ? *reinterpret_cast<const float4*>(kw_g + off) : zero;
    }
#pragma unroll
    for (int m = 0; m < kPerV; ++m) {
      const int idx = tid + m * kThreads;
      const int pos = c0 + idx / kSlice;
      const int j = j0 + idx % kSlice;
      pv[m] = idx < C * kSlice && pos < T_len && j < V ? v[base_v + pos * row_v + j] : T(0.f);
    }
    if (tid < K) pal = al_g[(static_cast<long long>(bh) * nc + n) * K + tid];
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int pos = c0 + yt + e / 4;
      const bool live = y_task && pos < T_len && yj + e % 4 < V;
      py[e] = live ? y[base_v + pos * row_v + yj + e % 4] : 0.f;
    }
  };

  if (nc > 0) load(0);
  for (int n = 0; n < nc; ++n) {
    const int c0 = n * C;
#pragma unroll
    for (int m = 0; m < kPerK; ++m) {
      const int idx = tid + m * kThreads;
      if (idx < C * K / 4) {
        const int o = (idx / (K / 4)) * kp + (idx % (K / 4)) * 4;
        rt_s[o] = prt[m].x;
        rt_s[o + 1] = prt[m].y;
        rt_s[o + 2] = prt[m].z;
        rt_s[o + 3] = prt[m].w;
        kw_s[o] = pkw[m].x;
        kw_s[o + 1] = pkw[m].y;
        kw_s[o + 2] = pkw[m].z;
        kw_s[o + 3] = pkw[m].w;
      }
    }
#pragma unroll
    for (int m = 0; m < kPerV; ++m) {
      const int idx = tid + m * kThreads;
      if (idx < C * kSlice) v_s[idx] = to_float(pv[m]);
    }
    if (tid < K) al_s[tid] = pal;
    float4 acc0 = make_float4(py[0], py[1], py[2], py[3]);
    float4 acc1 = make_float4(py[4], py[5], py[6], py[7]);
    __syncthreads();
    if (n + 1 < nc) load(n + 1);   // in flight while this chunk computes

    if (y_task) {
      const float* r0 = rt_s + yt * kp;
      const float* st = s_s + 4 * (tid % kQuads);
#pragma unroll 8
      for (int i = 0; i < K; ++i) {
        fma4(acc0, r0[i], st + i * kSlice);
        fma4(acc1, r0[kp + i], st + i * kSlice);
      }
      const float vals[8] = {acc0.x, acc0.y, acc0.z, acc0.w, acc1.x, acc1.y, acc1.z, acc1.w};
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int pos = c0 + yt + e / 4;
        if (pos < T_len && yj + e % 4 < V) y[base_v + pos * row_v + yj + e % 4] = vals[e];
      }
    }

    // The new state: channels 2 i2 and 2 i2 + 1, columns 4 q ..
    const int i2 = 2 * (tid / kQuads);
    const int q4 = 4 * (tid % kQuads);
    float4 next0 = make_float4(0.f, 0.f, 0.f, 0.f), next1 = next0;
    if (tid < kSTasks) {
      const float a0 = al_s[i2];
      const float a1 = al_s[i2 + 1];
      next0 = *reinterpret_cast<const float4*>(s_s + i2 * kSlice + q4);
      next1 = *reinterpret_cast<const float4*>(s_s + (i2 + 1) * kSlice + q4);
      next0 = make_float4(a0 * next0.x, a0 * next0.y, a0 * next0.z, a0 * next0.w);
      next1 = make_float4(a1 * next1.x, a1 * next1.y, a1 * next1.z, a1 * next1.w);
#pragma unroll
      for (int s = 0; s < C; ++s) {
        fma4(next0, kw_s[s * kp + i2], v_s + s * kSlice + q4);
        fma4(next1, kw_s[s * kp + i2 + 1], v_s + s * kSlice + q4);
      }
    }
    __syncthreads();   // y has read the state this chunk started from
    if (tid < kSTasks) {
      *reinterpret_cast<float4*>(s_s + i2 * kSlice + q4) = next0;
      *reinterpret_cast<float4*>(s_s + (i2 + 1) * kSlice + q4) = next1;
    }
  }
  __syncthreads();
  for (int i = tid; i < K * kSlice; i += kThreads) {
    const int j = j0 + i % kSlice;
    if (j < V) st_out[(i / kSlice) * V + j] = s_s[i];
  }
}

template <int C, int K, typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                   const void* state, void* y, void* state_out, void* rt, void* kw, void* al,
                   int B, int T_len, int H, int V, cudaStream_t stream) {
  const size_t bytes1 = intra_smem_bytes(K, V, C);
  const size_t bytes2 = state_smem_bytes(K, C);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_intra_kernel<C, K, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes1));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wkv6_state_kernel<C, K, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes2));
  if (err != cudaSuccess) return err;
  const int nc = (T_len + C - 1) / C;
  if (nc > 0) {
    wkv6_intra_kernel<C, K, T><<<dim3(nc, B * H), kThreads, bytes1, stream>>>(
        static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
        static_cast<const float*>(w), static_cast<const float*>(u), static_cast<float*>(y),
        static_cast<float*>(rt), static_cast<float*>(kw), static_cast<float*>(al), T_len, H, V);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const dim3 grid2(B * H, (V + kSlice - 1) / kSlice);
  wkv6_state_kernel<C, K, T><<<grid2, kThreads, bytes2, stream>>>(
      static_cast<const float*>(rt), static_cast<const float*>(kw), static_cast<const float*>(al),
      static_cast<const T*>(v), static_cast<const float*>(state), static_cast<float*>(y),
      static_cast<float*>(state_out), T_len, H, V);
  return cudaGetLastError();
}

// The chunk length and the key head dim are template arguments, so that
// index arithmetic and the channel loops compile to constants.
template <int C, typename T>
cudaError_t launch_k(int K, const void* r, const void* k, const void* v, const void* w,
                     const void* u, const void* state, void* y, void* state_out, void* rt,
                     void* kw, void* al, int B, int T_len, int H, int V, cudaStream_t s) {
  switch (K) {
    case 16:
      return launch<C, 16, T>(r, k, v, w, u, state, y, state_out, rt, kw, al, B, T_len, H, V, s);
    case 32:
      return launch<C, 32, T>(r, k, v, w, u, state, y, state_out, rt, kw, al, B, T_len, H, V, s);
    default:
      return launch<C, 64, T>(r, k, v, w, u, state, y, state_out, rt, kw, al, B, T_len, H, V, s);
  }
}

template <typename T>
cudaError_t launch_chunk(int chunk, int K, const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* state, void* y,
                         void* state_out, void* rt, void* kw, void* al, int B, int T_len, int H,
                         int V, cudaStream_t s) {
  return chunk == 16
             ? launch_k<16, T>(K, r, k, v, w, u, state, y, state_out, rt, kw, al, B, T_len, H, V,
                               s)
             : launch_k<32, T>(K, r, k, v, w, u, state, y, state_out, rt, kw, al, B, T_len, H, V,
                               s);
}

}  // namespace

// Plain C entry point for ctypes. Launches both passes on `stream`, does not
// synchronise and allocates nothing: rt and kw are fp32 scratch shaped as r,
// al fp32 scratch of B * H * ceil(T / chunk) * K. Returns the launches' CUDA
// error (0 on success).
extern "C" int rwkv6_wkv_fwd(const void* r, const void* k, const void* v, const void* w,
                             const void* u, const void* state, void* y, void* state_out,
                             void* rt, void* kw, void* al, int B, int T, int H, int K, int V,
                             int chunk, int is_bf16, void* stream) {
  const bool aligned = (reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(w) | reinterpret_cast<uintptr_t>(rt) |
                        reinterpret_cast<uintptr_t>(kw)) % 16 == 0;
  const bool shape_ok = aligned && B > 0 && T >= 0 && H > 0 && B * H <= 65535 &&
                        (K == 16 || K == 32 || K == 64) && V > 0 &&
                        (chunk == 16 || chunk == 32) &&
                        intra_smem_bytes(K, V, chunk) <= 232448;
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any earlier error so the result is this launch's
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_chunk<__nv_bfloat16>(chunk, K, r, k, v, w, u, state, y, state_out, rt, kw,
                                            al, B, T, H, V, s)
              : launch_chunk<float>(chunk, K, r, k, v, w, u, state, y, state_out, rt, kw, al, B,
                                    T, H, V, s);
  return static_cast<int>(err);
}

extern "C" const char* rwkv6_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
