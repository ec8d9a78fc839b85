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
// Design: the state is carried from step to step, a step being 64 positions
// (4 chunks of 16 or 2 of 32), in three launches, so that the sequential part
// is 32 steps at rwkv6-3b's T 2048 and not 128 chunks:
//   Pass 1 (wkv6_step_kernel), one block per (step, b, head): the step's own
//   state contribution dS = (k * exp(cum_last - cum))^T v over its 64
//   positions, on the tensor cores, and its decay exp(cum_last), cum taken
//   over the step, into fp32 scratch.
//   Pass 2 (wkv6_state_kernel): S_n = exp(cum_last,n) * S_{n-1} + dS_n for
//   every (b, head) at once, 32 float4s of the state a block. The steps are
//   cut into segments, one a warp: each warp loads its segment's dS and
//   decays at once and runs the recurrence from a zero state; the state
//   entering each segment is then formed from the segments before it. dS_n
//   is overwritten with S_{n-1}, the state step n starts from.
//   Pass 3 (wkv6_output_kernel), one block per (step, b, head): from the
//   state the step starts from, its chunks in order, y written once. Each
//   warp owns 8 columns of V and keeps its columns of the state in mma
//   accumulators from chunk to chunk. Per chunk: the next chunk's r, k, w, v
//   come by cp.async; the scan of log2 w, four lanes a channel with shuffles;
//   the pair scores; y = (r exp(cum_prev)) S + scores v; the state update,
//   but after the step's last chunk.
// The pair scores: a chunk is cut into G = 256 / K sub-blocks. Within a
// sub-block a pair's decay is exp(min(cum_prev_t - cum_s, 0)) per channel on
// the CUDA cores, as the reference forms it; across sub-blocks it is factored
// at the end e of s's sub-block, exp(cum_prev_t - cum_e) exp(cum_e - cum_s),
// both exponents <= 0, so those scores are products (r exp(cum_prev - cum_e))
// . (k exp(cum_e - cum)) on the tensor cores, one sub-block a warp.
// Products on the tensor cores (mma.sync m16n8k16, bf16 -> fp32): every fp32
// operand is split into bf16 hi and lo parts and the products hi hi, hi lo
// and lo hi summed (2^-16 of each product's size); bf16 r, k, v go in exact.
// The B operand of y = (r exp(cum_prev)) S is made from the accumulators in
// registers (split, then transposed by movmatrix). The key head dim K (16,
// 32 or 64) and the chunk (16 or 32) are template arguments; V, a multiple of
// 8 up to 128, is not.
// The decays are kept in base 2 (log2f, exp2f: 2^x is one hardware
// instruction), the same function as the reference's natural exponent.
//
// Bound. Per (b, head, chunk): 3 K flops for each of the c(c-1)/2 strict
// pairs and the c diagonal terms (the decays, fp32 on the CUDA cores: 0.27
// GFLOP at rwkv6-3b's prefill shape, 4 us at 67 TFLOP/s), 2 V for each of
// their products with v, 2 c K V for y from the state and 2 c K V for the
// state update (tensor cores: 2.9 GFLOP counted once, 3 us at 989 TFLOP/s),
// against 149 MB read and written (r, k, v bf16, w and y fp32), 45 us at
// 3.35 TB/s: bound by bytes. The split adds traffic: dS written by pass 1,
// read and overwritten by pass 2 and read by pass 3 (4 x 42 MB), and k, v
// and w read by both pass 1 and pass 3, about 2.7x the bytes the function
// needs; no fp32 copy of r or k is stored and y is written once. The state
// update runs in both pass 1 (once a step) and pass 3 (once a chunk but the
// last), and the hi/lo split triples the tensor-core products.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStep = 64;        // positions a step of the carried state covers
constexpr int kMaxV = 128;
constexpr int kSegs = 8;         // pass 2: warps a block, each a segment of steps
constexpr int kSegLen = 4;       // steps a segment, loaded at once

// Four consecutive elements of T in one load: 16 bytes of fp32, 8 of bf16.
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
  __device__ static float4 to_float4(float4 v) { return v; }
};
template <>
struct Vec4<__nv_bfloat16> {
  using type = uint2;
  __device__ static float4 to_float4(uint2 v) {   // element 0 in the low half of v.x
    return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

struct Log2Floor {   // the reference's floor of w at 1e-38, in base 2
  __device__ float operator()(float x) const { return log2f(fmaxf(x, 1e-38f)); }
};

// Pair p of the c (c + 1) / 2 pairs s <= t, row by row: p = t (t + 1) / 2 + s.
__device__ __forceinline__ void pair_of(int p, int& t, int& s) {
  t = static_cast<int>((sqrtf(8.f * p + 1.f) - 1.f) * 0.5f);
  while (t * (t + 1) / 2 > p) --t;
  while ((t + 1) * (t + 2) / 2 <= p) ++t;
  s = p - t * (t + 1) / 2;
}

// Pass 2: 32 float4s of the (b, head) states, one a lane, for every step.
// Within a row of the state (one channel) the decay is one scalar a step.
__global__ void __launch_bounds__(kSegs * 32) wkv6_state_kernel(
    float* __restrict__ dS, const float* __restrict__ a_step, const float* __restrict__ state,
    float* __restrict__ state_out, long long BH, int K, int V, int nsteps) {
  __shared__ float4 end_s[kSegs][32];   // each segment's state from a zero start
  __shared__ float4 g_s[kSegs][32];     // and its decay (one value, kept as a float4's x)
  __shared__ float4 carry_s[32];        // the state entering this round of segments
  const int KV4 = K * V / 4;
  const int lane = threadIdx.x % 32, seg = threadIdx.x / 32;
  const long long q = static_cast<long long>(blockIdx.x) * 32 + lane;
  const bool live = q < BH * KV4;
  const long long bh = live ? q / KV4 : 0;
  const int e = live ? static_cast<int>(q % KV4) : 0;
  const int row = 4 * e / V;
  float4* d = reinterpret_cast<float4*>(dS) + bh * nsteps * KV4 + e;
  const float* al = a_step + bh * nsteps * K + row;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (seg == 0) carry_s[lane] = live ? reinterpret_cast<const float4*>(state)[q] : zero;
  for (int r0 = 0; r0 < nsteps; r0 += kSegs * kSegLen) {
    const int c0 = r0 + seg * kSegLen;
    float4 dv[kSegLen];
    float av[kSegLen];
#pragma unroll
    for (int j = 0; j < kSegLen; ++j) {
      const bool in = live && c0 + j < nsteps;
      dv[j] = in ? d[static_cast<long long>(c0 + j) * KV4] : zero;
      av[j] = in ? al[static_cast<long long>(c0 + j) * K] : 1.f;
    }
    // From a zero start: dv[j] becomes the state step c0 + j starts from, av[j]
    // the decay since the segment began.
    float4 lh = zero;
    float g = 1.f;
#pragma unroll
    for (int j = 0; j < kSegLen; ++j) {
      const float4 pre = lh;
      const float a = av[j];
      lh = make_float4(fmaf(a, lh.x, dv[j].x), fmaf(a, lh.y, dv[j].y), fmaf(a, lh.z, dv[j].z),
                       fmaf(a, lh.w, dv[j].w));
      dv[j] = pre;
      av[j] = g;
      g *= a;
    }
    end_s[seg][lane] = lh;
    g_s[seg][lane].x = g;
    __syncthreads();
    float4 in = carry_s[lane];
    for (int k2 = 0; k2 < seg; ++k2) {
      const float gk = g_s[k2][lane].x;
      const float4 ek = end_s[k2][lane];
      in = make_float4(fmaf(gk, in.x, ek.x), fmaf(gk, in.y, ek.y), fmaf(gk, in.z, ek.z),
                       fmaf(gk, in.w, ek.w));
    }
#pragma unroll
    for (int j = 0; j < kSegLen; ++j)
      if (live && c0 + j < nsteps)
        d[static_cast<long long>(c0 + j) * KV4] =
            make_float4(fmaf(av[j], in.x, dv[j].x), fmaf(av[j], in.y, dv[j].y),
                        fmaf(av[j], in.z, dv[j].z), fmaf(av[j], in.w, dv[j].w));
    __syncthreads();   // every segment has read the entering state
    if (seg == kSegs - 1)
      carry_s[lane] = make_float4(fmaf(g, in.x, lh.x), fmaf(g, in.y, lh.y), fmaf(g, in.z, lh.z),
                                  fmaf(g, in.w, lh.w));
    __syncthreads();
  }
  if (seg == 0 && live) reinterpret_cast<float4*>(state_out)[q] = carry_s[lane];
}

// mma.sync m16n8k16, bf16 x bf16 -> fp32: d += a b. Fragments (g = lane / 4,
// q = lane % 4): a holds A[g][2q, 2q+1], A[g+8][2q, 2q+1], A[g][2q+8, 2q+9],
// A[g+8][2q+8, 2q+9]; b holds B[2q, 2q+1][g], B[2q+8, 2q+9][g]; d holds
// D[g][2q], D[g][2q+1], D[g+8][2q], D[g+8][2q+1]. Each register carries two
// bf16 consecutive in k, the lower k in the low half.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x as hi = bf16(x) and lo = bf16(x - hi): hi + lo is x to 2^-17 of |x|.
__device__ __forceinline__ void split(float x, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// The A fragment of rows m0 .., columns k0 .. of a bf16 matrix with rows of
// `ld` elements.
__device__ __forceinline__ void load_a(unsigned (&a)[4], const __nv_bfloat16* m, int ld, int m0,
                                       int k0, int g, int q) {
  const __nv_bfloat16* p = m + (m0 + g) * ld + k0 + 2 * q;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// Four channels of a strict pair's score: sum_c r_t,c k_s,c 2^min(cp_t,c - cum_s,c, 0).
__device__ __forceinline__ float pair_sum(float4 r, float4 cp, float4 k, float4 cum) {
  float x = r.x * k.x * exp2f(fminf(cp.x - cum.x, 0.f));
  x = fmaf(r.y * k.y, exp2f(fminf(cp.y - cum.y, 0.f)), x);
  x = fmaf(r.z * k.z, exp2f(fminf(cp.z - cum.z, 0.f)), x);
  return fmaf(r.w * k.w, exp2f(fminf(cp.w - cum.w, 0.f)), x);
}

// Rows of the bf16 operands in shared memory: 8 elements of padding, so that
// the 32-bit fragment reads of a warp fall in distinct banks.
__host__ __device__ constexpr int bf16_ld(int n) { return n + 8; }

__host__ __device__ inline size_t output_smem_bytes(int K, int V, int chunk, bool exact_v) {
  const size_t c = static_cast<size_t>(chunk), kk = static_cast<size_t>(K);
  const size_t vv = static_cast<size_t>(V);
  const size_t subs = static_cast<size_t>(kThreads / K);
  return sizeof(float) * (5 * c * (kk + 4) + 2 * kk)   // r, k, log2 w, cum, cum_prev; u, decay
         + sizeof(__nv_bfloat16) *
               (2 * c * bf16_ld(chunk)                  // scores, hi and lo
                + 2 * (subs + 1) * c * bf16_ld(K)       // r 2^cp, k 2^.., r 2^.. per sub-block
                + 2 * kk * bf16_ld(chunk)               // (k 2^(cum_last - cum))^T
                + (exact_v ? 1 : 2) * c * bf16_ld(V))   // v (and its lo)
         + (exact_v ? 2 : 4) * c * (2 * kk + vv) + sizeof(float) * c * kk;   // staging
}

// The transpose of an 8 x 8 bf16 matrix held as mma/ldmatrix fragments (lane
// l holds row l / 4, columns 2 (l % 4), + 1).
__device__ __forceinline__ unsigned transpose8(unsigned x) {
  unsigned r;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(r) : "r"(x));
  return r;
}

// bf16 pair (x0 in the low half), rounded to nearest.
__device__ __forceinline__ unsigned pack_bf16(float x0, float x1) {
  unsigned r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(x1), "f"(x0));
  return r;
}

// (x0, x1) as bf16 pairs hi = bf16(x) and lo = bf16(x - hi).
__device__ __forceinline__ void split2(float x0, float x1, unsigned& hi, unsigned& lo) {
  hi = pack_bf16(x0, x1);
  lo = pack_bf16(x0 - __uint_as_float(hi << 16), x1 - __uint_as_float(hi & 0xffff0000u));
}

// d += a b with a and b each given as bf16 hi and lo parts: hi hi, hi lo and
// lo hi, each into its own accumulator so that the three chains run side by
// side. (The lo lo product is below 2^-16 of the sum.)
__device__ __forceinline__ void mma3(float (&hh)[4], float (&hl)[4], float (&lh)[4],
                                     const unsigned (&a_hi)[4], const unsigned (&a_lo)[4],
                                     unsigned b0_hi, unsigned b1_hi, unsigned b0_lo,
                                     unsigned b1_lo) {
  mma_bf16(hh, a_hi, b0_hi, b1_hi);
  mma_bf16(hl, a_hi, b0_lo, b1_lo);
  mma_bf16(lh, a_lo, b0_hi, b1_hi);
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

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows [t0, t0 + ROWS) of a (T, row_stride) matrix, W columns (16 bytes a
// multiple of them), into shared rows of ld elements by cp.async; rows at or
// past T are zero-filled.
template <int ROWS, typename T>
__device__ __forceinline__ void copy_rows(T* dst, const T* src, long long row_stride, int t0,
                                          int W, int ld, int T_len, int tid) {
  constexpr int kPer = 16 / sizeof(T);
  const int per_row = W / kPer;
  for (int i = tid; i < ROWS * per_row; i += kThreads) {
    const int row = i / per_row;
    const int t = t0 + row;
    cp_async16(dst + row * ld + (i % per_row) * kPer,
               src + min(t, T_len - 1) * row_stride + (i % per_row) * kPer, t < T_len);
  }
}

// Two 8 x 8 b16 matrices, transposed, from shared-memory rows whose
// addresses lanes 0 .. 7 (the first) and 8 .. 15 (the second) give: the B
// fragment of a row-major (k, n) tile.
__device__ __forceinline__ void ldmatrix_x2_trans(unsigned& b0, unsigned& b1, const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(a)
               : "memory");
}

// B fragments of rows k0 .. k0 + 16, columns j0 .. j0 + 8 of a row-major v
// tile (rows of ld elements), hi and (fp32 v only) lo.
template <bool kExactV>
__device__ __forceinline__ void v_frags(unsigned (&bh)[2], unsigned (&bl)[2],
                                        const __nv_bfloat16* v_hi, const __nv_bfloat16* v_lo,
                                        int ld, int k0, int j0, int lane) {
  const int o = (k0 + lane % 16) * ld + j0;
  ldmatrix_x2_trans(bh[0], bh[1], v_hi + o);
  if (!kExactV) ldmatrix_x2_trans(bl[0], bl[1], v_lo + o);
}

__host__ __device__ inline size_t step_smem_bytes(int K, int V, bool exact_v) {
  const size_t kk = static_cast<size_t>(K), vv = static_cast<size_t>(V);
  const size_t lv = bf16_ld(V);
  const size_t stage = (exact_v ? 2 : 4) * kStep * kk                   // k, as read
                       + sizeof(float) * kStep * kk                     // w
                       + (exact_v ? 2 * kStep * lv : 4 * kStep * vv);   // v, as read
  return sizeof(float) * (kStep * kk + kThreads)                        // cum; segment sums
         + sizeof(__nv_bfloat16) * 2 * kk * bf16_ld(kStep)              // (k 2^(cum_last - cum))^T
         + (exact_v ? 0 : sizeof(__nv_bfloat16) * 2 * kStep * lv)       // fp32 v as hi and lo
         + stage;
}

// Pass 1: step blockIdx.x of (b, head) blockIdx.y. Its k, w and v come by
// cp.async. dS = (k 2^(cum_last - cum))^T v on the tensor cores: the decayed
// k^T split into bf16 hi and lo, v exact in bf16 (or split too, for fp32 v);
// warp w the columns 8 (w + 8 n) ..
template <int K, typename T>
__global__ void __launch_bounds__(kThreads) wkv6_step_kernel(
    const T* __restrict__ k, const T* __restrict__ v, const float* __restrict__ w,
    float* __restrict__ dS, float* __restrict__ a_step, int T_len, int H, int V) {
  constexpr bool kExactV = sizeof(T) == 2;
  constexpr int kSegsA = kThreads / K;          // segments of the per-channel scan
  constexpr int kSegRows = kStep / kSegsA;
  constexpr int ls = bf16_ld(kStep);
  const int lv = bf16_ld(V);
  extern __shared__ float4 smem_a[];
  float* lg_s = reinterpret_cast<float*>(smem_a);  // kStep x K: cum within the segment
  float* tot_s = lg_s + kStep * K;                 // kSegsA x K: each segment's sum
  __nv_bfloat16* kt_hi = reinterpret_cast<__nv_bfloat16*>(tot_s + kThreads);   // K x ls
  __nv_bfloat16* kt_lo = kt_hi + K * ls;
  __nv_bfloat16* vc_hi = kt_lo + K * ls;           // kStep x lv: fp32 v as hi and lo
  __nv_bfloat16* vc_lo = vc_hi + kStep * lv;
  T* ks = reinterpret_cast<T*>(kExactV ? vc_hi : vc_lo + kStep * lv);   // kStep x K: k
  float* ws = reinterpret_cast<float*>(ks + kStep * K);                  // kStep x K: w
  T* vs = reinterpret_cast<T*>(ws + kStep * K);    // kStep x (lv, or V for fp32 v): v

  const int n = blockIdx.x, bh = blockIdx.y;
  const int nsteps = gridDim.x;
  const int b = bh / H, h = bh % H;
  const int t0 = n * kStep;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const long long row_k = static_cast<long long>(H) * K;
  const long long row_v = static_cast<long long>(H) * V;
  const long long base_k = static_cast<long long>(b) * T_len * row_k + static_cast<long long>(h) * K;
  const long long base_v = static_cast<long long>(b) * T_len * row_v + static_cast<long long>(h) * V;
  copy_rows<kStep>(ks, k + base_k, row_k, t0, K, K, T_len, tid);
  copy_rows<kStep>(ws, w + base_k, row_k, t0, K, K, T_len, tid);
  copy_rows<kStep>(vs, v + base_v, row_v, t0, V, kExactV ? lv : V, T_len, tid);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();

  // cum over the step: thread (channel ch, segment sg) sums log2 w over its
  // kSegRows rows (0 past T, as w = 1), then adds the sums of the segments
  // before it; k 2^(cum_last - cum) goes to kt^T as bf16 hi and lo, two
  // positions a store.
  const int ch = tid % K, sg = tid / K;
  float run = 0.f;
  for (int r = sg * kSegRows; r < (sg + 1) * kSegRows; ++r) {
    run += t0 + r < T_len ? Log2Floor()(ws[r * K + ch]) : 0.f;
    lg_s[r * K + ch] = run;
  }
  tot_s[sg * K + ch] = run;
  if constexpr (!kExactV) {   // fp32 v as bf16 hi and lo
    for (int i = tid; i < kStep * V / 4; i += kThreads) {
      const float4 e = reinterpret_cast<const float4*>(vs)[i];
      const int o = (i / (V / 4)) * lv + 4 * (i % (V / 4));
      uint2 hi, lo;
      split2(e.x, e.y, hi.x, lo.x);
      split2(e.z, e.w, hi.y, lo.y);
      *reinterpret_cast<uint2*>(vc_hi + o) = hi;
      *reinterpret_cast<uint2*>(vc_lo + o) = lo;
    }
  }
  __syncthreads();
  float before = 0.f, last = 0.f;
  for (int q2 = 0; q2 < kSegsA; ++q2) {
    const float tq = tot_s[q2 * K + ch];
    if (q2 < sg) before += tq;
    last += tq;
  }
  for (int r = sg * kSegRows; r < (sg + 1) * kSegRows; r += 2) {
    const float x0 = to_float(ks[r * K + ch]) * exp2f(last - (lg_s[r * K + ch] + before));
    const float x1 =
        to_float(ks[(r + 1) * K + ch]) * exp2f(last - (lg_s[(r + 1) * K + ch] + before));
    unsigned hi, lo;
    split2(x0, x1, hi, lo);
    *reinterpret_cast<unsigned*>(kt_hi + ch * ls + r) = hi;
    *reinterpret_cast<unsigned*>(kt_lo + ch * ls + r) = lo;
  }
  if (sg == 0) a_step[(static_cast<long long>(bh) * nsteps + n) * K + ch] = exp2f(last);
  __syncthreads();

  const __nv_bfloat16* v_hi = kExactV ? reinterpret_cast<const __nv_bfloat16*>(vs) : vc_hi;
  float* out = dS + (static_cast<long long>(bh) * nsteps + n) * K * V;
  for (int nt = warp; nt < V / 8; nt += kThreads / 32) {
    const int j0 = 8 * nt;
#pragma unroll
    for (int mt = 0; mt < K / 16; ++mt) {
      float hh[4] = {}, hl[4] = {}, lh[4] = {};
#pragma unroll
      for (int kq = 0; kq < kStep / 16; ++kq) {
        unsigned ah[4], al[4], b_h[2], b_l[2];
        load_a(ah, kt_hi, ls, 16 * mt, 16 * kq, g, q);
        load_a(al, kt_lo, ls, 16 * mt, 16 * kq, g, q);
        v_frags<kExactV>(b_h, b_l, v_hi, vc_lo, lv, 16 * kq, j0, lane);
        mma_bf16(hh, ah, b_h[0], b_h[1]);
        mma_bf16(lh, al, b_h[0], b_h[1]);
        if (!kExactV) mma_bf16(hl, ah, b_l[0], b_l[1]);
      }
      float* o = out + (16 * mt + g) * V + j0 + 2 * q;
      *reinterpret_cast<float2*>(o) = make_float2(hh[0] + hl[0] + lh[0], hh[1] + hl[1] + lh[1]);
      *reinterpret_cast<float2*>(o + 8 * V) =
          make_float2(hh[2] + hl[2] + lh[2], hh[3] + hl[3] + lh[3]);
    }
  }
}

// Pass 3: step blockIdx.x of (b, head) blockIdx.y, its chunks in order from
// the state the step starts from (pass 2's, in place of dS). Warp w owns the
// columns 8 (w + 8 n) .. + 8 of y and of the state (n < NW) and keeps its
// columns of the state in mma accumulators from chunk to chunk; the B operand
// of y = (r 2^cp) S is made from them in registers (split into bf16 hi and
// lo, transposed by movmatrix).
template <int C, int K, int NW, typename T>
__global__ void __launch_bounds__(kThreads, 2) wkv6_output_kernel(
    const T* __restrict__ r, const T* __restrict__ k, const T* __restrict__ v,
    const float* __restrict__ w, const float* __restrict__ u, const float* __restrict__ s_start,
    float* __restrict__ y, int T_len, int H, int V) {
  constexpr bool kExactV = sizeof(T) == 2;   // bf16 v is its own hi part
  constexpr int kp = K + 4;                   // fp32 rows, 16-byte aligned
  constexpr int lc = bf16_ld(C), lk = bf16_ld(K);
  constexpr int MT = C / 16;                  // m tiles of y and of the scores
  constexpr int KT = K / 16;                  // m tiles of the state, k steps of y
  constexpr int G = kThreads / K;             // sub-blocks of a chunk: lanes of a channel's scan
  constexpr int SB = C / G;                   // positions a sub-block
  extern __shared__ float4 smem_c[];
  float* r_s = reinterpret_cast<float*>(smem_c);   // C x kp: r
  float* k_s = r_s + C * kp;                       // C x kp: k
  float* lg_s = k_s + C * kp;                      // C x kp: log2 w
  float* cum_s = lg_s + C * kp;                    // C x kp: its inclusive cumsum
  float* cp_s = cum_s + C * kp;                    // C x kp: cum_prev
  float* u_s = cp_s + C * kp;                      // K
  float* al_s = u_s + K;                           // K: 2^cum_last
  __nv_bfloat16* sc_hi = reinterpret_cast<__nv_bfloat16*>(al_s + K);   // C x lc: scores
  __nv_bfloat16* sc_lo = sc_hi + C * lc;
  __nv_bfloat16* rt_hi = sc_lo + C * lc;           // C x lk: r 2^cum_prev
  __nv_bfloat16* rt_lo = rt_hi + C * lk;
  __nv_bfloat16* kh_hi = rt_lo + C * lk;           // C x lk: k 2^(cum_e - cum), e its sub-block's end
  __nv_bfloat16* kh_lo = kh_hi + C * lk;
  __nv_bfloat16* qh_hi = kh_lo + C * lk;           // (G - 1) x C x lk: r 2^(cum_prev - cum_e), e the
  __nv_bfloat16* qh_lo = qh_hi + (G - 1) * C * lk; // end of sub-block g, rows past it
  __nv_bfloat16* kt_hi = qh_lo + (G - 1) * C * lk; // K x lc: (k 2^(cum_last - cum))^T
  __nv_bfloat16* kt_lo = kt_hi + K * lc;
  const int lv = bf16_ld(V);
  __nv_bfloat16* v_hi = kt_lo + K * lc;            // C x lv: v
  __nv_bfloat16* v_lo = v_hi + C * lv;             // (fp32 v only)
  T* stage_r = reinterpret_cast<T*>(v_lo + (kExactV ? 0 : C * lv));   // C x K, as read
  T* stage_k = stage_r + C * K;
  float* stage_w = reinterpret_cast<float*>(stage_k + C * K);
  T* stage_v = reinterpret_cast<T*>(stage_w + C * K);   // C x V

  const int n = blockIdx.x, bh = blockIdx.y;
  const int nsteps = gridDim.x;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, q = lane % 4;
  const long long row_k = static_cast<long long>(H) * K;
  const long long row_v = static_cast<long long>(H) * V;
  const long long base_k = static_cast<long long>(b) * T_len * row_k + static_cast<long long>(h) * K;
  const long long base_v = static_cast<long long>(b) * T_len * row_v + static_cast<long long>(h) * V;

  for (int i = tid; i < K; i += kThreads) u_s[i] = u[h * K + i];
  for (int i = tid; i < C * lc; i += kThreads) {   // above the diagonal: never written
    sc_hi[i] = __float2bfloat16_rn(0.f);
    sc_lo[i] = __float2bfloat16_rn(0.f);
  }
  // This warp's columns of the state the step starts from, as accumulators:
  // st[n][m] holds S[16 m + g (+ 8)][j + 2 q (+ 1)], j = 8 (warp + 8 n).
  float st[NW][KT][4];
  const float* s0 = s_start + (static_cast<long long>(bh) * nsteps + n) * K * V;
#pragma unroll
  for (int nw = 0; nw < NW; ++nw) {
    const int j = 8 * (warp + 8 * nw) + 2 * q;
#pragma unroll
    for (int mt = 0; mt < KT; ++mt) {
      const bool live = j < V;
      const float2 lo = live ? *reinterpret_cast<const float2*>(s0 + (16 * mt + g) * V + j)
                             : make_float2(0.f, 0.f);
      const float2 hi = live ? *reinterpret_cast<const float2*>(s0 + (16 * mt + g + 8) * V + j)
                             : make_float2(0.f, 0.f);
      st[nw][mt][0] = lo.x;
      st[nw][mt][1] = lo.y;
      st[nw][mt][2] = hi.x;
      st[nw][mt][3] = hi.y;
    }
  }

  // The next chunk's r, k, w and v come by cp.async into staging while this
  // one computes.
  auto fetch = [&](int c0) {
    copy_rows<C>(stage_r, r + base_k, row_k, c0, K, K, T_len, tid);
    copy_rows<C>(stage_k, k + base_k, row_k, c0, K, K, T_len, tid);
    copy_rows<C>(stage_w, w + base_k, row_k, c0, K, K, T_len, tid);
    copy_rows<C>(stage_v, v + base_v, row_v, c0, V, V, T_len, tid);
    cp_async_commit();
  };

  // The staged chunk: r and k in fp32, log2 w (0 past T, as w = 1), v in
  // bf16 (hi and lo for fp32 v).
  auto convert = [&](int c0) {
    using V4T = typename Vec4<T>::type;
    for (int i = tid; i < C * K / 4; i += kThreads) {
      const int t = i / (K / 4), o = t * kp + 4 * (i % (K / 4));
      const float4 ww = reinterpret_cast<const float4*>(stage_w)[i];
      *reinterpret_cast<float4*>(r_s + o) =
          Vec4<T>::to_float4(reinterpret_cast<const V4T*>(stage_r)[i]);
      *reinterpret_cast<float4*>(k_s + o) =
          Vec4<T>::to_float4(reinterpret_cast<const V4T*>(stage_k)[i]);
      *reinterpret_cast<float4*>(lg_s + o) =
          c0 + t < T_len ? make_float4(Log2Floor()(ww.x), Log2Floor()(ww.y), Log2Floor()(ww.z),
                                       Log2Floor()(ww.w))
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int i = tid; i < C * V / 4; i += kThreads) {
      const int o = (i / (V / 4)) * lv + 4 * (i % (V / 4));
      if constexpr (kExactV) {
        *reinterpret_cast<uint2*>(v_hi + o) = reinterpret_cast<const uint2*>(stage_v)[i];
      } else {
        const float4 e = reinterpret_cast<const float4*>(stage_v)[i];
        uint2 hi, lo;
        split2(e.x, e.y, hi.x, lo.x);
        split2(e.z, e.w, hi.y, lo.y);
        *reinterpret_cast<uint2*>(v_hi + o) = hi;
        *reinterpret_cast<uint2*>(v_lo + o) = lo;
      }
    }
  };

  // The scan of log2 w and everything elementwise after it. Thread (channel
  // ch, group grp) holds positions grp * SB .. + SB of its
  // channel; the G groups of a channel are consecutive lanes and exchange
  // their sums by shuffles. A group's positions are a sub-block of the pair
  // scores.
  auto elementwise = [&]() {
    const int grp = tid % G, ch = tid / G;
    float cum[SB];
    float run = 0.f;
#pragma unroll
    for (int i = 0; i < SB; ++i) {
      run += lg_s[(grp * SB + i) * kp + ch];
      cum[i] = run;
    }
    float incl = run;   // inclusive scan of the group sums across the G lanes
#pragma unroll
    for (int o = 1; o < G; o <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, o, G);
      if (grp >= o) incl += up;
    }
    const float before = incl - run;
    const float last_cum = __shfl_sync(0xffffffffu, incl, G - 1, G);
    float ends[G - 1];   // cum at the end of each earlier sub-block
#pragma unroll
    for (int sg = 0; sg < G - 1; ++sg) ends[sg] = __shfl_sync(0xffffffffu, incl, sg, G);
    if (grp == 0) al_s[ch] = exp2f(last_cum);
    // 2^(cp - cum_e) for the end e of an earlier sub-block sg, as
    // 2^(cp - before) 2^(before - cum_e): before is the end of the sub-block
    // just before this one, so both exponents are <= 0. Likewise 2^cp =
    // 2^(cp - before) 2^before and 2^(cum_last - cum) = 2^(cum_e - cum)
    // 2^(cum_last - cum_e), e the end of this sub-block.
    float to_end[G - 1];
#pragma unroll
    for (int sg = 0; sg < G - 1; ++sg) to_end[sg] = exp2f(fminf(before - ends[sg], 0.f));
    const float to_start = exp2f(before), to_last = exp2f(last_cum - incl);
    float ktv[SB];
#pragma unroll
    for (int i = 0; i < SB; ++i) {
      const int t = grp * SB + i;
      const float c = cum[i] + before, cp = c - lg_s[t * kp + ch];
      cum_s[t * kp + ch] = c;
      cp_s[t * kp + ch] = cp;
      const float rq = r_s[t * kp + ch] * exp2f(fminf(cp - before, 0.f));
      const float kh = k_s[t * kp + ch] * exp2f(fminf(incl - c, 0.f));
      split(rq * to_start, rt_hi[t * lk + ch], rt_lo[t * lk + ch]);
      ktv[i] = kh * to_last;
      if (grp < G - 1) split(kh, kh_hi[t * lk + ch], kh_lo[t * lk + ch]);
#pragma unroll
      for (int sg = 0; sg < G - 1; ++sg)
        if (sg < grp)
          split(rq * to_end[sg], qh_hi[(sg * C + t) * lk + ch], qh_lo[(sg * C + t) * lk + ch]);
    }
    if constexpr (SB % 2 == 0) {   // kt^T: two positions a store
#pragma unroll
      for (int i = 0; i < SB; i += 2) {
        unsigned hi, lo;
        split2(ktv[i], ktv[i + 1], hi, lo);
        *reinterpret_cast<unsigned*>(kt_hi + ch * lc + grp * SB + i) = hi;
        *reinterpret_cast<unsigned*>(kt_lo + ch * lc + grp * SB + i) = lo;
      }
    } else {
#pragma unroll
      for (int i = 0; i < SB; ++i)
        split(ktv[i], kt_hi[ch * lc + grp * SB + i], kt_lo[ch * lc + grp * SB + i]);
    }
  };

  // The scores. Across sub-blocks, factored at the end e of s's
  // sub-block (both exponents <= 0): scores[t][s] = (r_t 2^(cp_t - cum_e)) .
  // (k_s 2^(cum_e - cum_s)), on the tensor cores, one sub-block of s a warp.
  // Within a sub-block, sum_c r k 2^min(cp_t - cum_s, 0), and the u term on
  // the diagonal, on the warps the factored scores leave free: four lanes a
  // pair, K / 4 channels a lane; the pairs within sub-blocks first, so that a
  // warp takes one kind.
  auto scores = [&]() {
    for (int sg = warp; sg < G - 1; sg += kThreads / 32) {
      const int row_b = min(sg * SB + g, C - 1);   // columns past the sub-block are dropped
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (16 * mt + 15 < (sg + 1) * SB) continue;   // no row past the sub-block
        float hh[4] = {}, hl[4] = {}, lh[4] = {};
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          unsigned ah[4], al[4];
          load_a(ah, qh_hi + sg * C * lk, lk, 16 * mt, 16 * kt, g, q);
          load_a(al, qh_lo + sg * C * lk, lk, 16 * mt, 16 * kt, g, q);
          const int o = row_b * lk + 16 * kt + 2 * q;
          mma3(hh, hl, lh, ah, al, ld32(kh_hi + o), ld32(kh_hi + o + 8), ld32(kh_lo + o),
               ld32(kh_lo + o + 8));
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = 16 * mt + g + 8 * (e / 2), sp = sg * SB + 2 * q + e % 2;
          if (2 * q + e % 2 < SB && t >= (sg + 1) * SB)
            split(hh[e] + hl[e] + lh[e], sc_hi[t * lc + sp], sc_lo[t * lc + sp]);
        }
      }
    }
    constexpr int kInSub = SB * (SB - 1) / 2;
    constexpr int kItems = 4 * (G * kInSub + C);
    constexpr int KQ = K / 4;
    constexpr int kFirst = G - 1 < kThreads / 32 ? 32 * (G - 1) : 0;
    constexpr int kSpan = kThreads - kFirst;
#pragma unroll 1
    for (int base = 0; base < kItems; base += kSpan) {
      if (tid < kFirst) break;
      const int item = base + tid - kFirst;
      const bool live = item < kItems;
      const int pr = item / 4;
      const int c0q = KQ * (item % 4);
      int t = min(pr - G * kInSub, C - 1), sp = t;   // the diagonal ..
      if constexpr (kInSub > 0) {
        if (pr < G * kInSub) {   // .. after the pairs within sub-blocks
          int tt, ss;
          pair_of(pr % kInSub, tt, ss);
          t = (pr / kInSub) * SB + tt + 1;
          sp = (pr / kInSub) * SB + ss;
        }
      }
      float x = 0.f;
      if (live && sp < t) {
#pragma unroll
        for (int c = 0; c < KQ; c += 4)
          x += pair_sum(*reinterpret_cast<const float4*>(r_s + t * kp + c0q + c),
                        *reinterpret_cast<const float4*>(cp_s + t * kp + c0q + c),
                        *reinterpret_cast<const float4*>(k_s + sp * kp + c0q + c),
                        *reinterpret_cast<const float4*>(cum_s + sp * kp + c0q + c));
      } else if (live) {
#pragma unroll
        for (int c = 0; c < KQ; c += 4) {
          const float4 rr = *reinterpret_cast<const float4*>(r_s + t * kp + c0q + c);
          const float4 kk = *reinterpret_cast<const float4*>(k_s + t * kp + c0q + c);
          const float4 uu = *reinterpret_cast<const float4*>(u_s + c0q + c);
          x = fmaf(rr.x * uu.x, kk.x, x);
          x = fmaf(rr.y * uu.y, kk.y, x);
          x = fmaf(rr.z * uu.z, kk.z, x);
          x = fmaf(rr.w * uu.w, kk.w, x);
        }
      }
      x += __shfl_xor_sync(0xffffffffu, x, 1);
      x += __shfl_xor_sync(0xffffffffu, x, 2);
      if (live && item % 4 == 0) split(x, sc_hi[t * lc + sp], sc_lo[t * lc + sp]);
    }
  };

  // y of the chunk at c0, then (but after a step's last chunk) the state
  // update, in the accumulators.
  auto products = [&](int c0, bool last) {
#pragma unroll
    for (int nw = 0; nw < NW; ++nw) {
      const int j0 = 8 * (warp + 8 * nw);
      if (j0 >= V) continue;
      // y = (r 2^cp) S + scores v: rows 16 mt .., columns j0 ..
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float hh[4] = {}, hl[4] = {}, lh[4] = {};
#pragma unroll
        for (int kt = 0; kt < KT; ++kt) {
          // The B operand from this warp's accumulators: rows 16 kt .. + 8 and
          // + 8 .. + 16 of S at columns j0 .., as hi and lo, transposed into
          // the fragments' (k, n) order.
          unsigned h0, l0, h1, l1, ah[4], al[4];
          split2(st[nw][kt][0], st[nw][kt][1], h0, l0);
          split2(st[nw][kt][2], st[nw][kt][3], h1, l1);
          load_a(ah, rt_hi, lk, 16 * mt, 16 * kt, g, q);
          load_a(al, rt_lo, lk, 16 * mt, 16 * kt, g, q);
          mma3(hh, hl, lh, ah, al, transpose8(h0), transpose8(h1), transpose8(l0),
               transpose8(l1));
        }
#pragma unroll
        for (int ks = 0; ks < C / 16; ++ks) {
          unsigned ah[4], al[4], bh[2], bl[2];
          load_a(ah, sc_hi, lc, 16 * mt, 16 * ks, g, q);
          load_a(al, sc_lo, lc, 16 * mt, 16 * ks, g, q);
          v_frags<kExactV>(bh, bl, v_hi, v_lo, lv, 16 * ks, j0, lane);
          mma_bf16(hh, ah, bh[0], bh[1]);
          mma_bf16(lh, al, bh[0], bh[1]);
          if (!kExactV) mma_bf16(hl, ah, bl[0], bl[1]);
        }
        const int t0 = c0 + 16 * mt + g;
        float* yp = y + base_v + j0 + 2 * q;
        if (t0 < T_len)
          *reinterpret_cast<float2*>(yp + t0 * row_v) =
              make_float2(hh[0] + hl[0] + lh[0], hh[1] + hl[1] + lh[1]);
        if (t0 + 8 < T_len)
          *reinterpret_cast<float2*>(yp + (t0 + 8) * row_v) =
              make_float2(hh[2] + hl[2] + lh[2], hh[3] + hl[3] + lh[3]);
      }
      if (last) continue;
      // S <- 2^cum_last S + (k 2^(cum_last - cum))^T v.
#pragma unroll
      for (int mt = 0; mt < KT; ++mt) {
        const float d0 = al_s[16 * mt + g], d1 = al_s[16 * mt + g + 8];
        st[nw][mt][0] *= d0;
        st[nw][mt][1] *= d0;
        st[nw][mt][2] *= d1;
        st[nw][mt][3] *= d1;
#pragma unroll
        for (int ks = 0; ks < C / 16; ++ks) {
          unsigned ah[4], al[4], bh[2], bl[2];
          load_a(ah, kt_hi, lc, 16 * mt, 16 * ks, g, q);
          load_a(al, kt_lo, lc, 16 * mt, 16 * ks, g, q);
          v_frags<kExactV>(bh, bl, v_hi, v_lo, lv, 16 * ks, j0, lane);
          mma_bf16(st[nw][mt], ah, bh[0], bh[1]);
          mma_bf16(st[nw][mt], al, bh[0], bh[1]);
          if (!kExactV) mma_bf16(st[nw][mt], ah, bl[0], bl[1]);
        }
      }
    }
  };

  const int step0 = n * kStep;
  const int step_end = min(T_len, step0 + kStep);
  fetch(step0);
  for (int c0 = step0; c0 < step_end; c0 += C) {
    const bool last = c0 + C >= step_end;   // the state after the step's last chunk is pass 2's
    cp_async_wait_all();
    __syncthreads();   // the chunk is staged; the last chunk's tiles are consumed
    convert(c0);
    __syncthreads();
    if (!last) fetch(c0 + C);
    elementwise();
    __syncthreads();
    scores();
    __syncthreads();
    products(c0, last);
  }
}

template <int C, int K, int NW, typename T>
cudaError_t launch(const void* r, const void* k, const void* v, const void* w, const void* u,
                   const void* state, void* y, void* state_out, void* dS, void* a_step, int B,
                   int T_len, int H, int V, cudaStream_t stream) {
  const size_t bytes1 = step_smem_bytes(K, V, sizeof(T) == 2);
  const size_t bytes3 = output_smem_bytes(K, V, C, sizeof(T) == 2);
  cudaError_t err = cudaFuncSetAttribute(
      wkv6_step_kernel<K, T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes1));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(wkv6_output_kernel<C, K, NW, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes3));
  if (err != cudaSuccess) return err;
  const int nsteps = (T_len + kStep - 1) / kStep;
  const dim3 grid(nsteps, B * H);
  wkv6_step_kernel<K, T><<<grid, kThreads, bytes1, stream>>>(
      static_cast<const T*>(k), static_cast<const T*>(v), static_cast<const float*>(w),
      static_cast<float*>(dS), static_cast<float*>(a_step), T_len, H, V);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long BH = static_cast<long long>(B) * H;
  wkv6_state_kernel<<<static_cast<unsigned>((BH * K * V / 4 + 31) / 32), kSegs * 32, 0, stream>>>(
      static_cast<float*>(dS), static_cast<const float*>(a_step),
      static_cast<const float*>(state), static_cast<float*>(state_out), BH, K, V, nsteps);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_output_kernel<C, K, NW, T><<<grid, kThreads, bytes3, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(w), static_cast<const float*>(u), static_cast<const float*>(dS),
      static_cast<float*>(y), T_len, H, V);
  return cudaGetLastError();
}

// Eight warps own 8-column tiles of V: one each up to V = 64, two up to 128.
template <int C, int K, typename T>
cudaError_t launch_v(const void* r, const void* k, const void* v, const void* w, const void* u,
                     const void* state, void* y, void* state_out, void* dS, void* a_step, int B,
                     int T_len, int H, int V, cudaStream_t s) {
  return V <= 64 ? launch<C, K, 1, T>(r, k, v, w, u, state, y, state_out, dS, a_step, B, T_len,
                                      H, V, s)
                 : launch<C, K, 2, T>(r, k, v, w, u, state, y, state_out, dS, a_step, B, T_len,
                                      H, V, s);
}

// The chunk length and the key head dim are template arguments, so that
// index arithmetic and the channel loops compile to constants.
template <int C, typename T>
cudaError_t launch_k(int K, const void* r, const void* k, const void* v, const void* w,
                     const void* u, const void* state, void* y, void* state_out, void* dS,
                     void* a_step, int B, int T_len, int H, int V, cudaStream_t s) {
  switch (K) {
    case 16:
      return launch_v<C, 16, T>(r, k, v, w, u, state, y, state_out, dS, a_step, B, T_len, H, V, s);
    case 32:
      return launch_v<C, 32, T>(r, k, v, w, u, state, y, state_out, dS, a_step, B, T_len, H, V, s);
    default:
      return launch_v<C, 64, T>(r, k, v, w, u, state, y, state_out, dS, a_step, B, T_len, H, V, s);
  }
}

template <typename T>
cudaError_t launch_chunk(int chunk, int K, const void* r, const void* k, const void* v,
                         const void* w, const void* u, const void* state, void* y,
                         void* state_out, void* dS, void* a_step, int B, int T_len, int H, int V,
                         cudaStream_t s) {
  return chunk == 16 ? launch_k<16, T>(K, r, k, v, w, u, state, y, state_out, dS, a_step, B,
                                       T_len, H, V, s)
                     : launch_k<32, T>(K, r, k, v, w, u, state, y, state_out, dS, a_step, B,
                                       T_len, H, V, s);
}

}  // namespace

// Plain C entry point for ctypes. Launches the three passes on `stream`, does
// not synchronise and allocates nothing. r, k, v, w, state, y, state_out and
// dS start on 16-byte boundaries; dS is fp32 scratch of
// B * H * ceil(T / 64) * K * V and a_step of B * H * ceil(T / 64) * K.
// Returns the launches' CUDA error (0 on success).
extern "C" int rwkv6_wkv_fwd(const void* r, const void* k, const void* v, const void* w,
                             const void* u, const void* state, void* y, void* state_out,
                             void* dS, void* a_step, int B, int T, int H, int K, int V,
                             int chunk, int is_bf16, void* stream) {
  const bool aligned =
      (reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(state) | reinterpret_cast<uintptr_t>(y) |
       reinterpret_cast<uintptr_t>(state_out) | reinterpret_cast<uintptr_t>(dS)) % 16 == 0;
  const bool shape_ok = aligned && B > 0 && T > 0 && H > 0 && B * H <= 65535 &&
                        (K == 16 || K == 32 || K == 64) && V >= 8 && V <= kMaxV && V % 8 == 0 &&
                        (chunk == 16 || chunk == 32);
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any earlier error so the result is this launch's
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_chunk<__nv_bfloat16>(chunk, K, r, k, v, w, u, state, y, state_out, dS,
                                            a_step, B, T, H, V, s)
              : launch_chunk<float>(chunk, K, r, k, v, w, u, state, y, state_out, dS, a_step, B,
                                    T, H, V, s);
  return static_cast<int>(err);
}

extern "C" const char* rwkv6_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
