// Mamba2 SSD chunked scan for Hopper (sm_90a): scalar decay per head, one
// group of B and C shared by every head.
//
// Replaces the TPU kernel repro/kernels/mamba2_ssd/mamba2_ssd.py :: ssd_pallas
// (body _ssd_kernel) and computes the same function at the same public layout:
//   x (B, T, H, P) and Bm, C (B, T, N), all fp32 or all bf16; dt (B, T, H),
//   A, D (H,) and state (B, H, P, N) fp32; y (B, T, H, P) and the final state
//   (B, H, P, N) fp32.
// Within a chunk of c positions, with L_t = A * cumsum(dt) (inclusive):
//   y_t = sum_{s<=t} (C_t . B_s) exp(min(L_t - L_s, 0)) dt_s x_s
//         + exp(L_t) (C_t . H) + D x_t
//   H  <- exp(L_last) H + sum_s (x_s dt_s exp(L_last - L_s)) (x) B_s
// A T that is not a chunk multiple is padded as the reference pads it: x, B, C
// and dt are 0 past T, so the padded positions leave the state unchanged.
//
// Design: the state-passing split of the SSD algorithm, three launches, so
// that everything that does not depend on the carried state runs for every
// (b, chunk, head) at once (8192 chunk-heads at zamba2-1.2b's B 2, T 2048,
// H 64, chunk 32) and the sequential part is a short elementwise recurrence.
//   Pass 1 (ssd_chunk_kernel), one block per (chunk, 4 heads, b): each
//   chunk-head's own state contribution dH_c = (x dt exp(L_last - L))^T B and
//   exp(L_last), into fp32 scratch. The B tile is loaded once for the
//   block's heads, the next head's x and dt while this one computes; the
//   blocks of head 0 also form C B^T of the chunk, which does not depend on
//   the head (B and C are one group), so it is computed once per (b, chunk)
//   and not once per head.
//   Pass 2 (ssd_state_kernel): H_c = exp(L_last,c) H_{c-1} + dH_c for every
//   (b, head) at once, 32 float4s of the state a block. The chunks are cut
//   into segments of 8, one a warp: each warp loads its segment's dH and
//   decays at once and runs the recurrence from a zero state; the state
//   entering each segment is then formed from the segments before it. dH_c is
//   overwritten with H_{c-1}, the state chunk c starts from, and the final
//   state is written.
//   Pass 3 (ssd_output_kernel), one block per (chunk, 4 heads, b): C and C
//   B^T are loaded once for the block's heads, the next head's state by
//   cp.async and its x and dt into registers while this one computes; the
//   masked scores, then y = scores . x + exp(L_t) (C_t . H_{c-1}) + D x,
//   written once.
// Products run on the CUDA cores in fp32 from registers: each thread of pass
// 1 owns a 4 x 4 tile of dH (a 16-byte shared read of x and of B feeds 16
// products; two tiles at N > 64), each thread of pass 3 four columns of
// (c / 8) rows of y, rows t = tg + 8 i, so that a warp reads eight distinct
// rows of C and of the scores and four of x and of the state at once. Rows of
// the B, C, state and score tiles are padded by four words, so that those
// reads fall in distinct banks. L is scanned and differenced in fp64, in
// passes 1 and 3 alike, and only its differences are rounded to fp32: with
// large dt (hundreds, in zamba2-1.2b with random weights; chip_smoke.py
// prints the largest) |L| grows past 1e4 within a chunk, the fp32 difference
// of two nearby positions loses most of its digits, and exp() turns that into
// relative errors of ~1e-3 in y and the state. Every exponent is <= 0.
//
// Widths: P (the head dim) up to 64 and N (the state) up to 128, multiples of
// 4. Each kernel is instantiated for N <= 64 (zamba2-1.2b's 64) and for N <=
// 128 (granite-4.0-h's 128), which sizes the B and C tiles' registers and
// pass 1's tiles a thread; at N 128 and P 64, chunk 32, pass 3 takes 96 KB of
// shared memory a block (two blocks an SM) and pass 2's dH scratch is 32 KB
// a (b, head, chunk): 4.3 GB at granite's 128 heads over 32k tokens.
//
// Bound. By operations, per (b, head, chunk): c (c + 1) P (intra-chunk y over
// the causal pairs) + 2 c P N (y from the state) + 2 c P N (dH), and per
// (b, chunk) c (c + 1) N for C B^T: 4.86 GFLOP at zamba2-1.2b's prefill shape,
// 0.0725 ms at 67 TFLOP/s fp32; the bytes the function needs (x, B, C bf16,
// dt, y fp32, the states) are 107 MB, 0.032 ms at 3.35 TB/s. The split adds
// scratch traffic: dH written by pass 1, read and overwritten with H_{c-1} by
// pass 2 and read by pass 3, 4 x 134 MB at that shape (plus C B^T, 0.5 MB),
// so the passes move about 5x the bytes the function needs. Tensor cores for
// the products (with fp32 operands split into bf16 hi and lo parts), and a
// single pass that hands the state from chunk to chunk through L2, are later
// work.

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads1 = 256;   // pass 1: a thread per 4 x 4 tile of dH (two at N > 64)
constexpr int kThreads3 = 128;   // pass 3: 8 row groups x 16 column groups of y
constexpr int kMaxHeadDim = 64;  // P
constexpr int kMaxState = 128;   // N
constexpr int kHeads = 4;        // heads a block of pass 1 or 3 walks, sharing B, C and C B^T
constexpr int kSegs = 8;         // pass 2: warps a block, each a segment of the chunks
constexpr int kSegLen = 8;       // chunks a segment, loaded at once

// Rows of B, C and the state tiles in shared memory: N + 4 floats, so that
// 16-byte reads of eight consecutive rows fall in distinct banks (N % 8 == 0).
__host__ __device__ inline int padded(int N) { return N + 4; }

__host__ __device__ inline size_t chunk_smem_bytes(int P, int N, int chunk) {
  return sizeof(float) * (static_cast<size_t>(chunk)                     // w
                          + static_cast<size_t>(chunk) * P                // x w
                          + 2 * static_cast<size_t>(chunk) * padded(N));  // B, C
}

__host__ __device__ inline size_t output_smem_bytes(int P, int N, int chunk) {
  return sizeof(double) * 2 * chunk                                        // L, two heads
         + sizeof(float) * (4 * static_cast<size_t>(chunk)                 // dt, two heads; A, D
                            + static_cast<size_t>(chunk) * P               // x
                            + static_cast<size_t>(chunk) * padded(N)       // C
                            + static_cast<size_t>(chunk) * (chunk + 4)     // scores
                            + 2 * static_cast<size_t>(P) * padded(N));     // H_{c-1}, two heads
}

// Four consecutive elements of T in one load: 16 bytes of fp32, 8 of bf16.
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
  __device__ static float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  __device__ static float4 to_float4(float4 v) { return v; }
};
template <>
struct Vec4<__nv_bfloat16> {
  using type = uint2;
  __device__ static uint2 zero() { return make_uint2(0u, 0u); }
  __device__ static float4 to_float4(uint2 v) {   // element 0 in the low half of v.x
    return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                       __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
  }
};

// Rows [c0, c0 + CH) of a (T, row_stride) matrix of T, W <= WMAX columns (a
// multiple of 4), held in registers four elements a load; rows at or past T
// are 0. A block issues the loads of all its tiles before it stores any to
// shared memory, so it waits out one memory latency and not one per tile.
template <typename T, int CH, int NT, int WMAX>
struct RowTile {
  static constexpr int kMax = (CH * (WMAX / 4) + NT - 1) / NT;   // loads a thread, at W = WMAX
  typename Vec4<T>::type v[kMax];

  __device__ void load(const T* src, long long row_stride, int c0, int W, int T_len, int tid) {
    const int W4 = W / 4;
#pragma unroll
    for (int j = 0; j < kMax; ++j) {
      const int i = tid + j * NT;
      const int t = c0 + i / W4;
      v[j] = i < CH * W4 && t < T_len
                 ? *reinterpret_cast<const typename Vec4<T>::type*>(src + t * row_stride +
                                                                   4 * (i % W4))
                 : Vec4<T>::zero();
    }
  }
  // Into shared rows of `ld` floats, as fp32.
  __device__ void store(float* dst, int ld, int W, int tid) const {
    const int W4 = W / 4;
#pragma unroll
    for (int j = 0; j < kMax; ++j) {
      const int i = tid + j * NT;
      if (i < CH * W4)
        *reinterpret_cast<float4*>(dst + (i / W4) * ld + 4 * (i % W4)) = Vec4<T>::to_float4(v[j]);
    }
  }
  // The same, row r scaled by w[r].
  __device__ void store_scaled(float* dst, int ld, int W, const float* w, int tid) const {
    const int W4 = W / 4;
#pragma unroll
    for (int j = 0; j < kMax; ++j) {
      const int i = tid + j * NT;
      if (i < CH * W4) {
        const float wr = w[i / W4];
        float4 f = Vec4<T>::to_float4(v[j]);
        f.x *= wr;
        f.y *= wr;
        f.z *= wr;
        f.w *= wr;
        *reinterpret_cast<float4*>(dst + (i / W4) * ld + 4 * (i % W4)) = f;
      }
    }
  }
};

// Warp 0, lane t holding dt_t: L_t = a * inclusive cumsum of dt, in fp64
// (chunk <= 32; lanes past the chunk hold 0).
__device__ __forceinline__ double scan_L(float dt_lane, int chunk, double a, int lane) {
  double acc = lane < chunk ? static_cast<double>(dt_lane) : 0.0;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double up = __shfl_up_sync(0xffffffffu, acc, o);
    if (lane >= o) acc += up;
  }
  return a * acc;
}

// C B^T of the chunk from the B and C tiles in shared memory: every (t, s),
// masked in pass 3.
template <int CH, int NT>
__device__ __forceinline__ void chunk_cb(float* __restrict__ out, const float* c_s,
                                         const float* b_s, int ns, int N, int tid) {
  for (int i = tid; i < CH * CH; i += NT) {
    const int t = i % CH, s = i / CH;
    const float* ct = c_s + t * ns;
    const float* bs = b_s + s * ns;
    float acc = 0.f;
    for (int k = 0; k < N; k += 4) {
      const float4 cv = *reinterpret_cast<const float4*>(ct + k);
      const float4 bv = *reinterpret_cast<const float4*>(bs + k);
      acc = fmaf(cv.x, bv.x, acc);
      acc = fmaf(cv.y, bv.y, acc);
      acc = fmaf(cv.z, bv.z, acc);
      acc = fmaf(cv.w, bv.w, acc);
    }
    out[t * CH + s] = acc;
  }
}

// Pass 1: chunk blockIdx.x of heads kHeads * blockIdx.y .. of sequence
// blockIdx.z. The B tile is loaded once for the block's heads; the next
// head's x and dt are loaded while this head's dH is computed. N <= NMAX.
template <int CH, typename T, int NMAX>
__global__ void __launch_bounds__(kThreads1) ssd_chunk_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ C, float* __restrict__ dH,
    float* __restrict__ a_last, float* __restrict__ cb, int T_len, int H, int P, int N) {
  extern __shared__ float4 smem1[];
  const int ns = padded(N);
  float* w_s = reinterpret_cast<float*>(smem1);   // CH: dt exp(L_last - L)
  float* x_s = w_s + CH;                          // CH x P: x w
  float* b_s = x_s + CH * P;                      // CH x ns
  float* c_s = b_s + CH * ns;                     // CH x ns (the block of head 0 only)

  const int n = blockIdx.x, b = blockIdx.z;
  const int nc = gridDim.x;
  const int h0 = blockIdx.y * kHeads, h1 = min(H, h0 + kHeads);
  const int c0 = n * CH;
  const int tid = threadIdx.x;
  const long long row_x = static_cast<long long>(H) * P;
  const T* xb = x + static_cast<long long>(b) * T_len * row_x;
  const float* dtb = dt + static_cast<long long>(b) * T_len * H;
  const bool dt_live = tid < CH && c0 + tid < T_len;

  RowTile<T, CH, kThreads1, kMaxHeadDim> xt;
  float dtv;
  auto fetch = [&](int h) {
    dtv = dt_live ? dtb[static_cast<long long>(c0 + tid) * H + h] : 0.f;
    xt.load(xb + h * P, row_x, c0, P, T_len, tid);
  };
  fetch(h0);
  {
    RowTile<T, CH, kThreads1, NMAX> bt, ct;
    bt.load(Bm + static_cast<long long>(b) * T_len * N, N, c0, N, T_len, tid);
    if (h0 == 0) ct.load(C + static_cast<long long>(b) * T_len * N, N, c0, N, T_len, tid);
    bt.store(b_s, ns, N, tid);
    if (h0 == 0) {
      ct.store(c_s, ns, N, tid);
      __syncthreads();
      chunk_cb<CH, kThreads1>(cb + (static_cast<long long>(b) * nc + n) * CH * CH, c_s, b_s, ns,
                              N, tid);
    }
  }

  const int NG = N / 4;
  for (int h = h0; h < h1; ++h) {
    if (tid < 32) {   // warp 0 holds the chunk's dt
      const double L = scan_L(dtv, CH, static_cast<double>(A[h]), tid);
      const double L_last = __shfl_sync(0xffffffffu, L, CH - 1);
      if (tid < CH) w_s[tid] = dtv * expf(static_cast<float>(L_last - L));
      if (tid == 0) a_last[(static_cast<long long>(b) * H + h) * nc + n] =
          expf(static_cast<float>(L_last));
    }
    __syncthreads();   // w is ready; the last head's x w is consumed
    xt.store_scaled(x_s, P, P, w_s, tid);
    __syncthreads();
    if (h + 1 < h1) fetch(h + 1);   // in flight while this head computes

    // dH = (x w)^T B: a 4 x 4 tile a thread (NMAX / 64 of them), rows 4 pg ..,
    // columns 4 ng ..
#pragma unroll
    for (int r = 0; r < NMAX / 64; ++r) {
      const int tile = tid + r * kThreads1;
      const int ng = tile % NG, pg = tile / NG;
      if (pg >= P / 4) break;
      float acc[4][4] = {};
#pragma unroll 4
      for (int s = 0; s < CH; ++s) {
        const float4 bv = *reinterpret_cast<const float4*>(b_s + s * ns + 4 * ng);
        const float4 xv = *reinterpret_cast<const float4*>(x_s + s * P + 4 * pg);
        const float xs[4] = {xv.x, xv.y, xv.z, xv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][0] = fmaf(xs[i], bv.x, acc[i][0]);
          acc[i][1] = fmaf(xs[i], bv.y, acc[i][1]);
          acc[i][2] = fmaf(xs[i], bv.z, acc[i][2]);
          acc[i][3] = fmaf(xs[i], bv.w, acc[i][3]);
        }
      }
      float* out = dH + ((static_cast<long long>(b) * H + h) * nc + n) * P * N + 4 * ng;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(out + (4 * pg + i) * N) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    }
  }
}

// Pass 2: the states of 32 float4s of (b, head) states, one a lane, for every
// chunk. The chunks are cut into segments of kSegLen, one a warp: each warp
// loads its segment's dH and exp(L_last) all at once and runs the recurrence
// from a zero state, keeping the decay since the segment began; then the
// state entering each segment is formed from the ones before it, and each
// chunk's start state is its zero-start state plus the decayed entering
// state. dH[c] is overwritten with the state chunk c starts from.
__global__ void __launch_bounds__(kSegs * 32) ssd_state_kernel(
    float* __restrict__ dH, const float* __restrict__ a_last, const float* __restrict__ state,
    float* __restrict__ state_out, long long BH, int PN4, int nc) {
  __shared__ float4 end_s[kSegs][32];   // each segment's state from a zero start
  __shared__ float g_s[kSegs][32];      // and its decay
  __shared__ float4 carry_s[32];        // the state entering this round of segments
  const int lane = threadIdx.x % 32, seg = threadIdx.x / 32;
  const long long q = static_cast<long long>(blockIdx.x) * 32 + lane;
  const bool live = q < BH * PN4;
  const long long bh = live ? q / PN4 : 0;
  const int e = live ? static_cast<int>(q % PN4) : 0;
  float4* d = reinterpret_cast<float4*>(dH) + bh * nc * PN4 + e;
  const float* al = a_last + bh * nc;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (seg == 0) carry_s[lane] = live ? reinterpret_cast<const float4*>(state)[q] : zero;
  for (int r0 = 0; r0 < nc; r0 += kSegs * kSegLen) {
    const int c0 = r0 + seg * kSegLen;
    float4 dv[kSegLen];
    float av[kSegLen];
#pragma unroll
    for (int j = 0; j < kSegLen; ++j) {
      const bool in = live && c0 + j < nc;
      dv[j] = in ? d[static_cast<long long>(c0 + j) * PN4] : zero;
      av[j] = in ? al[c0 + j] : 1.f;
    }
    // From a zero start: dv[j] becomes the state chunk c0 + j starts from,
    // av[j] the decay since the segment began.
    float4 lh = zero;
    float g = 1.f;
#pragma unroll
    for (int j = 0; j < kSegLen; ++j) {
      const float4 pre = lh;
      const float a = av[j];
      lh.x = fmaf(a, lh.x, dv[j].x);
      lh.y = fmaf(a, lh.y, dv[j].y);
      lh.z = fmaf(a, lh.z, dv[j].z);
      lh.w = fmaf(a, lh.w, dv[j].w);
      dv[j] = pre;
      av[j] = g;
      g *= a;
    }
    end_s[seg][lane] = lh;
    g_s[seg][lane] = g;
    __syncthreads();
    float4 in = carry_s[lane];
    for (int k = 0; k < seg; ++k) {
      const float gk = g_s[k][lane];
      const float4 ek = end_s[k][lane];
      in = make_float4(fmaf(gk, in.x, ek.x), fmaf(gk, in.y, ek.y), fmaf(gk, in.z, ek.z),
                       fmaf(gk, in.w, ek.w));
    }
#pragma unroll
    for (int j = 0; j < kSegLen; ++j)
      if (live && c0 + j < nc)
        d[static_cast<long long>(c0 + j) * PN4] =
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The (P, N) state of one (b, head, chunk) into shared rows of ns floats, by
// cp.async, 16 bytes a copy.
__device__ __forceinline__ void copy_state(float* dst, const float* src, int P, int N, int ns,
                                           int tid) {
  const int N4 = N / 4;
  for (int i = tid; i < P * N4; i += kThreads3)
    cp_async16(dst + (i / N4) * ns + 4 * (i % N4), src + 4 * i);
  cp_async_commit();
}

// Pass 3: chunk blockIdx.x of heads kHeads * blockIdx.y .. of sequence
// blockIdx.z. The C tile and C B^T are loaded once for the block's heads;
// the next head's state comes by cp.async, and its x and dt into registers,
// while this head's y is computed. N <= NMAX.
template <int CH, typename T, int NMAX>
__global__ void __launch_bounds__(kThreads3, 4) ssd_output_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ C, const float* __restrict__ D, const float* __restrict__ h_prev,
    const float* __restrict__ cb, float* __restrict__ y, int T_len, int H, int P, int N) {
  constexpr int TT = CH / 8;                 // rows of y a thread
  constexpr int kPairs = CH * CH / kThreads3;  // (t, s) pairs of the scores a thread
  constexpr int kScoreLd = CH + 4;             // padded rows of the scores
  extern __shared__ double smem3[];
  const int ns = padded(N);
  double* L_s = smem3;                                   // 2 x CH, by head parity
  float* dt_s = reinterpret_cast<float*>(L_s + 2 * CH);  // 2 x CH
  float* ad_s = dt_s + 2 * CH;                           // A and D of the block's heads
  float* x_s = ad_s + 2 * CH;                            // CH x P
  float* c_s = x_s + CH * P;                             // CH x ns
  float* sc_s = c_s + CH * ns;                           // CH x (CH + 4): the masked scores
  float* h_s = sc_s + CH * kScoreLd;                     // 2 x P x ns, by head parity

  const int n = blockIdx.x, b = blockIdx.z;
  const int nc = gridDim.x;
  const int h0 = blockIdx.y * kHeads, h1 = min(H, h0 + kHeads);
  const int c0 = n * CH;
  const int tid = threadIdx.x;
  const long long row_x = static_cast<long long>(H) * P;
  const T* xb = x + static_cast<long long>(b) * T_len * row_x;
  const float* dtb = dt + static_cast<long long>(b) * T_len * H;
  const bool dt_live = tid < CH && c0 + tid < T_len;
  auto state_of = [&](int h) {
    return h_prev + ((static_cast<long long>(b) * H + h) * nc + n) * P * N;
  };

  copy_state(h_s, state_of(h0), P, N, ns, tid);
  if (tid < h1 - h0) {
    ad_s[tid] = A[h0 + tid];
    ad_s[kHeads + tid] = D[h0 + tid];
  }
  RowTile<T, CH, kThreads3, kMaxHeadDim> xt;
  float dtv;
  auto fetch = [&](int h) {
    dtv = dt_live ? dtb[static_cast<long long>(c0 + tid) * H + h] : 0.f;
    xt.load(xb + h * P, row_x, c0, P, T_len, tid);
  };
  fetch(h0);
  float cbv[kPairs];   // this thread's pairs tid + k kThreads3 of C B^T, for every head
  {
    RowTile<T, CH, kThreads3, NMAX> ct;
    ct.load(C + static_cast<long long>(b) * T_len * N, N, c0, N, T_len, tid);
    const float* cbp = cb + (static_cast<long long>(b) * nc + n) * CH * CH;
#pragma unroll
    for (int k = 0; k < kPairs; ++k) cbv[k] = cbp[tid + k * kThreads3];
    ct.store(c_s, ns, N, tid);
  }

  // y rows tg + 8 i (i < TT) at columns 4 pg .. 4 pg + 3: a warp reads
  // eight distinct rows of C and of the scores, and four of x and of the
  // state, at once.
  const int tg = tid % 8, pg = tid / 8;
  const int row_end = tg + 8 * (TT - 1) + 1;   // scores past this thread's last row are 0
  for (int h = h0; h < h1; ++h) {
    const int par = (h - h0) & 1;
    const double* L = L_s + par * CH;
    const float* dts = dt_s + par * CH;
    const float* hs = h_s + par * P * ns;
    if (tid < 32) {   // warp 0 holds the chunk's dt
      const double Lt = scan_L(dtv, CH, static_cast<double>(ad_s[h - h0]), tid);
      if (tid < CH) {
        L_s[par * CH + tid] = Lt;
        dt_s[par * CH + tid] = dtv;
      }
    }
    cp_async_wait_all();
    __syncthreads();   // L and this head's state are in; the last head's x and scores are consumed
    xt.store(x_s, P, P, tid);
#pragma unroll
    for (int k = 0; k < kPairs; ++k) {
      const int i = tid + k * kThreads3;
      const int t = i / CH, s = i % CH;
      sc_s[t * kScoreLd + s] =
          s <= t ? cbv[k] * expf(fminf(static_cast<float>(L[t] - L[s]), 0.f)) * dts[s] : 0.f;
    }
    if (h + 1 < h1) {   // in flight while this head computes
      copy_state(h_s + (par ^ 1) * P * ns, state_of(h + 1), P, N, ns, tid);
      fetch(h + 1);
    }
    __syncthreads();

    if (4 * pg < P) {
      // exp(L_t) (C_t . H): C rows tg + 8 i against state rows 4 pg + j.
      float acc[TT][4] = {};
      for (int k = 0; k < N; k += 4) {
        float4 hv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          hv[j] = *reinterpret_cast<const float4*>(hs + (4 * pg + j) * ns + k);
#pragma unroll
        for (int i = 0; i < TT; ++i) {
          const float4 cv = *reinterpret_cast<const float4*>(c_s + (tg + 8 * i) * ns + k);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(cv.x, hv[j].x, acc[i][j]);
            acc[i][j] = fmaf(cv.y, hv[j].y, acc[i][j]);
            acc[i][j] = fmaf(cv.z, hv[j].z, acc[i][j]);
            acc[i][j] = fmaf(cv.w, hv[j].w, acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < TT; ++i) {
        const float a = expf(static_cast<float>(L[tg + 8 * i]));
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= a;
      }
      // + the masked scores . x, four positions s a step.
      for (int s = 0; s < row_end; s += 4) {
        float4 xv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) xv[q] = *reinterpret_cast<const float4*>(x_s + (s + q) * P + 4 * pg);
#pragma unroll
        for (int i = 0; i < TT; ++i) {
          const float4 sc = *reinterpret_cast<const float4*>(sc_s + (tg + 8 * i) * kScoreLd + s);
          const float scs[4] = {sc.x, sc.y, sc.z, sc.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            acc[i][0] = fmaf(scs[q], xv[q].x, acc[i][0]);
            acc[i][1] = fmaf(scs[q], xv[q].y, acc[i][1]);
            acc[i][2] = fmaf(scs[q], xv[q].z, acc[i][2]);
            acc[i][3] = fmaf(scs[q], xv[q].w, acc[i][3]);
          }
        }
      }
      const float d_skip = ad_s[kHeads + h - h0];
#pragma unroll
      for (int i = 0; i < TT; ++i) {
        const int r = tg + 8 * i;
        if (c0 + r >= T_len) break;
        const float4 xr = *reinterpret_cast<const float4*>(x_s + r * P + 4 * pg);
        *reinterpret_cast<float4*>(y + ((static_cast<long long>(b) * T_len + c0 + r) * H + h) * P +
                                   4 * pg) =
            make_float4(fmaf(d_skip, xr.x, acc[i][0]), fmaf(d_skip, xr.y, acc[i][1]),
                        fmaf(d_skip, xr.z, acc[i][2]), fmaf(d_skip, xr.w, acc[i][3]));
      }
    }
  }
}

template <int CH, typename T, int NMAX>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm, const void* C,
                   const void* D, const void* state, void* y, void* state_out, void* dH,
                   void* a_last, void* cb, int B, int T_len, int H, int P, int N,
                   cudaStream_t stream) {
  const size_t bytes1 = chunk_smem_bytes(P, N, CH);
  const size_t bytes3 = output_smem_bytes(P, N, CH);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_kernel<CH, T, NMAX>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(bytes1));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(ssd_output_kernel<CH, T, NMAX>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes3));
  if (err != cudaSuccess) return err;
  const int nc = (T_len + CH - 1) / CH;
  const dim3 grid(nc, (H + kHeads - 1) / kHeads, B);
  ssd_chunk_kernel<CH, T, NMAX><<<grid, kThreads1, bytes1, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(C), static_cast<float*>(dH),
      static_cast<float*>(a_last), static_cast<float*>(cb), T_len, H, P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long BH = static_cast<long long>(B) * H;
  const int PN4 = P * N / 4;
  ssd_state_kernel<<<static_cast<unsigned>((BH * PN4 + 31) / 32), kSegs * 32, 0, stream>>>(
      static_cast<float*>(dH), static_cast<const float*>(a_last),
      static_cast<const float*>(state), static_cast<float*>(state_out), BH, PN4, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_output_kernel<CH, T, NMAX><<<grid, kThreads3, bytes3, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(C), static_cast<const float*>(D), static_cast<const float*>(dH),
      static_cast<const float*>(cb), static_cast<float*>(y), T_len, H, P, N);
  return cudaGetLastError();
}

template <typename T, int NMAX>
cudaError_t launch_chunk(int chunk, const void* x, const void* dt, const void* A, const void* Bm,
                         const void* C, const void* D, const void* state, void* y,
                         void* state_out, void* dH, void* a_last, void* cb, int B, int T_len,
                         int H, int P, int N, cudaStream_t s) {
  return chunk == 16 ? launch<16, T, NMAX>(x, dt, A, Bm, C, D, state, y, state_out, dH, a_last,
                                           cb, B, T_len, H, P, N, s)
                     : launch<32, T, NMAX>(x, dt, A, Bm, C, D, state, y, state_out, dH, a_last,
                                           cb, B, T_len, H, P, N, s);
}

// The instantiation for the state size: N <= 64 or N <= 128.
template <typename T>
cudaError_t launch_width(int chunk, const void* x, const void* dt, const void* A,
                         const void* Bm, const void* C, const void* D, const void* state,
                         void* y, void* state_out, void* dH, void* a_last, void* cb, int B,
                         int T_len, int H, int P, int N, cudaStream_t s) {
  return N <= 64 ? launch_chunk<T, 64>(chunk, x, dt, A, Bm, C, D, state, y, state_out, dH,
                                       a_last, cb, B, T_len, H, P, N, s)
                 : launch_chunk<T, kMaxState>(chunk, x, dt, A, Bm, C, D, state, y, state_out,
                                              dH, a_last, cb, B, T_len, H, P, N, s);
}

}  // namespace

// Plain C entry point for ctypes. Launches the three passes on `stream`, does
// not synchronise and allocates nothing. x, Bm, C and state start on 16-byte
// boundaries; dH is fp32 scratch of
// B * H * ceil(T / chunk) * P * N (16-byte aligned, as `state` and
// `state_out`), a_last of B * H * ceil(T / chunk) and cb of
// B * ceil(T / chunk) * chunk * chunk. Returns the launches' CUDA error (0 on
// success).
extern "C" int mamba2_ssd_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* C, const void* D, const void* state, void* y,
                              void* state_out, void* dH, void* a_last, void* cb, int B, int T,
                              int H, int P, int N, int chunk, int is_bf16, void* stream) {
  const bool aligned =
      (reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(Bm) |
       reinterpret_cast<uintptr_t>(C) | reinterpret_cast<uintptr_t>(state) |
       reinterpret_cast<uintptr_t>(state_out) | reinterpret_cast<uintptr_t>(dH) |
       reinterpret_cast<uintptr_t>(cb)) % 16 == 0;
  const bool shape_ok = aligned && B > 0 && B <= 65535 && T > 0 && H > 0 && H <= 65535 &&
                        P >= 4 && P <= kMaxHeadDim && P % 4 == 0 && N >= 4 &&
                        N <= kMaxState && N % 4 == 0 && (chunk == 16 || chunk == 32);
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any earlier error so the result is this launch's
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_width<__nv_bfloat16>(chunk, x, dt, A, Bm, C, D, state, y, state_out, dH,
                                            a_last, cb, B, T, H, P, N, s)
              : launch_width<float>(chunk, x, dt, A, Bm, C, D, state, y, state_out, dH, a_last,
                                    cb, B, T, H, P, N, s);
  return static_cast<int>(err);
}

extern "C" const char* mamba2_ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
