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
// Design. One block per (b, head), 256 threads. A loop in the block walks the
// chunks in order, which takes the place of the TPU's sequential chunk grid
// axis; the fp32 state H (P x N, 16 KB at 64 x 64) stays in shared memory from
// the first chunk to the last. Per chunk: load x, B, C, dt into shared memory
// (in fp32); warp 0 scans dt into L; the threads then compute the masked
// c x c scores, y (written straight to global memory), and the state update,
// each output element by one thread from shared memory. Rows of B, C and H are
// padded by one word so that reads down a column fall in distinct banks.
// L is scanned and kept in fp64, and only its differences are rounded to fp32:
// with large dt (hundreds, in zamba2-1.2b with random weights; chip_smoke.py
// prints the largest) |L| grows past 1e4 within a chunk, the fp32 difference
// L_t - L_s of two nearby positions loses most of its digits, and exp() turns
// that into relative errors of ~1e-3 in y and the state. Everything else, the
// exponentials included, is fp32 as in the reference.
//
// Bound. By operations: per (b, head, chunk) c (c + 1) N (scores, over the
// c (c + 1) / 2 causal pairs) + c (c + 1) P (intra-chunk y) + 2 c P N (y from
// the state) + 2 c P N (state update) fp32 flops against about 2 P + 4 bytes
// read and 4 P written per position and head, well above the ridge point at
// P = N = 64. The grid has B * H blocks (128 at B = 2 for zamba2-1.2b, about
// one per SM), each a chain of dependent chunk steps with a few block
// barriers each, so the kernel is latency-bound below
// the fp32 rate. Splitting the chunk loop into a parallel intra-chunk pass and
// a short sequential state pass, and tensor cores for the c x c products, are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = 64;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

__host__ __device__ inline size_t smem_bytes(int P, int N, int chunk) {
  const int ns = N + 1;
  return sizeof(double) * static_cast<size_t>(chunk)   // L
         + sizeof(float) * (static_cast<size_t>(P) * ns          // H
                            + static_cast<size_t>(chunk) * P     // x
                            + 2 * static_cast<size_t>(chunk) * ns  // B, C
                            + static_cast<size_t>(chunk) * (chunk + 1)  // scores
                            + 3 * static_cast<size_t>(chunk));  // dt, exp(L), dt exp(L_last - L)
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_kernel(
    const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const T* __restrict__ Bm, const T* __restrict__ C, const float* __restrict__ D,
    const float* __restrict__ state, float* __restrict__ y, float* __restrict__ state_out,
    int T_len, int H, int P, int N, int chunk) {
  extern __shared__ double smem[];
  const int ns = N + 1;
  const int cs = chunk + 1;
  double* L_s = smem;                                  // chunk
  float* h_s = reinterpret_cast<float*>(L_s + chunk);  // P x ns
  float* x_s = h_s + P * ns;          // chunk x P
  float* b_s = x_s + chunk * P;       // chunk x ns
  float* c_s = b_s + chunk * ns;      // chunk x ns
  float* sc_s = c_s + chunk * ns;     // chunk x cs
  float* dt_s = sc_s + chunk * cs;    // chunk
  float* ai_s = dt_s + chunk;         // exp(L_t)
  float* w_s = ai_s + chunk;          // dt_t * exp(L_last - L_t)

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int tid = threadIdx.x;
  const float a = A[h];
  const float d_skip = D[h];

  const long long pn = static_cast<long long>(P) * N;
  for (int i = tid; i < P * N; i += kThreads) h_s[(i / N) * ns + i % N] = state[bh * pn + i];

  for (int c0 = 0; c0 < T_len; c0 += chunk) {
    __syncthreads();  // the state is stored; the last chunk's tiles are consumed
    for (int i = tid; i < chunk * P; i += kThreads) {
      const int t = c0 + i / P;
      x_s[i] = t < T_len ? to_float(x[((static_cast<long long>(b) * T_len + t) * H + h) * P +
                                      i % P])
                         : 0.f;
    }
    for (int i = tid; i < chunk * N; i += kThreads) {
      const int r = i / N, n = i % N;
      const int t = c0 + r;
      const long long off = (static_cast<long long>(b) * T_len + t) * N + n;
      b_s[r * ns + n] = t < T_len ? to_float(Bm[off]) : 0.f;
      c_s[r * ns + n] = t < T_len ? to_float(C[off]) : 0.f;
    }
    for (int r = tid; r < chunk; r += kThreads) {
      const int t = c0 + r;
      dt_s[r] = t < T_len ? dt[(static_cast<long long>(b) * T_len + t) * H + h] : 0.f;
    }
    __syncthreads();

    if (tid < 32) {  // inclusive scan of dt in fp64, 32 positions at a time
      double carry = 0.0;
      for (int base = 0; base < chunk; base += 32) {
        const int r = base + tid;
        double acc = r < chunk ? static_cast<double>(dt_s[r]) : 0.0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const double up = __shfl_up_sync(0xffffffffu, acc, o);
          if (tid >= o) acc += up;
        }
        acc += carry;
        if (r < chunk) L_s[r] = static_cast<double>(a) * acc;
        carry = __shfl_sync(0xffffffffu, acc, 31);
      }
    }
    __syncthreads();
    const double L_last = L_s[chunk - 1];
    for (int r = tid; r < chunk; r += kThreads) {
      ai_s[r] = expf(static_cast<float>(L_s[r]));
      w_s[r] = dt_s[r] * expf(static_cast<float>(L_last - L_s[r]));
    }
    for (int i = tid; i < chunk * chunk; i += kThreads) {
      const int t = i / chunk, s = i % chunk;
      float score = 0.f;
      if (s <= t) {
        float cb = 0.f;
        for (int n = 0; n < N; ++n) cb = fmaf(c_s[t * ns + n], b_s[s * ns + n], cb);
        score = cb * expf(fminf(static_cast<float>(L_s[t] - L_s[s]), 0.f)) * dt_s[s];
      }
      sc_s[t * cs + s] = score;
    }
    __syncthreads();

    for (int i = tid; i < chunk * P; i += kThreads) {
      const int r = i / P, p = i % P;
      const int t = c0 + r;
      if (t >= T_len) continue;
      float intra = 0.f;
      for (int s = 0; s <= r; ++s) intra = fmaf(sc_s[r * cs + s], x_s[s * P + p], intra);
      float cross = 0.f;
      for (int n = 0; n < N; ++n) cross = fmaf(c_s[r * ns + n], h_s[p * ns + n], cross);
      y[((static_cast<long long>(b) * T_len + t) * H + h) * P + p] =
          intra + ai_s[r] * cross + d_skip * x_s[i];
    }
    __syncthreads();  // y has read the state this chunk started from

    const float a_last = expf(static_cast<float>(L_last));
    for (int i = tid; i < P * N; i += kThreads) {
      const int p = i / N, n = i % N;
      float upd = 0.f;
      for (int s = 0; s < chunk; ++s) upd = fmaf(x_s[s * P + p] * w_s[s], b_s[s * ns + n], upd);
      h_s[p * ns + n] = a_last * h_s[p * ns + n] + upd;
    }
  }
  __syncthreads();
  for (int i = tid; i < P * N; i += kThreads) state_out[bh * pn + i] = h_s[(i / N) * ns + i % N];
}

template <typename T>
cudaError_t launch(const void* x, const void* dt, const void* A, const void* Bm, const void* C,
                   const void* D, const void* state, void* y, void* state_out, int B, int T_len,
                   int H, int P, int N, int chunk, cudaStream_t stream) {
  const size_t bytes = smem_bytes(P, N, chunk);
  const cudaError_t attr = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (attr != cudaSuccess) return attr;
  ssd_kernel<T><<<B * H, kThreads, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt), static_cast<const float*>(A),
      static_cast<const T*>(Bm), static_cast<const T*>(C), static_cast<const float*>(D),
      static_cast<const float*>(state), static_cast<float*>(y), static_cast<float*>(state_out),
      T_len, H, P, N, chunk);
  return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not synchronise
// and allocates nothing; returns the launch's CUDA error (0 on success).
extern "C" int mamba2_ssd_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                              const void* C, const void* D, const void* state, void* y,
                              void* state_out, int B, int T, int H, int P, int N, int chunk,
                              int is_bf16, void* stream) {
  const bool shape_ok = B > 0 && T > 0 && H > 0 && P > 0 && N > 0 && chunk > 0 &&
                        chunk <= kMaxChunk &&
                        smem_bytes(P, N, chunk) <= 232448;
  if (!shape_ok) return static_cast<int>(cudaErrorInvalidValue);
  cudaGetLastError();  // clear any earlier error so the result is this launch's
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch<__nv_bfloat16>(x, dt, A, Bm, C, D, state, y, state_out, B, T, H, P, N,
                                      chunk, s)
              : launch<float>(x, dt, A, Bm, C, D, state, y, state_out, B, T, H, P, N, chunk, s);
  return static_cast<int>(err);
}

extern "C" const char* mamba2_ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
