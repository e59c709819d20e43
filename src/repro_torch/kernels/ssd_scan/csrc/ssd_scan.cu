// Mamba-2 chunked SSD (state-space duality) scan, forward, for Hopper, sm_90a.
//
// Replaces the TPU kernel `ssd_scan` (body `_ssd_kernel`) of
// src/repro/kernels/ssd_scan/kernel.py, and also returns the final state,
// which the Pallas kernel leaves in its scratch and the model's `ssd_full`
// hands to decode.
//
// What it computes, for x (b, s, h, p), dt (b, s, h) float32, A (h,) float32
// and B, C (b, s, n) (one group), from a zero state: per chunk of `chunk`
// rows, cum = cumsum(dt * A); the intra-chunk term ((C B^T) . L) (x dt) with
// L[i, j] = exp(cum_i - cum_j) for j <= i and 0 above the diagonal; the
// carried state's term (C state^T) exp(cum); then
// state = state exp(cum_last) + (x w)^T B with w = exp(cum_last - cum) dt.
// y (b, s, h, p) in x's dtype; the final state (b, h, p, n) in float32.  Any
// s: the rows of the ragged last chunk past s are staged as zeros with
// dt = 0, so the state goes through them unchanged (the zero padding of the
// model's `ssd_chunked`), and their y is never written.  exp(cum_i - cum_j)
// is evaluated only where j <= i: above the diagonal it can overflow to inf,
// and inf * 0 is NaN.
//
// What bounds it on this card: at Mamba-2's prefill shape (P = 64, N = 128,
// chunk 64) a chunk does ~3.7 MFLOP per (request, head) against ~25 KB of
// its inputs and outputs, ~150 operations per byte, under the H100's ~295:
// bound by bytes at the tensor-core rate.  This first kernel runs the chunk
// products on the CUDA cores in float32 (the Pallas body accumulates in
// float32 too), so its time sits far above that bound.  Tensor-core tiles
// (`wgmma` on the four chunk products), TMA staging and splitting the chunk
// loop across blocks are the follow-up.
//
// The simple design: one block of 256 threads per (request, head) walks the
// chunks in order, the TPU grid's sequential dimension turned into a loop,
// with the (P, N) float32 state resident in shared memory (32 KiB at
// mamba2's widths).  Each chunk stages x, B and C in shared memory as float32
// (rows padded by one float against bank conflicts; x, B and C are read
// through their batch and row strides, so the slices of one projection need
// no copy), one thread takes the cumulative sum in row order, and the three
// products run on a 16 x 16 thread grid with register micro-tiles whose rows
// and columns are strided by 16.  133,376 bytes of dynamic shared memory at
// chunk 64, P = 64, N = 128: one block per SM.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_CHUNK = 64;
constexpr int MAX_P = 64;
constexpr int MAX_N = 128;
constexpr int RC = MAX_CHUNK / 16;   // micro-tile rows over a chunk
constexpr int RP = MAX_P / 16;       // over the head dim
constexpr int RN = MAX_N / 16;       // over the state dim

__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

size_t smem_bytes(int chunk, int P, int N) {
  return sizeof(float) * ((size_t)chunk * (P + 1) + 2 * (size_t)chunk * (N + 1) +
                          (size_t)chunk * (chunk + 1) + (size_t)P * (N + 1) +
                          4 * (size_t)chunk);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ Bm,
                const T* __restrict__ Cm, T* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int P, int N,
                int chunk, long long sxb, long long sxs, long long sbb,
                long long sbs, long long scb, long long scs) {
  extern __shared__ float smem[];
  const int ldx = P + 1, ldn = N + 1, lda = chunk + 1;
  float* xs = smem;                   // [chunk][ldx]  x rows of the chunk
  float* bs = xs + chunk * ldx;       // [chunk][ldn]  B rows
  float* cs = bs + chunk * ldn;       // [chunk][ldn]  C rows
  float* att = cs + chunk * ldn;      // [chunk][lda]  (C B^T) . L . dt
  float* st = att + chunk * lda;      // [P][ldn]      the carried state
  float* cum = st + P * ldn;          // [chunk] cumsum(dt A)
  float* ecum = cum + chunk;          // [chunk] exp(cum)
  float* w = ecum + chunk;            // [chunk] exp(cum_last - cum) dt
  float* dts = w + chunk;             // [chunk] dt, 0 past s

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const float a = A[h];
  const int rc = chunk / 16, rp = P / 16, rn = N / 16;

  const T* xb = x + b * sxb + (long long)h * P;
  const T* bb = Bm + b * sbb;
  const T* cb = Cm + b * scb;
  const float* dtb = dt + (long long)b * S * H + h;
  T* yb = y + ((long long)b * S * H + h) * P;
  const long long y_row = (long long)H * P;

  for (int e = tid; e < P * ldn; e += THREADS) st[e] = 0.f;

  const int n_chunks = (S + chunk - 1) / chunk;
  for (int ci = 0; ci < n_chunks; ++ci) {
    const int t0 = ci * chunk;
    const int rows = min(chunk, S - t0);

    // 1. stage the chunk; rows past s are zeros with dt = 0
    for (int e = tid; e < chunk * P; e += THREADS) {
      const int j = e / P, pp = e - j * P;
      xs[j * ldx + pp] = j < rows ? to_f(xb[(t0 + j) * sxs + pp]) : 0.f;
    }
    for (int e = tid; e < chunk * N; e += THREADS) {
      const int j = e / N, nn = e - j * N;
      const bool live = j < rows;
      bs[j * ldn + nn] = live ? to_f(bb[(t0 + j) * sbs + nn]) : 0.f;
      cs[j * ldn + nn] = live ? to_f(cb[(t0 + j) * scs + nn]) : 0.f;
    }
    if (tid < chunk) dts[tid] = tid < rows ? dtb[(long long)(t0 + tid) * H] : 0.f;
    __syncthreads();

    // 2. the cumulative sum of dt A in row order, then its exponentials
    if (tid == 0) {
      float c = 0.f;
      for (int j = 0; j < chunk; ++j) {
        c += dts[j] * a;
        cum[j] = c;
      }
    }
    __syncthreads();
    if (tid < chunk) {
      ecum[tid] = expf(cum[tid]);
      w[tid] = expf(cum[chunk - 1] - cum[tid]) * dts[tid];
    }

    // 3. att[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0
    {
      float acc[RC][RC] = {};
      for (int nn = 0; nn < N; ++nn) {
        float cv[RC], bv[RC];
#pragma unroll
        for (int r = 0; r < RC; ++r) {
          cv[r] = r < rc ? cs[(ty + 16 * r) * ldn + nn] : 0.f;
          bv[r] = r < rc ? bs[(tx + 16 * r) * ldn + nn] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < RC; ++r)
#pragma unroll
          for (int q = 0; q < RC; ++q) acc[r][q] += cv[r] * bv[q];
      }
#pragma unroll
      for (int r = 0; r < RC; ++r)
#pragma unroll
        for (int q = 0; q < RC; ++q) {
          const int i = ty + 16 * r, j = tx + 16 * q;
          if (r < rc && q < rc)
            att[i * lda + j] = j <= i ? acc[r][q] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
    }
    __syncthreads();

    // 4. y_i = sum_j att[i][j] x_j + exp(cum_i) (C_i . state^T), the state
    //    as carried into this chunk
    {
      float yi[RC][RP] = {}, ys[RC][RP] = {};
      for (int j = 0; j < chunk; ++j) {
        float av[RC], xv[RP];
#pragma unroll
        for (int r = 0; r < RC; ++r) av[r] = r < rc ? att[(ty + 16 * r) * lda + j] : 0.f;
#pragma unroll
        for (int q = 0; q < RP; ++q) xv[q] = q < rp ? xs[j * ldx + tx + 16 * q] : 0.f;
#pragma unroll
        for (int r = 0; r < RC; ++r)
#pragma unroll
          for (int q = 0; q < RP; ++q) yi[r][q] += av[r] * xv[q];
      }
      for (int nn = 0; nn < N; ++nn) {
        float cv[RC], sv[RP];
#pragma unroll
        for (int r = 0; r < RC; ++r) cv[r] = r < rc ? cs[(ty + 16 * r) * ldn + nn] : 0.f;
#pragma unroll
        for (int q = 0; q < RP; ++q) sv[q] = q < rp ? st[(tx + 16 * q) * ldn + nn] : 0.f;
#pragma unroll
        for (int r = 0; r < RC; ++r)
#pragma unroll
          for (int q = 0; q < RP; ++q) ys[r][q] += cv[r] * sv[q];
      }
#pragma unroll
      for (int r = 0; r < RC; ++r) {
        const int i = ty + 16 * r;
        if (r >= rc || i >= rows) continue;
#pragma unroll
        for (int q = 0; q < RP; ++q)
          if (q < rp)
            yb[(t0 + i) * y_row + tx + 16 * q] = from_f<T>(yi[r][q] + ys[r][q] * ecum[i]);
      }
    }
    __syncthreads();

    // 5. state = state exp(cum_last) + sum_j (x_j w_j)^T B_j
    {
      const float decay = expf(cum[chunk - 1]);
      float acc[RP][RN] = {};
      for (int j = 0; j < chunk; ++j) {
        const float wj = w[j];
        float xv[RP], bv[RN];
#pragma unroll
        for (int r = 0; r < RP; ++r) xv[r] = r < rp ? xs[j * ldx + ty + 16 * r] * wj : 0.f;
#pragma unroll
        for (int q = 0; q < RN; ++q) bv[q] = q < rn ? bs[j * ldn + tx + 16 * q] : 0.f;
#pragma unroll
        for (int r = 0; r < RP; ++r)
#pragma unroll
          for (int q = 0; q < RN; ++q) acc[r][q] += xv[r] * bv[q];
      }
#pragma unroll
      for (int r = 0; r < RP; ++r)
#pragma unroll
        for (int q = 0; q < RN; ++q)
          if (r < rp && q < rn) {
            float* s = st + (ty + 16 * r) * ldn + tx + 16 * q;
            *s = *s * decay + acc[r][q];
          }
    }
    __syncthreads();
  }

  float* so = state_out + ((long long)b * H + h) * P * N;
  for (int e = tid; e < P * N; e += THREADS) {
    const int pp = e / N, nn = e - pp * N;
    so[e] = st[pp * ldn + nn];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, void* y, void* state, int batch, int S, int H, int P,
           int N, int chunk, long long sxb, long long sxs, long long sbb,
           long long sbs, long long scb, long long scs, cudaStream_t stream) {
  const size_t smem = smem_bytes(chunk, P, N);
  cudaError_t err = cudaFuncSetAttribute(ssd_scan_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  ssd_scan_kernel<T><<<batch * H, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<T*>(y), static_cast<float*>(state),
      S, H, P, N, chunk, sxb, sxs, sbb, sbs, scb, scs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x (batch, S, H, P) read through its batch and row strides (sxb, sxs; heads
// P apart, elements adjacent), dt (batch, S, H) float32 and A (H,) float32
// contiguous, B and C (batch, S, N) through their batch and row strides; y
// (batch, S, H, P) and state (batch, H, P, N) float32 contiguous.  chunk,
// P and N multiples of 16 up to 64, 64 and 128.  dtype (of x, B, C and y):
// 1 float16, 2 bfloat16.  Returns a cudaError_t.
int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* state, int batch, int S, int H,
                 int P, int N, int chunk, long long sxb, long long sxs,
                 long long sbb, long long sbs, long long scb, long long scs,
                 int dtype, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || chunk <= 0 || chunk > MAX_CHUNK ||
      chunk % 16 != 0 || P <= 0 || P > MAX_P || P % 16 != 0 || N <= 0 ||
      N > MAX_N || N % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return launch<__half>(x, dt, A, Bm, Cm, y, state, batch, S, H, P, N,
                                  chunk, sxb, sxs, sbb, sbs, scb, scs, st);
    case 2: return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, y, state, batch, S, H,
                                         P, N, chunk, sxb, sxs, sbb, sbs, scb,
                                         scs, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
