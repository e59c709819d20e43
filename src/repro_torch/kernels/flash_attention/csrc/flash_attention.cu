// Causal and sliding-window GQA flash-attention forward (prefill) for
// Hopper, sm_90a.
//
// Replaces the TPU kernel `flash_attention` (body `_flash_kernel`) of
// src/repro/kernels/flash_attention/kernel.py, in both of its modes.
//
// What it computes: o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h/G] / sqrt(D))
// . v[b, j, h/G] over keys j <= i (causal) and j < S, and with a window W > 0
// also j > i - W (sliding window, the windowed family's local layers), for
// q (B, S, H, D) and k/v (B, S, KVH, D) read in place, without a transpose.
// Online softmax with a float32 accumulator, running max and running sum;
// scores never reach device memory.
//
// What bounds it on this card: at prefill lengths the work is
// 4 * S^2/2 * H * D operations (4 * S * W * H * D in the window mode)
// against (3 + 1) * S * H * D * 2 bytes, far above the H100's ~295
// operations per byte, so it is bound by operations.  This first kernel runs
// them on the CUDA cores in float32, not on the tensor cores: it is simple
// and right, and its time sits far above the tensor-core bound.  `wgmma`
// tiles fed by TMA are the follow-up.
//
// The simple design: one block of 256 threads per (64-query tile, head,
// request).  Key/value tiles of 64 rows are staged in shared memory (float32,
// rows padded by one float against bank conflicts), scores for the 64x64 tile
// are computed as 4x4 register micro-tiles, then each row's online-softmax
// update runs on four threads and the P.V product on 4x(D/16) register
// accumulators.  Key tiles past the last live query are skipped (fully masked
// under causality), and in the window mode so are the tiles wholly before
// the first query's window (the TPU kernel's tile skip): a query tile then
// reads at most W/64 + 1 key tiles.  The ragged tail (S not a multiple of 64)
// is masked.  Masked scores take the finite basis -1e30 and contribute
// exactly zero.  Two instantiations: D <= 128 keeps 4x8 accumulators a
// thread; D <= 256 (gemma3's head_dim) 4x16, with 214,784 bytes of dynamic
// shared memory at D = 256, one block per SM.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>

namespace {

constexpr int BQ = 64;          // queries per block
constexpr int BK = 64;          // keys per staged tile
constexpr int THREADS = 256;
constexpr int MAX_D = 256;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

size_t smem_bytes(int D) {
  const int ld = D + 1;
  return sizeof(float) * (size_t)(BQ * ld + 2 * BK * ld + BQ * (BK + 1) + 3 * BQ);
}

// MAX_DC: accumulator columns a thread keeps, D / 16 at most
template <typename T, int MAX_DC>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 int S, int H, int KVH, int D, int window, float sm_scale) {
  extern __shared__ float smem[];
  const int ld = D + 1;
  float* qs = smem;                    // [BQ][ld]  query tile, pre-scaled
  float* ks = qs + BQ * ld;            // [BK][ld]
  float* vs = ks + BK * ld;            // [BK][ld]
  float* ps = vs + BK * ld;            // [BQ][BK + 1]  scores, then probabilities
  float* m_s = ps + BQ * (BK + 1);     // [BQ] running max
  float* l_s = m_s + BQ;               // [BQ] running sum
  float* c_s = l_s + BQ;               // [BQ] this tile's rescale factor

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (H / KVH);
  const long q_row = (long)H * D;      // stride between positions of q and o
  const long k_row = (long)KVH * D;    // stride between positions of k and v
  const T* qb = q + (long)b * S * q_row + (long)h * D;
  const T* kb = k + (long)b * S * k_row + (long)kvh * D;
  const T* vb = v + (long)b * S * k_row + (long)kvh * D;
  T* ob = o + (long)b * S * q_row + (long)h * D;
  const int DC = D / 16;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i % D, qi = q0 + r;
    qs[r * ld + d] = qi < S ? to_f(qb[(long)qi * q_row + d]) * sm_scale : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // P.V accumulator: rows ar*4 .. ar*4+3, columns ac + 16*c
  const int ar = tid / 16, ac = tid % 16;
  float acc[4][MAX_DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < MAX_DC; ++c) acc[i][c] = 0.f;

  // keys past the tile's last live query are masked for every row, and with
  // a window so are keys before the first query's window: skip those tiles
  const int k_end = min(q0 + BQ, S);
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    __syncthreads();                   // the previous tile is fully consumed
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i % D, kj = k0 + r;
      const bool in = kj < S;
      ks[r * ld + d] = in ? to_f(kb[(long)kj * k_row + d]) : 0.f;
      vs[r * ld + d] = in ? to_f(vb[(long)kj * k_row + d]) : 0.f;
    }
    __syncthreads();

    {  // scores: rows sr*4 .. +3 against keys sc*4 .. +3
      const int sr = tid / 16, sc = tid % 16;
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = qs[(sr * 4 + i) * ld + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) kv[j] = ks[(sc * 4 + j) * ld + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qi = q0 + sr * 4 + i, kj = k0 + sc * 4 + j;
          const bool ok = kj < S && kj <= qi && (window <= 0 || kj > qi - window);
          ps[(sr * 4 + i) * (BK + 1) + sc * 4 + j] = ok ? s[i][j] : NEG_INF;
        }
    }
    __syncthreads();

    {  // online softmax: four neighbouring lanes per row, 16 keys each
      const int r = tid / 4, part = tid % 4;
      float* row = ps + r * (BK + 1) + part * 16;
      float mx = NEG_INF;
      for (int j = 0; j < 16; ++j) mx = fmaxf(mx, row[j]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int j = 0; j < 16; ++j) {
        const float p = row[j] == NEG_INF ? 0.f : __expf(row[j] - m_new);
        row[j] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float corr = __expf(m_old - m_new);
        c_s[r] = corr;
        l_s[r] = l_s[r] * corr + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = c_s[ar * 4 + i];
#pragma unroll
      for (int c = 0; c < MAX_DC; ++c) acc[i][c] *= corr;
    }
    for (int j = 0; j < BK; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ar * 4 + i) * (BK + 1) + j];
#pragma unroll
      for (int c = 0; c < MAX_DC; ++c) {
        if (c < DC) {
          const float vv = vs[j * ld + ac + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][c] += p[i] * vv;
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ar * 4 + i;
    if (qi >= S) continue;
    const float inv = 1.f / fmaxf(l_s[ar * 4 + i], 1e-30f);
#pragma unroll
    for (int c = 0; c < MAX_DC; ++c)
      if (c < DC) ob[(long)qi * q_row + ac + 16 * c] = from_f<T>(acc[i][c] * inv);
  }
}

template <typename T, int MAX_DC>
int launch_dc(const void* q, const void* k, const void* v, void* o, int B, int S,
              int H, int KVH, int D, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, MAX_DC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, MAX_DC><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, H, KVH, D, window, 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B, int S,
           int H, int KVH, int D, int window, cudaStream_t stream) {
  if (D <= 128) return launch_dc<T, 8>(q, k, v, o, B, S, H, KVH, D, window, stream);
  return launch_dc<T, 16>(q, k, v, o, B, S, H, KVH, D, window, stream);
}

}  // namespace

extern "C" {

// window: 0 causal, > 0 sliding window of that many keys (the query's own
// included).  dtype: 1 float16, 2 bfloat16.  Returns a cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        int B, int S, int H, int KVH, int D, int window, int dtype,
                        void* stream) {
  if (D > MAX_D || D % 16 != 0 || KVH <= 0 || H % KVH != 0 || S <= 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return launch<__half>(q, k, v, o, B, S, H, KVH, D, window, st);
    case 2: return launch<__nv_bfloat16>(q, k, v, o, B, S, H, KVH, D, window, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
