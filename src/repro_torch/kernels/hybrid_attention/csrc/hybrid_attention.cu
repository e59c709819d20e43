// Hybrid paged decode attention with KV-Gen fused in, for Hopper, sm_90a.
//
// Replaces the TPU kernel `hybrid_paged_attention` (body `_hybrid_attn_kernel`)
// of src/repro/kernels/hybrid_attention/kernel.py: its floating-point path and
// its int8 mode.
//
// What it computes: one query token per request (q (B, KVH, G, D), GQA
// grouped) attends over a typed page table (B, MAXP): type 0 is a KV page of
// the pools (P, 16, KVH, D), type 1 an ACT page of the pool (P, 16, d_model)
// whose K/V are recomputed in the kernel (paper Eq. 7: norm, then the head's
// slice of wk/wv, shaped (d_model, KVH, D)), type 2 is empty.  `page_ntok`
// masks each page's tail.  Two deliberate differences from the TPU kernel,
// both to follow the model path that serving runs:
//   (A) LayerNorm applies its bias (the TPU kernel drops it);
//   (B) the normed ACT is rounded to the cache dtype before the projection,
//       and the projected K/V are rounded again before the scores, so a
//       recomputed K/V equals the one prefill stored for that token up to
//       the order of summation.
// rmsnorm scales by (1 + scale).  Masked scores take the finite basis -1e30,
// so a request with no valid token yields zeros, not NaN.
//
// Second-pool mode (`hybrid_paged_attention_two_pool_fwd`, the RoPE models'
// path): a type-1 entry indexes a second pair of pools act_k/act_v
// (P, 16, KVH, D) that already hold the recomputed (and rotated) K/V, written
// by the separate KV-Gen kernel (csrc of kernels/kv_gen), and is staged like
// a KV page: no norm and no projection.  That is the paper's GPU design,
// PagedAttention over two KV buffer types with KV-Gen as its own GEMM; RoPE
// at each ACT token's recorded position cannot be applied inside the fused
// loop's per-column accumulators.  The fused instantiation is unchanged.
//
// return_lse mode (both entry points, the TPU kernel's `return_lse`): given
// non-null m_out/l_out (B, KVH, G, 1) float32, the block also writes each
// query row's final online-softmax state: m the running masked max of the
// sm_scale'd scores (-1e30 when the row attended over no token), l the sum of
// exp(s - m).  The CPU attention lane merges this partial with the host's
// partial over the spilled KV rows.  Every thread of the block holds the same
// (m, l) (each is a reduction over the same shared scores), so thread 0
// writes them; the output and its masking are untouched.
//
// What bounds it on this card: a KV page is bound by bytes (16 rows of K and
// V read once, two operations per element).  An ACT page costs
// 2 * 2 * 16 * d_model * D operations per head against a 16 x d_model page
// and the head's two d_model x D weight slices, i.e. 16 operations per weight
// element: bound by bytes too, and dominated by re-reading the weights.
// Known cost of this simple design: each live ACT page re-reads its head's
// wk/wv slices (1 MB each in f16 at d_model=4096, D=128), once per (request,
// page); the ACT page itself is re-read once per head (from L2).
//
// The simple design: one block of 128 threads per (KV head, request); the
// block walks the request's row of the page table in order (the caller sizes
// the table to the pages in use), with an online softmax kept in registers,
// thread t owning output column t.  The second-pool mode at D <= 256
// (gemma3's head_dim 256, MQA with G = 4) instantiates the same loop with 256
// threads, so each thread still owns one column; its static shared memory is
// 45,888 bytes, under the 48 KB limit.  The 128-thread instantiation, which
// every D <= 128 takes, is unchanged.  A KV
// page is staged in shared memory.  An ACT page is never staged whole (16 x
// 4096 in f16 is 128 KB): a first pass takes each row's mean and variance in
// float32 (one warp per row), then d_model streams through shared memory in
// chunks of 64 columns that are normalised, rounded, and multiplied into 2 x 16
// register accumulators against the matching rows of wk/wv.  Splitting pages
// across blocks (flash-decoding), TMA and `wgmma` are later work.
//
// int8 mode (both entry points, the TPU kernel's `k_scales`/`v_scales`/
// `act_scales`): given non-null scale pointers, the KV pools hold int8 codes
// with float16 scales (P, 16, KVH, 1), one per (token, head), and in the fused
// entry the ACT pool holds int8 codes with float16 scales (P, 16, 1), one per
// token.  Each value is dequantized on the tile as rnd<T>(code * scale): the
// product in float32, rounded to the cache dtype, which is the value the
// model path's fake quantization stores (the TPU kernel keeps it in float32).
// KV pages dequantize where they are staged into k_s/v_s; ACT rows dequantize
// in both the statistics pass and the chunk pass, so the norm sees the same
// values twice.  The second-pool entry's act_k/act_v pools stay in the cache
// dtype (KV-Gen writes them).  Each K/V element then costs one byte and a
// scale read per 16..128 elements instead of two bytes.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int PAGE = 16;
constexpr int MAX_D = 256;       // the second-pool mode's; the fused mode's is 128
constexpr int MAX_G = 8;
constexpr int CHUNK = 64;        // d_model columns per projection step
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

// round to T and back: the rounding point of the model path
template <typename T> __device__ __forceinline__ float rnd(float x) {
  return to_f(from_f<T>(x));
}

// one stored element as float: a cache-dtype value, or an int8 code times
// its float16 scale, rounded to the cache dtype T (the int8 mode)
template <typename T>
__device__ __forceinline__ float load_el(const T* p, long i, const __half*, long) {
  return to_f(p[i]);
}
template <typename T>
__device__ __forceinline__ float load_el(const int8_t* p, long i, const __half* s,
                                         long si) {
  return rnd<T>(__fmul_rn((float)p[i], __half2float(s[si])));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// P: the payload type of the KV pools and the ACT pool, T or int8_t.
// MD: the block's width, 128 or 256 threads, one output column each (D <= MD)
template <typename T, typename P, bool TWO_POOL, int MD>
__global__ void __launch_bounds__(MD)
hybrid_attn_kernel(const T* __restrict__ q, const P* __restrict__ k_pages,
                   const P* __restrict__ v_pages, const __half* __restrict__ k_scales,
                   const __half* __restrict__ v_scales,
                   const T* __restrict__ act_k_pages,
                   const T* __restrict__ act_v_pages, const P* __restrict__ act_pages,
                   const __half* __restrict__ act_scales,
                   const T* __restrict__ norm_scale, const T* __restrict__ norm_bias,
                   const T* __restrict__ wk, const T* __restrict__ wv,
                   const int* __restrict__ page_table, const int* __restrict__ page_type,
                   const int* __restrict__ page_ntok, T* __restrict__ out,
                   float* __restrict__ m_out, float* __restrict__ l_out,
                   int KVH, int G, int D, int d_model, int maxp,
                   int layernorm, float eps, float sm_scale) {
  constexpr int THREADS = MD, WARPS = MD / 32;
  __shared__ float q_s[MAX_G][MD];
  __shared__ float k_s[PAGE][MD + 1];
  __shared__ float v_s[PAGE][MD + 1];
  __shared__ float s_s[MAX_G][PAGE];
  __shared__ float a_s[PAGE][CHUNK + 1];
  __shared__ float mu_s[PAGE];
  __shared__ float rstd_s[PAGE];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const T* qb = q + ((long)b * KVH + h) * G * D;
  for (int i = tid; i < G * D; i += THREADS) q_s[i / D][i % D] = to_f(qb[i]) * sm_scale;

  float m[MAX_G], l[MAX_G], acc[MAX_G];     // column `tid` of each query row
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = NEG_INF;
    l[g] = 0.f;
    acc[g] = 0.f;
  }

  const int* pt = page_table + (long)b * maxp;
  const int* pty = page_type + (long)b * maxp;
  const int* pn = page_ntok + (long)b * maxp;
  for (int p = 0; p < maxp; ++p) {
    const int ty = pty[p];
    if (ty == 2) continue;
    const long pg = pt[p];
    const int ntok = pn[p];
    __syncthreads();                 // the previous page's tiles are consumed
    if (ty == 0) {
      for (int i = tid; i < PAGE * D; i += THREADS) {
        const int r = i / D, d = i % D;
        const long row = (pg * PAGE + r) * KVH + h;
        k_s[r][d] = load_el<T>(k_pages, row * D + d, k_scales, row);
        v_s[r][d] = load_el<T>(v_pages, row * D + d, v_scales, row);
      }
    } else if (TWO_POOL) {
      for (int i = tid; i < PAGE * D; i += THREADS) {
        const int r = i / D, d = i % D;
        const long off = ((pg * PAGE + r) * KVH + h) * D + d;
        k_s[r][d] = to_f(act_k_pages[off]);
        v_s[r][d] = to_f(act_v_pages[off]);
      }
    } else {
      const P* a = act_pages + pg * PAGE * d_model;
      for (int r = warp; r < PAGE; r += WARPS) {     // row statistics, fp32
        const P* row = a + (long)r * d_model;
        const long sr = pg * PAGE + r;               // the row's scale
        float mu = 0.f;
        if (layernorm) {
          float sum = 0.f;
          for (int d = lane; d < d_model; d += 32)
            sum += load_el<T>(row, d, act_scales, sr);
          mu = warp_sum(sum) / d_model;
        }
        float sq = 0.f;
        for (int d = lane; d < d_model; d += 32) {
          const float x = load_el<T>(row, d, act_scales, sr) - mu;
          sq += x * x;
        }
        sq = warp_sum(sq);
        if (lane == 0) {
          mu_s[r] = mu;
          rstd_s[r] = rsqrtf(sq / d_model + eps);
        }
      }
      float kacc[PAGE], vacc[PAGE];
#pragma unroll
      for (int r = 0; r < PAGE; ++r) {
        kacc[r] = 0.f;
        vacc[r] = 0.f;
      }
      for (int c0 = 0; c0 < d_model; c0 += CHUNK) {
        __syncthreads();             // statistics ready, previous chunk consumed
        for (int i = tid; i < PAGE * CHUNK; i += THREADS) {
          const int r = i / CHUNK, c = i % CHUNK, d = c0 + c;
          float y = 0.f;
          if (d < d_model) {
            const float x = (load_el<T>(a, (long)r * d_model + d, act_scales,
                                        pg * PAGE + r) - mu_s[r]) * rstd_s[r];
            y = layernorm ? x * to_f(norm_scale[d]) + to_f(norm_bias[d])
                          : x * (1.f + to_f(norm_scale[d]));
            y = rnd<T>(y);
          }
          a_s[r][c] = y;
        }
        __syncthreads();
        if (tid < D) {
          const int cmax = min(CHUNK, d_model - c0);
          for (int c = 0; c < cmax; ++c) {
            const long w = ((long)(c0 + c) * KVH + h) * D + tid;
            const float wkv = to_f(wk[w]), wvv = to_f(wv[w]);
#pragma unroll
            for (int r = 0; r < PAGE; ++r) {
              const float av = a_s[r][c];
              kacc[r] += av * wkv;
              vacc[r] += av * wvv;
            }
          }
        }
      }
      if (tid < D) {
#pragma unroll
        for (int r = 0; r < PAGE; ++r) {
          k_s[r][tid] = rnd<T>(kacc[r]);
          v_s[r][tid] = rnd<T>(vacc[r]);
        }
      }
    }
    __syncthreads();

    for (int pr = warp; pr < G * PAGE; pr += WARPS) {   // one score per warp
      const int g = pr / PAGE, r = pr % PAGE;
      float s = 0.f;
      for (int d = lane; d < D; d += 32) s += q_s[g][d] * k_s[r][d];
      s = warp_sum(s);
      if (lane == 0) s_s[g][r] = r < ntok ? s : NEG_INF;
    }
    __syncthreads();

    if (tid < D) {
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g >= G) break;
        float mx = m[g];
        for (int r = 0; r < PAGE; ++r) mx = fmaxf(mx, s_s[g][r]);
        const float corr = __expf(m[g] - mx);
        float sum = 0.f, o = 0.f;
        for (int r = 0; r < ntok; ++r) {
          const float pv = __expf(s_s[g][r] - mx);
          sum += pv;
          o += pv * v_s[r][tid];
        }
        l[g] = l[g] * corr + sum;
        acc[g] = acc[g] * corr + o;
        m[g] = mx;
      }
    }
  }

  if (tid < D) {
    T* ob = out + ((long)b * KVH + h) * G * D;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g >= G) break;
      ob[g * D + tid] = from_f<T>(acc[g] / fmaxf(l[g], 1e-30f));
    }
  }
  if (m_out != nullptr && tid == 0) {
    const long base = ((long)b * KVH + h) * G;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g >= G) break;
      m_out[base + g] = m[g];
      l_out[base + g] = l[g];
    }
  }
}

// the scale pointers: all three null (cache-dtype pools) or set (int8 pools;
// the second-pool entry passes no act_scales)
struct Scales {
  const void* k;
  const void* v;
  const void* act;
};

template <typename T, typename P, bool TWO_POOL, int MD>
int launch_md(const void* q, const void* kp, const void* vp, const void* ap,
              const void* scale, const void* bias, const void* wk, const void* wv,
              const int* pt, const int* pty, const int* pn, void* out, float* m_out,
              float* l_out, int B, int KVH, int G, int D, int d_model, int maxp,
              int layernorm, float eps, cudaStream_t stream, Scales sc,
              const void* akp, const void* avp) {
  const dim3 grid(KVH, B);
  hybrid_attn_kernel<T, P, TWO_POOL, MD><<<grid, MD, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(kp), static_cast<const P*>(vp),
      static_cast<const __half*>(sc.k), static_cast<const __half*>(sc.v),
      static_cast<const T*>(akp), static_cast<const T*>(avp),
      static_cast<const P*>(ap), static_cast<const __half*>(sc.act),
      static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<const T*>(wk),
      static_cast<const T*>(wv), pt, pty, pn, static_cast<T*>(out), m_out, l_out,
      KVH, G, D, d_model, maxp, layernorm, eps, 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

// D <= 128: the 128-thread block; D <= 256 (gemma3's head_dim, second-pool
// mode only): the 256-thread block, 45,888 bytes of static shared memory
template <typename T, typename P, bool TWO_POOL>
int launch_as(const void* q, const void* kp, const void* vp, const void* ap,
              const void* scale, const void* bias, const void* wk, const void* wv,
              const int* pt, const int* pty, const int* pn, void* out, float* m_out,
              float* l_out, int B, int KVH, int G, int D, int d_model, int maxp,
              int layernorm, float eps, cudaStream_t stream, Scales sc,
              const void* akp, const void* avp) {
  if (D <= 128)
    return launch_md<T, P, TWO_POOL, 128>(q, kp, vp, ap, scale, bias, wk, wv, pt, pty,
                                          pn, out, m_out, l_out, B, KVH, G, D, d_model,
                                          maxp, layernorm, eps, stream, sc, akp, avp);
  if constexpr (TWO_POOL)
    return launch_md<T, P, TWO_POOL, 256>(q, kp, vp, ap, scale, bias, wk, wv, pt, pty,
                                          pn, out, m_out, l_out, B, KVH, G, D, d_model,
                                          maxp, layernorm, eps, stream, sc, akp, avp);
  return (int)cudaErrorInvalidValue;
}

template <typename T, bool TWO_POOL = false>
int launch(const void* q, const void* kp, const void* vp, const void* ap,
           const void* scale, const void* bias, const void* wk, const void* wv,
           const int* pt, const int* pty, const int* pn, void* out, float* m_out,
           float* l_out, int B, int KVH, int G, int D, int d_model, int maxp,
           int layernorm, float eps, cudaStream_t stream, Scales sc,
           const void* akp = nullptr, const void* avp = nullptr) {
  if (sc.k != nullptr)
    return launch_as<T, int8_t, TWO_POOL>(q, kp, vp, ap, scale, bias, wk, wv, pt, pty,
                                          pn, out, m_out, l_out, B, KVH, G, D, d_model,
                                          maxp, layernorm, eps, stream, sc, akp, avp);
  return launch_as<T, T, TWO_POOL>(q, kp, vp, ap, scale, bias, wk, wv, pt, pty, pn,
                                   out, m_out, l_out, B, KVH, G, D, d_model, maxp,
                                   layernorm, eps, stream, sc, akp, avp);
}

}  // namespace

extern "C" {

// norm_type: 0 layernorm (bias required), 1 rmsnorm (bias unused).
// dtype: 1 float16, 2 bfloat16.
// m_out, l_out: both null, or both (B, KVH, G, 1) float32 (return_lse mode).
// k_scales, v_scales, act_scales: all null, or all float16 with int8 pools
// (int8 mode).  Returns a cudaError_t.
int hybrid_paged_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                               const void* act_pages, const void* k_scales,
                               const void* v_scales, const void* act_scales,
                               const void* norm_scale,
                               const void* norm_bias, const void* wk, const void* wv,
                               const void* page_table, const void* page_type,
                               const void* page_ntok, void* out, void* m_out,
                               void* l_out, int B, int KVH, int G, int D, int d_model,
                               int maxp, int norm_type, float eps, int dtype,
                               void* stream) {
  const int n_scales = (k_scales != nullptr) + (v_scales != nullptr) +
                       (act_scales != nullptr);
  if (D > 128 || G > MAX_G || G < 1 || (norm_type == 0 && norm_bias == nullptr) ||
      ((m_out == nullptr) != (l_out == nullptr)) || (n_scales != 0 && n_scales != 3))
    return (int)cudaErrorInvalidValue;
  const Scales sc{k_scales, v_scales, act_scales};
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* pty = static_cast<const int*>(page_type);
  const int* pn = static_cast<const int*>(page_ntok);
  const int ln = norm_type == 0;
  switch (dtype) {
    case 1: return launch<__half>(q, k_pages, v_pages, act_pages, norm_scale, norm_bias,
                                  wk, wv, pt, pty, pn, out, mo, lo, B, KVH, G, D,
                                  d_model, maxp, ln, eps, st, sc);
    case 2: return launch<__nv_bfloat16>(q, k_pages, v_pages, act_pages, norm_scale,
                                         norm_bias, wk, wv, pt, pty, pn, out, mo, lo, B,
                                         KVH, G, D, d_model, maxp, ln, eps, st, sc);
  }
  return (int)cudaErrorInvalidValue;
}

// Second-pool mode: type-1 entries index act_k_pages/act_v_pages
// (P_act, 16, KVH, D), K/V recomputed beforehand, in the cache dtype.  dtype,
// m_out, l_out as above; k_scales, v_scales both null or both set (int8 KV
// pools).
int hybrid_paged_attention_two_pool_fwd(const void* q, const void* k_pages,
                                        const void* v_pages, const void* k_scales,
                                        const void* v_scales, const void* act_k_pages,
                                        const void* act_v_pages, const void* page_table,
                                        const void* page_type, const void* page_ntok,
                                        void* out, void* m_out, void* l_out, int B,
                                        int KVH, int G, int D, int maxp, int dtype,
                                        void* stream) {
  if (D > MAX_D || G > MAX_G || G < 1 || ((m_out == nullptr) != (l_out == nullptr)) ||
      ((k_scales == nullptr) != (v_scales == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Scales sc{k_scales, v_scales, nullptr};
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* pty = static_cast<const int*>(page_type);
  const int* pn = static_cast<const int*>(page_ntok);
  switch (dtype) {
    case 1: return launch<__half, true>(q, k_pages, v_pages, nullptr, nullptr, nullptr,
                                        nullptr, nullptr, pt, pty, pn, out, mo, lo, B,
                                        KVH, G, D, 0, maxp, 0, 0.f, st, sc, act_k_pages,
                                        act_v_pages);
    case 2: return launch<__nv_bfloat16, true>(q, k_pages, v_pages, nullptr, nullptr,
                                               nullptr, nullptr, nullptr, pt, pty, pn,
                                               out, mo, lo, B, KVH, G, D, 0, maxp, 0,
                                               0.f, st, sc, act_k_pages, act_v_pages);
  }
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
