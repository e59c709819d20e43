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
// path, and the windowed family's global layers and rings): a type-1 entry
// indexes a second pair of pools act_k/act_v (P, 16, KVH, D) that already
// hold the recomputed (and rotated) K/V, written by the separate KV-Gen
// kernel (csrc of kernels/kv_gen), and is read like a KV page.  That is the
// paper's GPU design, PagedAttention over two KV buffer types with KV-Gen as
// its own GEMM; RoPE at each ACT token's recorded position cannot be applied
// inside the fused loop's per-column accumulators.  It has kernels of its
// own, split across blocks (flash-decoding), described at the end of this
// note.
//
// return_lse mode (both entry points, the TPU kernel's `return_lse`): given
// non-null m_out/l_out (B, KVH, G, 1) float32, the block also writes each
// query row's final online-softmax state: m the running masked max of the
// sm_scale'd scores (-1e30 when the row attended over no token), l the sum of
// exp(s - m).  The CPU attention lane merges this partial with the host's
// partial over the spilled KV rows.  In the fused mode every thread of the
// block holds the same (m, l) (each is a reduction over the same shared
// scores), so thread 0 writes them; in the second-pool mode the combine pass
// writes the merged pair.  The output and its masking are untouched.
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
// The fused mode's simple design: one block of 128 threads per (KV head,
// request); the block walks the request's row of the page table in order
// (the caller sizes the table to the pages in use), with an online softmax
// kept in registers, thread t owning output column t.  A KV page is staged
// in shared memory.  An ACT page is never staged whole (16 x 4096 in f16 is
// 128 KB): a first pass takes each row's mean and variance in float32 (one
// warp per row), then d_model streams through shared memory in chunks of 64
// columns that are normalised, rounded, and multiplied into 2 x 16 register
// accumulators against the matching rows of wk/wv.
//
// int8 mode (both entry points, the TPU kernel's `k_scales`/`v_scales`/
// `act_scales`): given non-null scale pointers, the KV pools hold int8 codes
// with float16 scales (P, 16, KVH, 1), one per (token, head), and in the fused
// entry the ACT pool holds int8 codes with float16 scales (P, 16, 1), one per
// token.  Each value is dequantized on the tile as rnd<T>(code * scale): the
// product in float32, rounded to the cache dtype, which is the value the
// model path's fake quantization stores (the TPU kernel keeps it in float32).
// The fused mode's KV pages dequantize where they are staged into k_s/v_s
// (the second-pool mode's where they are read); ACT rows dequantize
// in both the statistics pass and the chunk pass, so the norm sees the same
// values twice.  The second-pool entry's act_k/act_v pools stay in the cache
// dtype (KV-Gen writes them).  Each K/V element then costs one byte and a
// scale read per 16..128 elements instead of two bytes.
//
// The second-pool mode's design.  Its work is bound by bytes: each valid
// token's K and V row is read once (2 x D x 2 bytes in 16 bits) for
// 4 x G x D operations, far below the card's ~295 operations per byte.  One
// block per (KV head, request), as the fused mode has, is 4 blocks on 132 SMs
// under gemma3's MQA, and a block reading one page after another keeps few
// bytes in flight.  So two kernels run on the current stream:
//   - Split pass, grid (n_split, KVH, B), 128 threads.  Block s takes a
//     contiguous range of `pps` <= 128 entries of its request's table row,
//     read once into shared memory (type 0 reads the KV pools, type 1 the
//     second pools, type 2 is skipped wherever it stands).  It stages each
//     page's 16 K and V rows with 16-byte cp.async into a double buffer
//     (the next live entry loads while this one is scored), scores the
//     G <= 8 query rows against it on the CUDA cores (lane j of a warp
//     takes columns 8j .. 8j + 7 of a token, a warp sum per row), runs the
//     online softmax once per (row, token) with a 16-lane shuffle per row,
//     and writes an unnormalised float32 partial (o, m, l) in the
//     return_lse basis to scratch; a range with no token writes o = 0,
//     m = -1e30, l = 0.  int8 pages dequantize on the tile as
//     rnd<T>(code x scale).
//   - Combine pass, grid (G, KVH, B), 256 threads: the n_split partials merge
//     as merge_partials_torch merges two (kernels/hybrid_attention/ref.py),
//     the output in the cache dtype and, in the return_lse mode, the merged
//     (m, l); a request with no token gets zeros and (-1e30, 0).
// The split plan (n_split, pps) comes from the wrapper, from B, KVH and the
// table width alone (no device read): about two blocks per SM.
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
// MD: the block's width, 128 threads, one output column each (D <= MD)
template <typename T, typename P, int MD>
__global__ void __launch_bounds__(MD)
hybrid_attn_kernel(const T* __restrict__ q, const P* __restrict__ k_pages,
                   const P* __restrict__ v_pages, const __half* __restrict__ k_scales,
                   const __half* __restrict__ v_scales, const P* __restrict__ act_pages,
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

// ----------------------------------------------------------------------------
// Second-pool mode, split across blocks (flash-decoding)

constexpr int SPLIT_THREADS = 128;          // four warps
constexpr int COMBINE_THREADS = MAX_D;      // one output column each
constexpr int MAX_SPLITS = 264;             // the wrappers' plan never exceeds
constexpr int MAX_PPS = 128;                // either bound
constexpr int VEC = 8;                      // elements per lane in the scores

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// one staged page row's element as float: the cache dtype, or (Q8: an int8
// code) times the row's scale, rounded to the cache dtype
template <typename T, bool Q8>
__device__ __forceinline__ float page_el(const uint8_t* row, int d, float scale) {
  if constexpr (Q8) {
    return rnd<T>(__fmul_rn((float)reinterpret_cast<const int8_t*>(row)[d], scale));
  } else {
    return to_f(reinterpret_cast<const T*>(row)[d]);
  }
}

// Split pass.  Block (split, h, b) attends request b's KV head h over table
// entries [split * pps, min((split + 1) * pps, maxp)) and writes the
// unnormalised float32 partial: o (G, D), and (m, l) per query row in the
// return_lse basis (m = -1e30, l = 0, o = 0 for a range with no token).
// P: the KV pools' payload, T or int8_t; the second pools are always T.
template <typename T, typename P>
__global__ void __launch_bounds__(SPLIT_THREADS)
split_attn_kernel(const T* __restrict__ q, const P* __restrict__ k_pages,
                  const P* __restrict__ v_pages, const __half* __restrict__ k_scales,
                  const __half* __restrict__ v_scales, const T* __restrict__ act_k_pages,
                  const T* __restrict__ act_v_pages, const int* __restrict__ page_table,
                  const int* __restrict__ page_type, const int* __restrict__ page_ntok,
                  float* __restrict__ part_o, float* __restrict__ part_ml, int KVH,
                  int G, int D, int maxp, int pps, float sm_scale) {
  constexpr bool Q8 = !std::is_same<P, T>::value;
  constexpr int ROW = MAX_D * sizeof(T);    // staged row bytes, the widest case
  __shared__ __align__(16) uint8_t k_s[2][PAGE][ROW];
  __shared__ __align__(16) uint8_t v_s[2][PAGE][ROW];
  __shared__ float ksc_s[2][PAGE], vsc_s[2][PAGE];
  __shared__ float s_s[MAX_G][PAGE], p_s[MAX_G][PAGE];
  __shared__ float m_s[MAX_G], l_s[MAX_G], corr_s[MAX_G];
  __shared__ int pt_s[MAX_PPS], pty_s[MAX_PPS], pn_s[MAX_PPS];

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  // this block's entries of the table row, read once into shared memory:
  // walking them in device memory put three dependent loads on every page
  const int lo = split * pps, n = max(0, min(pps, maxp - lo));
  for (int i = tid; i < n; i += SPLIT_THREADS) {
    const long e = (long)b * maxp + lo + i;
    pt_s[i] = page_table[e];
    pty_s[i] = page_type[e];
    pn_s[i] = page_ntok[e];
  }
  __syncthreads();

  // lane's slice of every query row, pre-scaled: columns lane*8 .. +7, one
  // 16-byte load per row
  float qv[MAX_G][VEC];
  const T* qb = q + ((long)b * KVH + h) * G * D;
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (g < G && lane * VEC < D)
      raw = *reinterpret_cast<const uint4*>(qb + g * D + lane * VEC);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int j = 0; j < VEC; ++j) qv[g][j] = to_f(e[j]) * sm_scale;
  }
  float acc[MAX_G][2];                        // columns tid and tid + 128
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) acc[g][0] = acc[g][1] = 0.f;
  if (tid < MAX_G) {                          // each row's running max and sum
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.f;
  }

  // stage entry p into buffer `buf`: 16-byte cp.async of its 16 K and V
  // rows (int8 codes or the cache dtype), and an int8 page's scales
  auto stage = [&](int p, int buf) {
    const long pg = pt_s[p];
    const bool kv = pty_s[p] == 0;
    const int row_bytes = D * (kv ? (int)sizeof(P) : (int)sizeof(T));
    const int chunks = row_bytes / 16;
    const uint8_t* kb = kv ? reinterpret_cast<const uint8_t*>(k_pages)
                           : reinterpret_cast<const uint8_t*>(act_k_pages);
    const uint8_t* vb = kv ? reinterpret_cast<const uint8_t*>(v_pages)
                           : reinterpret_cast<const uint8_t*>(act_v_pages);
    for (int i = tid; i < PAGE * chunks; i += SPLIT_THREADS) {
      const int r = i / chunks, c = i % chunks;
      const long off = ((pg * PAGE + r) * KVH + h) * row_bytes + c * 16;
      cp_async16(&k_s[buf][r][c * 16], kb + off);
      cp_async16(&v_s[buf][r][c * 16], vb + off);
    }
    if (Q8 && kv && tid < PAGE) {
      const long row = (pg * PAGE + tid) * KVH + h;
      ksc_s[buf][tid] = __half2float(k_scales[row]);
      vsc_s[buf][tid] = __half2float(v_scales[row]);
    }
  };
  auto next_live = [&](int p) {
    while (p < n && pty_s[p] == 2) ++p;
    return p;
  };

  int cur = next_live(0), buf = 0;
  if (cur < n) stage(cur, 0);
  cp_async_commit();
  while (cur < n) {
    const int nxt = next_live(cur + 1);
    if (nxt < n) stage(nxt, buf ^ 1);
    cp_async_commit();
    cp_async_wait_one();              // the current entry's copies have landed
    __syncthreads();
    const int ntok = pn_s[cur];
    const bool q8 = Q8 && pty_s[cur] == 0;

    // scores: warp w takes tokens w, w + 4, ..; lane its 8 columns (one
    // 16- or 8-byte shared load).  The rows' warp sums interleave
    for (int r = warp; r < PAGE; r += SPLIT_THREADS / 32) {
      float part[MAX_G];
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) part[g] = 0.f;
      if (lane * VEC < D) {
        float kf[VEC];
        if (q8) {
          const uint2 raw = *reinterpret_cast<const uint2*>(k_s[buf][r] + lane * VEC);
          const float ks = ksc_s[buf][r];
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            kf[j] = rnd<T>(__fmul_rn((float)reinterpret_cast<const int8_t*>(&raw)[j], ks));
        } else {
          const uint4 raw =
              *reinterpret_cast<const uint4*>(k_s[buf][r] + lane * VEC * sizeof(T));
#pragma unroll
          for (int j = 0; j < VEC; ++j) kf[j] = to_f(reinterpret_cast<const T*>(&raw)[j]);
        }
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G)
#pragma unroll
            for (int j = 0; j < VEC; ++j) part[g] += qv[g][j] * kf[j];
      }
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) part[g] = warp_sum(part[g]);
      if (lane < G) {
        float sc = part[0];
#pragma unroll
        for (int g = 1; g < MAX_G; ++g) if (lane == g) sc = part[g];
        s_s[lane][r] = r < ntok ? sc : NEG_INF;
      }
    }
    __syncthreads();

    // online softmax, once per (row, token): thread t takes row t / 16's
    // token t % 16, a 16-lane shuffle gives the row's max and sum
    {
      const int g = tid / PAGE, r = tid % PAGE;
      const float sc = g < G ? s_s[g][r] : NEG_INF;
      const float m_old = g < G ? m_s[g] : NEG_INF;
      float mx = fmaxf(m_old, sc);
#pragma unroll
      for (int o = PAGE / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float pv = r < ntok ? __expf(sc - mx) : 0.f;
      float sum = pv;
#pragma unroll
      for (int o = PAGE / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (g < G) {
        p_s[g][r] = pv;
        if (r == 0) {
          const float corr = __expf(m_old - mx);
          corr_s[g] = corr;
          l_s[g] = l_s[g] * corr + sum;
          m_s[g] = mx;
        }
      }
    }
    __syncthreads();

    // P.V: thread t owns columns t and t + 128; each V element read once
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      acc[g][0] *= g < G ? corr_s[g] : 1.f;
      acc[g][1] *= g < G ? corr_s[g] : 1.f;
    }
    for (int r = 0; r < ntok; ++r) {
      const float vs = q8 ? vsc_s[buf][r] : 1.f;
      float v0 = 0.f, v1 = 0.f;
      if (tid < D)
        v0 = q8 ? page_el<T, true>(v_s[buf][r], tid, vs)
                : page_el<T, false>(v_s[buf][r], tid, 1.f);
      if (tid + SPLIT_THREADS < D)
        v1 = q8 ? page_el<T, true>(v_s[buf][r], tid + SPLIT_THREADS, vs)
                : page_el<T, false>(v_s[buf][r], tid + SPLIT_THREADS, 1.f);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          const float pv = p_s[g][r];
          acc[g][0] += pv * v0;
          acc[g][1] += pv * v1;
        }
      }
    }
    __syncthreads();                  // buffer `buf` is free for the next stage
    cur = nxt;
    buf ^= 1;
  }
  __syncthreads();                    // m_s/l_s as set, even with no live entry

  const long part = ((long)b * KVH + h) * gridDim.x + split;
  float* po = part_o + part * G * D;
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g >= G) break;
    if (tid < D) po[g * D + tid] = acc[g][0];
    if (tid + SPLIT_THREADS < D) po[g * D + tid + SPLIT_THREADS] = acc[g][1];
  }
  if (tid == 0) {
    float* pml = part_ml + part * G * 2;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g >= G) break;
      pml[2 * g] = m_s[g];
      pml[2 * g + 1] = l_s[g];
    }
  }
}

// Combine pass.  Block (g, h, b) merges query row g's n_split partials of
// request b's KV head h as merge_partials_torch merges two: M = max m_s,
// L = sum l_s exp(m_s - M), o = sum exp(m_s - M) o_s / L, written in the
// cache dtype; with m_out, also (M, L).  A request with no token gets zeros
// and (-1e30, 0).  A block per query row, not per (KV head, request): a
// thread then sums one column over n_split partials with its loads in
// flight together, not G x n_split loads one after another.
template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
split_combine_kernel(const float* __restrict__ part_o,
                     const float* __restrict__ part_ml, T* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ l_out, int KVH,
                     int G, int D, int n_split) {
  __shared__ float w_s[MAX_SPLITS];
  __shared__ float inv_s;
  const int tid = threadIdx.x, lane = tid % 32;
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const long base = (long)b * KVH + h;
  const float* pml = part_ml + base * n_split * G * 2;

  if (tid < 32) {                      // the first warp: the split weights
    float mx = NEG_INF;
    for (int s = lane; s < n_split; s += 32) mx = fmaxf(mx, pml[(s * G + g) * 2]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    float tot = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      const float w = __expf(pml[(s * G + g) * 2] - mx);
      w_s[s] = w;
      tot += pml[(s * G + g) * 2 + 1] * w;
    }
    tot = warp_sum(tot);
    if (lane == 0) {
      inv_s = 1.f / fmaxf(tot, 1e-30f);
      if (m_out != nullptr) {
        m_out[base * G + g] = mx;
        l_out[base * G + g] = tot;
      }
    }
  }
  __syncthreads();
  if (tid >= D) return;
  const float* po = part_o + (base * n_split * G + g) * D + tid;
  float o = 0.f;
#pragma unroll 8
  for (int s = 0; s < n_split; ++s) o += w_s[s] * po[(long)s * G * D];
  out[(base * G + g) * D + tid] = from_f<T>(o * inv_s);
}

template <typename T, typename P>
int launch_split(const void* q, const void* kp, const void* vp, const void* ks,
                 const void* vs, const void* akp, const void* avp, const int* pt,
                 const int* pty, const int* pn, void* out, float* m_out, float* l_out,
                 float* scratch, int B, int KVH, int G, int D, int maxp, int n_split,
                 int pps, cudaStream_t stream) {
  float* part_o = scratch;
  float* part_ml = scratch + (long)B * KVH * n_split * G * D;
  split_attn_kernel<T, P><<<dim3(n_split, KVH, B), SPLIT_THREADS, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(kp), static_cast<const P*>(vp),
      static_cast<const __half*>(ks), static_cast<const __half*>(vs),
      static_cast<const T*>(akp), static_cast<const T*>(avp), pt, pty, pn, part_o,
      part_ml, KVH, G, D, maxp, pps, 1.f / sqrtf((float)D));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  split_combine_kernel<T><<<dim3(G, KVH, B), COMBINE_THREADS, 0, stream>>>(
      part_o, part_ml, static_cast<T*>(out), m_out, l_out, KVH, G, D, n_split);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------------------
// Fused mode: host side

// the scale pointers: all three null (cache-dtype pools) or set (int8 pools)
struct Scales {
  const void* k;
  const void* v;
  const void* act;
};

template <typename T, typename P>
int launch_fused(const void* q, const void* kp, const void* vp, const void* ap,
                 const void* scale, const void* bias, const void* wk, const void* wv,
                 const int* pt, const int* pty, const int* pn, void* out, float* m_out,
                 float* l_out, int B, int KVH, int G, int D, int d_model, int maxp,
                 int layernorm, float eps, cudaStream_t stream, Scales sc) {
  const dim3 grid(KVH, B);
  hybrid_attn_kernel<T, P, 128><<<grid, 128, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const P*>(kp), static_cast<const P*>(vp),
      static_cast<const __half*>(sc.k), static_cast<const __half*>(sc.v),
      static_cast<const P*>(ap), static_cast<const __half*>(sc.act),
      static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<const T*>(wk),
      static_cast<const T*>(wv), pt, pty, pn, static_cast<T*>(out), m_out, l_out,
      KVH, G, D, d_model, maxp, layernorm, eps, 1.f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* ap,
           const void* scale, const void* bias, const void* wk, const void* wv,
           const int* pt, const int* pty, const int* pn, void* out, float* m_out,
           float* l_out, int B, int KVH, int G, int D, int d_model, int maxp,
           int layernorm, float eps, cudaStream_t stream, Scales sc) {
  if (sc.k != nullptr)
    return launch_fused<T, int8_t>(q, kp, vp, ap, scale, bias, wk, wv, pt, pty, pn, out,
                                   m_out, l_out, B, KVH, G, D, d_model, maxp, layernorm,
                                   eps, stream, sc);
  return launch_fused<T, T>(q, kp, vp, ap, scale, bias, wk, wv, pt, pty, pn, out, m_out,
                            l_out, B, KVH, G, D, d_model, maxp, layernorm, eps, stream,
                            sc);
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
// pools).  D a multiple of 16 up to 256; q and every pool 16-byte aligned.
// scratch: B * KVH * n_split * G * (D + 2) float32, the partials; the table
// row's entries [s * pps, (s + 1) * pps) go to split s; n_split <= 264,
// pps <= 128.  Launches the split
// pass and the combine pass on `stream`.
int hybrid_paged_attention_two_pool_fwd(const void* q, const void* k_pages,
                                        const void* v_pages, const void* k_scales,
                                        const void* v_scales, const void* act_k_pages,
                                        const void* act_v_pages, const void* page_table,
                                        const void* page_type, const void* page_ntok,
                                        void* out, void* m_out, void* l_out,
                                        void* scratch, int B, int KVH, int G, int D,
                                        int maxp, int n_split, int pps, int dtype,
                                        void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k_pages) |
                          reinterpret_cast<uintptr_t>(v_pages) |
                          reinterpret_cast<uintptr_t>(act_k_pages) |
                          reinterpret_cast<uintptr_t>(act_v_pages);
  if (D > MAX_D || D % 16 != 0 || G > MAX_G || G < 1 || n_split < 1 ||
      n_split > MAX_SPLITS || pps < 1 || pps > MAX_PPS ||
      (long)n_split * pps < maxp ||
      align % 16 != 0 || ((m_out == nullptr) != (l_out == nullptr)) ||
      ((k_scales == nullptr) != (v_scales == nullptr)))
    return (int)cudaErrorInvalidValue;
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  float* sc = static_cast<float*>(scratch);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* pty = static_cast<const int*>(page_type);
  const int* pn = static_cast<const int*>(page_ntok);
  const bool q8 = k_scales != nullptr;
#define SPLIT_ARGS q, k_pages, v_pages, k_scales, v_scales, act_k_pages, act_v_pages, \
    pt, pty, pn, out, mo, lo, sc, B, KVH, G, D, maxp, n_split, pps, st
  switch (dtype) {
    case 1: return q8 ? launch_split<__half, int8_t>(SPLIT_ARGS)
                      : launch_split<__half, __half>(SPLIT_ARGS);
    case 2: return q8 ? launch_split<__nv_bfloat16, int8_t>(SPLIT_ARGS)
                      : launch_split<__nv_bfloat16, __nv_bfloat16>(SPLIT_ARGS);
  }
#undef SPLIT_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
