// KV-Gen for Hopper, sm_90a: ACT pages -> norm -> K, V, with a RoPE epilogue.
//
// Replaces the TPU kernel `kv_gen` (body `_kv_gen_kernel`) of
// src/repro/kernels/kv_gen/kernel.py, the paper's Eq. 7 recomputation.
//
// What it computes: for each selected ACT page (page_index[n] of the pool
// (P, 16, d_model)), each of its 16 rows is normed in float32 (rmsnorm with
// `1 + scale`, or layernorm with scale and bias), rounded to the cache
// dtype, and projected by the layer's
// wk and wv, shaped (d_model, KVH, hd); the projected K and V are rounded to
// the dtype; with a `knorm` (the q/k-norm models, gemma3) K is then normed
// per (row, head) over its hd columns in float32, rmsnorm with `1 + knorm`
// and eps 1e-6, and rounded; and K is then rotated in float32 with the
// caller's per-row sin/cos tables (N, 16, hd/2; half-split layout) and
// rounded again.  That is
// where the model path (`_hybrid_layer_step`) rounds, so a recomputed K/V
// equals the one prefill stored for that token up to the order of summation.
// Two deliberate differences from the TPU kernel, both to follow the model
// path: LayerNorm applies its bias, and the rounding points above (the TPU
// kernel norms and projects in float32).  The rotation multiplies and adds
// with explicit round-to-nearest intrinsics, so it is not contracted into
// fused multiply-adds and gives PyTorch's elementwise result bit for bit.
//
// What bounds it on this card: one GEMM (N*16, d_model) x (d_model,
// 2*KVH*hd).  At the serve shape (N = 16 pages, d_model = 4096, KVH = 4,
// hd = 128, bf16) that is 2.1 GFLOP against 8.4 MB of weights, 2.1 MB of ACT
// and 0.5 MB of output: about 170 operations per byte, below the H100's
// ~295, so it is bound by bytes, and mostly by the weights.
//
// The simple design: a GEMM-tiled grid, one block per (32-row tile, one head
// of K or of V), one warp per 32 output columns: 4 warps for hd <= 128, 8 for
// hd <= 256 (gemma3).  The whole head sits in one block, so the RoPE epilogue
// finds both halves of every pair and the K norm its whole row.  The block
// first takes its rows' statistics in float32, each warp walking 8 rows at
// once so that 8 loads per lane are in flight.  Then d_model streams through
// shared memory 128 columns at a time: each thread loads its share of the
// next ACT and weight tiles into registers (16-byte loads, all issued before
// any is used) while the warps multiply the current tiles; the ACT tile is
// normed and rounded on its way into shared memory.  Each warp owns a 32x32
// share of the output on the tensor cores (WMMA 16x16x16, float32
// accumulators), which goes through shared memory (aliasing the weight
// tile) to the epilogue.  A step takes 128 columns of d_model at hd <= 128
// and 64 at hd <= 256, so that the weight tile (64 x 264 x 2 = 33,792 bytes)
// and the whole block stay under the 48 KB of static shared memory.  Each block reads its head's weight slice once for
// its 32 rows, so the weights are read N*16/32 times in all, mostly from
// L2.  cp.async or TMA pipelines, `wgmma`, and a grid that reads each weight
// once are later work.
//
// int8 mode (a non-null `act_scales`): the ACT pool holds int8 codes with one
// float16 scale per token (P, 16, 1), the quantized cache's ACT region.  The
// norm prologue dequantizes each value as rnd<T>(code * scale), the product in
// float32 rounded to the cache dtype T, which is the value the model path's
// fake quantization stores; the statistics pass and the tile loads read the
// same values.  This is the ACT dequant of the TPU hybrid kernel's norm hoist
// (src/repro/kernels/hybrid_attention/kernel.py:100-103), which the RoPE route
// runs here.  Outputs stay in the cache dtype.  The ACT bytes halve; the
// weights, which dominate, do not change.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <cstdint>
#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int PAGE = 16;
constexpr int BM = 32;             // rows per block (two pages)
constexpr int MAX_HD = 256;        // the widest head a block takes
constexpr int VEC = 8;             // 16-bit elements per 16-byte load
constexpr float KNORM_EPS = 1e-6f; // the K norm's eps (rms_norm's default)

// The tiling of a block whose head is up to HDB columns wide (128 or 256).
template <int HDB> struct Tile {
  static constexpr int THREADS = HDB;      // warp w owns output columns [32w, 32w + 32)
  static constexpr int WARPS = THREADS / 32;
  static constexpr int BK = HDB == 128 ? 128 : 64;   // d_model columns per step
  static constexpr int RPW = BM / WARPS;   // rows per warp in the statistics pass
  static constexpr int LDA = BK + 8;       // padded leading dimensions (elements)
  static constexpr int LDB = HDB + 8;
  static constexpr int LDC = HDB + 4;
  static constexpr int TPRA = BK / VEC;    // threads per ACT tile row
  static constexpr int TPRB = HDB / VEC;   // threads per weight tile row
  static constexpr int A_VECS = BM * BK / VEC / THREADS;   // per thread and step
  static constexpr int B_VECS = BK * HDB / VEC / THREADS;
  static constexpr int B_BYTES = BK * LDB * 2;             // weight tile, 16-bit
  static constexpr int C_BYTES = BM * LDC * 4;             // accumulators, float
  static_assert(THREADS % TPRA == 0 && THREADS % TPRB == 0 &&
                    A_VECS * THREADS * VEC == BM * BK &&
                    B_VECS * THREADS * VEC == BK * HDB && BM % WARPS == 0,
                "tile thread mapping");
  static_assert(C_BYTES <= B_BYTES, "the accumulator tile aliases the weight tile");
};

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// VEC elements of a payload type P in one load: 16 bytes of a 16-bit type,
// 8 bytes of int8 codes
template <typename P> struct Vec8 { using type = uint4; };
template <> struct Vec8<int8_t> { using type = uint2; };

template <typename P>
__device__ __forceinline__ typename Vec8<P>::type ldv(const P* p) {
  return *reinterpret_cast<const typename Vec8<P>::type*>(p);
}

// VEC payload elements as float: cache-dtype values, or int8 codes times the
// row's scale `sc`, rounded to the cache dtype T
template <typename T, typename P>
__device__ __forceinline__ void unpack8(const typename Vec8<P>::type& u, float* f,
                                        float sc) {
  const P* e = reinterpret_cast<const P*>(&u);
#pragma unroll
  for (int i = 0; i < VEC; ++i) {
    if constexpr (std::is_same<P, int8_t>::value) f[i] = rnd<T>(__fmul_rn((float)e[i], sc));
    else f[i] = to_f(e[i]);
  }
}

__device__ __forceinline__ uint4 ld16(const void* p) {
  return *reinterpret_cast<const uint4*>(p);
}

// norm_type: 0 layernorm, 1 rmsnorm.  P: the ACT payload type, T or int8_t.
// HDB: the block's head width (Tile).  knorm: null, or the K norm's (hd,).
template <typename T, typename P, int HDB>
__global__ void __launch_bounds__(HDB)
kv_gen_kernel(const P* __restrict__ act, const __half* __restrict__ act_scales,
              const int* __restrict__ page_index,
              const T* __restrict__ norm_scale, const T* __restrict__ norm_bias,
              const T* __restrict__ wk, const T* __restrict__ wv,
              const T* __restrict__ knorm,
              const float* __restrict__ sin_t, const float* __restrict__ cos_t,
              T* __restrict__ k_out, T* __restrict__ v_out, int n_rows,
              int d_model, int KVH, int hd, int norm_type, float eps) {
  using Tl = Tile<HDB>;
  constexpr int THREADS = Tl::THREADS, WARPS = Tl::WARPS, BK = Tl::BK;
  constexpr int RPW = Tl::RPW, LDA = Tl::LDA, LDB = Tl::LDB, LDC = Tl::LDC;
  constexpr int A_VECS = Tl::A_VECS, B_VECS = Tl::B_VECS;
  __shared__ __align__(32) T a_s[BM * LDA];
  __shared__ __align__(32) unsigned char bc_s[Tl::B_BYTES];   // weight tile, then C
  __shared__ long row_off[BM];
  __shared__ float row_sc[BM];       // int8 mode: each row's scale
  __shared__ float mu_s[BM], rstd_s[BM];
  __shared__ float kn_rstd[BM];      // the K norm's per-row factor
  T* b_s = reinterpret_cast<T*>(bc_s);
  float* c_s = reinterpret_cast<float*>(bc_s);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int which = blockIdx.x / KVH, h = blockIdx.x % KVH;  // 0: K, 1: V
  const int m0 = blockIdx.y * BM;
  const T* w = (which ? wv : wk) + (long)h * hd;
  const long ldw = (long)KVH * hd;

  if (tid < BM) {
    const int m = m0 + tid;
    long off = -1;
    float sc = 1.f;
    if (m < n_rows) {
      const long pg = page_index[m / PAGE];
      off = (pg * PAGE + m % PAGE) * d_model;
      if (act_scales != nullptr) sc = __half2float(act_scales[pg * PAGE + m % PAGE]);
    }
    row_off[tid] = off;
    row_sc[tid] = sc;
  }
  __syncthreads();

  // row statistics in float32; warp w takes rows w, w + 4, ... all at once
  float mu[RPW], acc_s[RPW];
#pragma unroll
  for (int j = 0; j < RPW; ++j) mu[j] = 0.f;
  for (int pass = norm_type == 0 ? 0 : 1; pass < 2; ++pass) {
#pragma unroll
    for (int j = 0; j < RPW; ++j) acc_s[j] = 0.f;
    for (int c = lane * VEC; c < d_model; c += 32 * VEC) {
      typename Vec8<P>::type u[RPW];
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        const long off = row_off[warp + j * WARPS];
        u[j] = off >= 0 ? ldv(act + off + c) : typename Vec8<P>::type{};
      }
#pragma unroll
      for (int j = 0; j < RPW; ++j) {
        float f[VEC];
        unpack8<T, P>(u[j], f, row_sc[warp + j * WARPS]);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          acc_s[j] += pass == 0 ? f[i] : (f[i] - mu[j]) * (f[i] - mu[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < RPW; ++j) {
      const float tot = warp_sum(acc_s[j]) / d_model;
      if (pass == 0) mu[j] = tot;
      else if (lane == 0) {
        mu_s[warp + j * WARPS] = mu[j];
        rstd_s[warp + j * WARPS] = rsqrtf(tot + eps);
      }
    }
  }

  // this thread's share of a step's tiles: ACT tile column ta, rows
  // ra0 + RA*j; weight tile column tb, rows rb0 + RB*j
  constexpr int RA = THREADS / Tl::TPRA, RB = THREADS / Tl::TPRB;
  const int ta = (tid % Tl::TPRA) * VEC, ra0 = tid / Tl::TPRA;
  const int tb = (tid % Tl::TPRB) * VEC, rb0 = tid / Tl::TPRB;
  typename Vec8<P>::type ax[A_VECS];
  uint4 sc4 = make_uint4(0u, 0u, 0u, 0u), bi4 = sc4, bw[B_VECS];
  auto load = [&](int k0) {
    const int d = k0 + ta;
    const bool din = d < d_model;
#pragma unroll
    for (int j = 0; j < A_VECS; ++j) {
      const long off = row_off[ra0 + j * RA];
      ax[j] = off >= 0 && din ? ldv(act + off + d) : typename Vec8<P>::type{};
    }
    sc4 = din ? ld16(norm_scale + d) : make_uint4(0u, 0u, 0u, 0u);
    if (norm_type == 0) bi4 = din ? ld16(norm_bias + d) : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 0; j < B_VECS; ++j) {
      const int r = k0 + rb0 + j * RB;
      bw[j] = tb < hd && r < d_model ? ld16(w + r * ldw + tb)
                                     : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  auto store = [&]() {
    float s[VEC], b[VEC];
    unpack8<T, T>(sc4, s, 1.f);
    unpack8<T, T>(bi4, b, 1.f);
#pragma unroll
    for (int j = 0; j < A_VECS; ++j) {
      const int r = ra0 + j * RA;
      float f[VEC];
      unpack8<T, P>(ax[j], f, row_sc[r]);
      alignas(16) T y[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        float x = f[e];
        if (norm_type == 0) x = (x - mu_s[r]) * rstd_s[r] * s[e] + b[e];
        else x = x * rstd_s[r] * (1.f + s[e]);
        y[e] = from_f<T>(x);
      }
      *reinterpret_cast<uint4*>(a_s + r * LDA + ta) = *reinterpret_cast<const uint4*>(y);
    }
#pragma unroll
    for (int j = 0; j < B_VECS; ++j)
      *reinterpret_cast<uint4*>(b_s + (rb0 + j * RB) * LDB + tb) = bw[j];
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  const bool active = warp * 32 < hd;

  load(0);
  for (int k0 = 0; k0 < d_model; k0 += BK) {
    __syncthreads();               // statistics ready, previous tiles consumed
    store();
    __syncthreads();
    if (k0 + BK < d_model) load(k0 + BK);        // in flight during the MMAs
    if (active) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], a_s + i * 16 * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], b_s + kk * LDB + warp * 32 + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
    }
  }

  __syncthreads();                 // the weight tile is consumed: C aliases it
  if (active) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(c_s + i * 16 * LDC + warp * 32 + j * 16, acc[i][j],
                                LDC, wmma::mem_row_major);
  }
  __syncthreads();

  if (which == 0 && knorm != nullptr) {    // the K norm of the rounded projection
    for (int r = warp; r < BM; r += WARPS) {
      float sq = 0.f;
      for (int c = lane; c < hd; c += 32) {
        const float x = rnd<T>(c_s[r * LDC + c]);
        sq += x * x;
      }
      sq = warp_sum(sq);
      if (lane == 0) kn_rstd[r] = rsqrtf(sq / hd + KNORM_EPS);
    }
    __syncthreads();
    for (int i = tid; i < BM * hd; i += THREADS) {
      const int r = i / hd, c = i % hd;
      c_s[r * LDC + c] =
          rnd<T>(rnd<T>(c_s[r * LDC + c]) * kn_rstd[r] * (1.f + to_f(knorm[c])));
    }
    __syncthreads();
  }

  T* out = which ? v_out : k_out;
  const int half = hd / 2;
  const bool rope = which == 0;
  for (int i = tid; i < BM * hd; i += THREADS) {     // epilogue
    const int r = i / hd, c = i % hd, m = m0 + r;
    if (m >= n_rows) continue;
    float x = rnd<T>(c_s[r * LDC + c]);
    if (rope) {
      const int j = c < half ? c : c - half;
      const float sn = sin_t[(long)m * half + j], cs = cos_t[(long)m * half + j];
      if (c < half) {            // x1 * cos - x2 * sin
        const float x2 = rnd<T>(c_s[r * LDC + c + half]);
        x = __fsub_rn(__fmul_rn(x, cs), __fmul_rn(x2, sn));
      } else {                   // x2 * cos + x1 * sin
        const float x1 = rnd<T>(c_s[r * LDC + c - half]);
        x = __fadd_rn(__fmul_rn(x, cs), __fmul_rn(x1, sn));
      }
    }
    out[((long)m * KVH + h) * hd + c] = from_f<T>(x);
  }
}

template <typename T, typename P, int HDB>
int launch_as(const void* act, const void* act_scales, const int* page_index,
              const void* scale, const void* bias, const void* wk, const void* wv,
              const void* knorm, const float* sin_t, const float* cos_t, void* k_out,
              void* v_out, int n_pages, int d_model, int KVH, int hd, int norm_type,
              float eps, cudaStream_t stream) {
  const int n_rows = n_pages * PAGE;
  const dim3 grid(2 * KVH, (n_rows + BM - 1) / BM);
  kv_gen_kernel<T, P, HDB><<<grid, Tile<HDB>::THREADS, 0, stream>>>(
      static_cast<const P*>(act), static_cast<const __half*>(act_scales), page_index,
      static_cast<const T*>(scale),
      static_cast<const T*>(bias), static_cast<const T*>(wk),
      static_cast<const T*>(wv), static_cast<const T*>(knorm), sin_t, cos_t,
      static_cast<T*>(k_out), static_cast<T*>(v_out), n_rows, d_model, KVH, hd,
      norm_type, eps);
  return (int)cudaGetLastError();
}

template <typename T, typename P>
int launch_hd(const void* act, const void* act_scales, const int* page_index,
              const void* scale, const void* bias, const void* wk, const void* wv,
              const void* knorm, const float* sin_t, const float* cos_t, void* k_out,
              void* v_out, int n_pages, int d_model, int KVH, int hd, int norm_type,
              float eps, cudaStream_t stream) {
  if (hd <= 128)
    return launch_as<T, P, 128>(act, act_scales, page_index, scale, bias, wk, wv,
                                knorm, sin_t, cos_t, k_out, v_out, n_pages, d_model,
                                KVH, hd, norm_type, eps, stream);
  return launch_as<T, P, 256>(act, act_scales, page_index, scale, bias, wk, wv, knorm,
                              sin_t, cos_t, k_out, v_out, n_pages, d_model, KVH, hd,
                              norm_type, eps, stream);
}

template <typename T>
int launch(const void* act, const void* act_scales, const int* page_index,
           const void* scale, const void* bias, const void* wk, const void* wv,
           const void* knorm, const float* sin_t, const float* cos_t, void* k_out,
           void* v_out, int n_pages, int d_model, int KVH, int hd, int norm_type,
           float eps, cudaStream_t stream) {
  if (act_scales != nullptr)
    return launch_hd<T, int8_t>(act, act_scales, page_index, scale, bias, wk, wv,
                                knorm, sin_t, cos_t, k_out, v_out, n_pages, d_model,
                                KVH, hd, norm_type, eps, stream);
  return launch_hd<T, T>(act, nullptr, page_index, scale, bias, wk, wv, knorm, sin_t,
                         cos_t, k_out, v_out, n_pages, d_model, KVH, hd, norm_type,
                         eps, stream);
}

}  // namespace

extern "C" {

// page_index: int32 (n_pages,).  norm_type: 0 layernorm (scale and bias),
// 1 rmsnorm (scale).  knorm: null, or the K norm's scale (hd,) in the dtype.
// sin/cos: float32 (n_pages, 16, hd/2).  dtype: 1 float16, 2 bfloat16.
// act_scales: null, or float16 (P, 16, 1) with an int8 act_pages (int8 mode).
// d_model a multiple of 8, hd a multiple of 32 up to 256, act/weights/norm
// parameters 16-byte aligned.  Returns a cudaError_t.
int kv_gen_fwd(const void* act_pages, const void* act_scales, const void* page_index,
               const void* norm_scale,
               const void* norm_bias, const void* wk, const void* wv, const void* knorm,
               const void* sin_t, const void* cos_t, void* k_out, void* v_out,
               int n_pages, int d_model, int KVH, int hd, int norm_type, float eps,
               int dtype, void* stream) {
  if (n_pages < 1 || d_model % VEC || hd % 32 || hd > MAX_HD || KVH < 1 ||
      page_index == nullptr || norm_type < 0 || norm_type > 1 || norm_scale == nullptr ||
      (norm_type == 0 && norm_bias == nullptr) || sin_t == nullptr || cos_t == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pi = static_cast<const int*>(page_index);
  const float* sn = static_cast<const float*>(sin_t);
  const float* cs = static_cast<const float*>(cos_t);
  switch (dtype) {
    case 1: return launch<__half>(act_pages, act_scales, pi, norm_scale, norm_bias, wk,
                                  wv, knorm, sn, cs, k_out, v_out, n_pages, d_model,
                                  KVH, hd, norm_type, eps, st);
    case 2: return launch<__nv_bfloat16>(act_pages, act_scales, pi, norm_scale,
                                         norm_bias, wk, wv, knorm, sn, cs, k_out, v_out,
                                         n_pages, d_model, KVH, hd, norm_type, eps,
                                         st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
