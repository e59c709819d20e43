// KV-Gen for Hopper, sm_90a: ACT pages -> norm -> K, V, with a RoPE epilogue.
//
// Replaces the TPU kernel `kv_gen` (body `_kv_gen_kernel`) of
// src/repro/kernels/kv_gen/kernel.py, the paper's Eq. 7 recomputation.
//
// What it computes: for each selected ACT page (page_index[n] of the pool
// (P, 16, d_model)), each of its 16 rows is normed in float32 (rmsnorm with
// `1 + scale`, or layernorm with scale and bias), rounded to the cache
// dtype, and projected by the layer's wk and wv, shaped (d_model, KVH, hd);
// the projected K and V are rounded to the dtype; with a `knorm` (the
// q/k-norm models, gemma3) K is then normed per (row, head) over its hd
// columns in float32, rmsnorm with `1 + knorm` and eps 1e-6, and rounded;
// and K is then rotated in float32 with the caller's per-row sin/cos tables
// (N, 16, hd/2; half-split layout) and rounded again.  That is where the
// model path (`_hybrid_layer_step`) rounds, so a recomputed K/V equals the
// one prefill stored for that token up to the order of summation.  Two
// deliberate differences from the TPU kernel, both to follow the model
// path: LayerNorm applies its bias, and the rounding points above (the TPU
// kernel norms and projects in float32).  The rotation multiplies and adds
// with explicit round-to-nearest intrinsics, so it is not contracted into
// fused multiply-adds and gives PyTorch's elementwise result bit for bit.
//
// int8 mode (a non-null `act_scales`): the ACT pool holds int8 codes with one
// float16 scale per token (P, 16, 1), the quantized cache's ACT region; the
// norm pass dequantizes each value as rnd<T>(code * scale), the value the
// model path's fake quantization stores (the ACT dequant of the TPU hybrid
// kernel's norm hoist, src/repro/kernels/hybrid_attention/kernel.py:100-103,
// which the RoPE route runs here).  The ACT bytes halve; the weights, which
// dominate, do not change.
//
// What bounds it on this card: one GEMM (N*16, d_model) x (d_model,
// 2*KVH*hd).  At yi-6b's serve shape (12 pages, d_model 4096, KVH 4, hd 128,
// bf16) that is 1.6 GFLOP against 8.4 MB of weights, 1.6 MB of ACT and
// 0.4 MB of output: ~160 operations per byte, under the H100's ~295, so it is
// bound by bytes, mostly the weights' (~3 us at 3.35 TB/s).  The design reads
// each weight byte from device memory once per launch and keeps enough bytes
// in flight to approach that rate.
//
// Design.  Two kernels on the current stream:
//   - Norm pass, one warp per row: each selected row is dequantized (int8
//     mode), normed in float32 once per launch (not once per head or column
//     block) and written rounded to T into a scratch of (N*16, d_model) rows
//     in page_index's order (norm_row, kernels/hopper.cuh).
//   - Projection pass, grid (CL, groups, row tiles) in thread-block clusters
//     of CL blocks along d_model.  A group is one head's [K | V] (hd <= 128:
//     one wgmma m64n(2 HDP)k16, HDP = hd rounded up to 64) or, at hd > 128
//     (gemma3's 256), K or V alone (m64n256k16).  Block (r, group, tile)
//     streams the tile's 64 scratch rows and the group's weight columns over
//     its 1/CL of d_model in chunks of 64 by TMA into a ring of 4 stages
//     guarded by mbarriers, the weights read MN-major through the
//     descriptor's transpose bit (as the fused hybrid tile pass).  The
//     float32 partials go to shared memory; after a cluster barrier, block r
//     sums rows
//     [r 64/CL, (r + 1) 64/CL) of all CL partials through distributed shared
//     memory, in rank order, and runs the epilogue on them, where the whole
//     head row lives: round, K norm, RoPE, round, scatter to (N, 16, KVH, hd).
//     CL (1, 2, 4 or 8) is the largest that keeps the grid within one block
//     per SM; the row tiles of one group read its weight slice together,
//     from L2 after the first.
//
// `flags` (a planted fault, 0 on the model's path): bit 0 drops the last
// d_model slice's partial from the cluster's sum.
#include <cooperative_groups.h>

#include "../../hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int PAGE = 16;
constexpr int ROWS = 64;                 // a row tile: wgmma's M (four pages)
constexpr int THREADS = 128;             // one warpgroup
constexpr int NORM_THREADS = 128;        // the norm pass: one warp per row
constexpr int KC = 64;                   // d_model columns per ring stage
constexpr int STAGES = 4;
constexpr int MAX_HD = 256;
constexpr int MAX_CLUSTER = 8;
constexpr float KNORM_EPS = 1e-6f;       // the K norm's eps (rms_norm's default)

// the projection pass at padded head width HDP (64, 128 or 256)
template <int HDP> struct Proj {
  static constexpr bool KV_APART = HDP > 128;        // K and V in separate blocks
  static constexpr int NW = KV_APART ? HDP : 2 * HDP;   // output columns: 128 or 256
  static constexpr int NB = NW / 64;                 // 64-column weight boxes a stage
  static constexpr int A_BYTES = ROWS * 128;         // 64 rows x 64 16-bit columns
  static constexpr int W_BYTES = KC * 128;           // 64 d_model rows x 64 columns
  static constexpr int STAGE_BYTES = A_BYTES + NB * W_BYTES;
  static constexpr int LDP = NW + 4;                 // a partial row, padded (floats)
  static constexpr int PART_BYTES = ROWS * LDP * 4;  // aliases the ring once drained
  static constexpr int RING = STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = RING > PART_BYTES ? RING : PART_BYTES;
  // + the barriers, + slack to align the base to the 1 KB swizzle atom
  static constexpr int SMEM = BAR_OFF + STAGES * 8 + 1024;
};

// Norm pass: warp w of block i norms output row m = 4 i + w (page
// page_index[m / 16], row m % 16) into row m of `rows`.
template <typename T, typename P>
__global__ void __launch_bounds__(NORM_THREADS)
kv_norm_kernel(const P* __restrict__ act_pages, const __half* __restrict__ act_scales,
               const int* __restrict__ page_index, const T* __restrict__ norm_scale,
               const T* __restrict__ norm_bias, T* __restrict__ rows, int n_rows,
               int d_model, int layernorm, float eps) {
  const int m = blockIdx.x * (NORM_THREADS / 32) + threadIdx.x / 32;
  if (m >= n_rows) return;
  const long src = (long)page_index[m / PAGE] * PAGE + m % PAGE;   // the pool's row
  const float sc = act_scales != nullptr ? __half2float(act_scales[src]) : 1.f;
  norm_row<T>(act_pages + src * d_model, sc, norm_scale, norm_bias,
              rows + (long)m * d_model, d_model, layernorm, eps, threadIdx.x % 32);
}

// stage `c` of the block's d_model range: the tile's scratch rows and the
// group's weight columns of d_model chunk k0 / KC, one barrier for all
template <int HDP>
__device__ __forceinline__ void load_stage(uint8_t* smem, uint64_t* full, int c, int k0,
                                           const CUtensorMap* tm_a, const CUtensorMap* tm_k,
                                           const CUtensorMap* tm_v, int m0, int h,
                                           int which) {
  using L = Proj<HDP>;
  uint8_t* st = smem + (c % STAGES) * L::STAGE_BYTES;
  uint64_t* bar = &full[c % STAGES];
  mbar_expect_tx(bar, L::STAGE_BYTES);
  tma_load_2d(st, tm_a, bar, k0, m0);
  uint8_t* w = st + L::A_BYTES;
#pragma unroll
  for (int nb = 0; nb < L::NB; ++nb) {
    // [K | V]: K's HDP / 64 boxes, then V's; apart: the group's own
    const bool v = L::KV_APART ? which == 1 : nb >= L::NB / 2;
    const int col = (L::KV_APART ? nb : nb % (L::NB / 2)) * 64;
    tma_load_3d(w + nb * L::W_BYTES, v ? tm_v : tm_k, bar, col, h, k0);
  }
}

// Projection pass.  Block (r, group, tile): rows 64 tile .. + 63, the
// group's columns, d_model chunks [r nc / CL, (r + 1) nc / CL).
template <typename T, int HDP>
__global__ void __launch_bounds__(THREADS, 1)
kv_proj_kernel(const __grid_constant__ CUtensorMap tm_a,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v, const T* __restrict__ knorm,
               const float* __restrict__ sin_t, const float* __restrict__ cos_t,
               T* __restrict__ k_out, T* __restrict__ v_out, int n_rows, int d_model,
               int KVH, int hd, int flags) {
  using L = Proj<HDP>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* part = reinterpret_cast<float*>(smem);                    // [ROWS][LDP]
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);  // [STAGES]
  cg::cluster_group cluster = cg::this_cluster();
  const int CL = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int group = blockIdx.y, m0 = blockIdx.z * ROWS;
  const int h = L::KV_APART ? group / 2 : group;
  const int which = L::KV_APART ? group % 2 : 0;
  const int nc = (d_model + KC - 1) / KC;
  const int c0 = rank * nc / CL, my_nc = (rank + 1) * nc / CL - c0;

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    for (int c = 0; c < STAGES && c < my_nc; ++c)
      load_stage<HDP>(smem, full, c, (c0 + c) * KC, &tm_a, &tm_k, &tm_v, m0, h, which);
  }
  __syncthreads();

  // D (64 x NW) = A (64 x its d_model range) . W: chunk c's products are
  // started, then chunk c - 1's waited for and its stage refilled with
  // chunk c - 1 + STAGES, so three chunks' loads stay in flight
  float acc[L::NW / 2];
#pragma unroll
  for (int i = 0; i < L::NW / 2; ++i) acc[i] = 0.f;
  for (int c = 0; c < my_nc; ++c) {
    const int st = c % STAGES;
    mbar_wait(&full[st], (c / STAGES) & 1);
    const uint32_t a_addr = smem_u32(smem + st * L::STAGE_BYTES);
    const uint32_t w_addr = a_addr + L::A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 16; ++kk) {
      // A: 8-row groups 1 KB apart, a k-step 32 bytes into the swizzle atom;
      // B: 16 d_model rows a k-step, 64-column blocks W_BYTES apart
      const uint64_t da = desc_sw128(a_addr + kk * 32, 16, 1024);
      const uint64_t db = desc_sw128(w_addr + kk * 2048, L::W_BYTES, 1024);
      if constexpr (L::NW == 256) wgmma_tn_n256(acc, da, db, 1, T{});
      else wgmma_tn_n128(acc, da, db, 1, T{});
    }
    wgmma_commit();
    wgmma_wait<1>();
    fence_regs(acc);
    __syncthreads();                 // every warp is past chunk c - 1's stage
    if (tid == 0 && c >= 1 && c - 1 + STAGES < my_nc)
      load_stage<HDP>(smem, full, c - 1 + STAGES, (c0 + c - 1 + STAGES) * KC, &tm_a,
                      &tm_k, &tm_v, m0, h, which);
  }
  wgmma_wait<0>();
  fence_regs(acc);
  __syncthreads();                   // the ring is drained: the partial aliases it
  // the fragment: rows 16 warp + lane / 4 (+ 8), columns 8 j + 2 (lane % 4)
#pragma unroll
  for (int j = 0; j < L::NW / 8; ++j)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = 16 * warp + lane / 4 + 8 * rr, col = 8 * j + 2 * (lane % 4);
      *reinterpret_cast<float2*>(part + row * L::LDP + col) =
          make_float2(acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1]);
    }
  cluster.sync();                    // every block's partial is written

  // rows [r0, r0 + rpb): the sum over the cluster's blocks, in rank order,
  // written over this block's own partial (only this block reads these rows)
  const int rpb = ROWS / CL, r0 = rank * rpb;
  const int srcs = (flags & 1) ? CL - 1 : CL;
  for (int e = tid; e < rpb * L::NW / 4; e += THREADS) {
    const int row = r0 + e / (L::NW / 4), col = (e % (L::NW / 4)) * 4;
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int src = 0; src < srcs; ++src) {
      const float4 v = *reinterpret_cast<const float4*>(
          cluster.map_shared_rank(part, src) + row * L::LDP + col);
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    *reinterpret_cast<float4*>(part + row * L::LDP + col) = s;
  }
  __syncthreads();

  // epilogue, one warp a row: K and V rounded (rounding point of the model
  // path), K normed and rounded, K rotated and rounded, scattered
  const int half = hd / 2;
  for (int row = r0 + warp; row < r0 + rpb; row += THREADS / 32) {
    const int m = m0 + row;
    if (m >= n_rows) continue;
    const float* pr = part + row * L::LDP;
    // this row's K columns start at column 0 of the group, V's at HDP (or 0)
    const bool has_k = !L::KV_APART || which == 0;
    const bool has_v = !L::KV_APART || which == 1;
    const float* kr = pr;
    const float* vr = pr + (L::KV_APART ? 0 : HDP);
    if (has_v)
      for (int c = lane; c < hd; c += 32)
        v_out[((long)m * KVH + h) * hd + c] = from_f<T>(vr[c]);
    if (!has_k) continue;
    float kn_rstd = 1.f;
    if (knorm != nullptr) {          // the K norm of the rounded projection
      float sq = 0.f;
      for (int c = lane; c < hd; c += 32) {
        const float x = rnd<T>(kr[c]);
        sq += x * x;
      }
      kn_rstd = rsqrtf(warp_sum(sq) / hd + KNORM_EPS);
    }
    auto kval = [&](int c) {
      const float x = rnd<T>(kr[c]);
      return knorm != nullptr ? rnd<T>(x * kn_rstd * (1.f + to_f(knorm[c]))) : x;
    };
    for (int c = lane; c < hd; c += 32) {
      const int j = c < half ? c : c - half;
      const float sn = sin_t[(long)m * half + j], cs = cos_t[(long)m * half + j];
      const float x = kval(c), other = kval(c < half ? c + half : c - half);
      const float r = c < half ? __fsub_rn(__fmul_rn(x, cs), __fmul_rn(other, sn))  // x1 cos - x2 sin
                               : __fadd_rn(__fmul_rn(x, cs), __fmul_rn(other, sn)); // x2 cos + x1 sin
      k_out[((long)m * KVH + h) * hd + c] = from_f<T>(r);
    }
  }
  cluster.sync();                    // no block leaves while its partial is read
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

template <typename T, typename P, int HDP>
int launch_as(const void* act, const void* act_scales, const int* page_index,
              const void* scale, const void* bias, const void* wk, const void* wv,
              const void* knorm, const float* sin_t, const float* cos_t, void* k_out,
              void* v_out, void* scratch, int n_pages, int d_model, int KVH, int hd,
              int layernorm, float eps, CUtensorMapDataType dtype, int flags,
              cudaStream_t stream) {
  using L = Proj<HDP>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        kv_proj_kernel<T, HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  int n_rows = n_pages * PAGE;             // (its address goes to the launch)
  T* rows = static_cast<T*>(scratch);
  // the normed rows (d_model, rows) in 64 x 64 boxes; wk and wv as
  // (hd, KVH, d_model), boxes of 64 columns of one head by 64 d_model rows
  const cuuint64_t a_dims[2] = {(cuuint64_t)d_model, (cuuint64_t)n_rows};
  const cuuint64_t a_strides[1] = {(cuuint64_t)d_model * 2};
  const cuuint32_t a_box[2] = {KC, ROWS};
  const cuuint64_t w_dims[3] = {(cuuint64_t)hd, (cuuint64_t)KVH, (cuuint64_t)d_model};
  const cuuint64_t w_strides[2] = {(cuuint64_t)hd * 2, (cuuint64_t)KVH * hd * 2};
  const cuuint32_t w_box[3] = {64, 1, KC};
  CUtensorMap ta, tk, tv;
  if (!make_map(&ta, rows, dtype, 2, a_dims, a_strides, a_box) ||
      !make_map(&tk, wk, dtype, 3, w_dims, w_strides, w_box) ||
      !make_map(&tv, wv, dtype, 3, w_dims, w_strides, w_box))
    return (int)cudaErrorInvalidValue;
  kv_norm_kernel<T, P><<<(n_rows + 3) / 4, NORM_THREADS, 0, stream>>>(
      static_cast<const P*>(act), static_cast<const __half*>(act_scales), page_index,
      static_cast<const T*>(scale), static_cast<const T*>(bias), rows, n_rows, d_model,
      layernorm, eps);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  // the cluster: the largest of 8, 4, 2, 1 blocks along d_model that keeps
  // the grid within one block per SM and gives every block a chunk
  const int groups = L::KV_APART ? 2 * KVH : KVH;
  const int tiles = (n_rows + ROWS - 1) / ROWS, nc = (d_model + KC - 1) / KC;
  int CL = MAX_CLUSTER;
  while (CL > 1 && ((long)tiles * groups * CL > sm_count() || CL > nc)) CL /= 2;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL, groups, tiles);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = L::SMEM;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = CL;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const T* kn = static_cast<const T*>(knorm);
  T* ko = static_cast<T*>(k_out);
  T* vo = static_cast<T*>(v_out);
  void* args[] = {&ta, &tk, &tv, &kn, &sin_t, &cos_t, &ko, &vo, &n_rows, &d_model, &KVH,
                  &hd, &flags};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kv_proj_kernel<T, HDP>),
                            args);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

template <typename T, typename P>
int launch_hd(const void* act, const void* act_scales, const int* page_index,
              const void* scale, const void* bias, const void* wk, const void* wv,
              const void* knorm, const float* sin_t, const float* cos_t, void* k_out,
              void* v_out, void* scratch, int n_pages, int d_model, int KVH, int hd,
              int layernorm, float eps, CUtensorMapDataType dtype, int flags,
              cudaStream_t stream) {
#define HD_ARGS act, act_scales, page_index, scale, bias, wk, wv, knorm, sin_t, cos_t, \
    k_out, v_out, scratch, n_pages, d_model, KVH, hd, layernorm, eps, dtype, flags, stream
  if (hd <= 64) return launch_as<T, P, 64>(HD_ARGS);
  if (hd <= 128) return launch_as<T, P, 128>(HD_ARGS);
  return launch_as<T, P, 256>(HD_ARGS);
#undef HD_ARGS
}

}  // namespace

extern "C" {

// page_index: int32 (n_pages,).  norm_type: 0 layernorm (scale and bias),
// 1 rmsnorm (scale).  knorm: null, or the K norm's scale (hd,) in the dtype.
// sin/cos: float32 (n_pages, 16, hd/2).  dtype: 1 float16, 2 bfloat16.
// act_scales: null, or float16 (P, 16, 1) with an int8 act_pages (int8 mode).
// scratch: n_pages * 16 * d_model values of the dtype (the normed rows).
// d_model a multiple of 8, hd a multiple of 32 up to 256, act, weights, norm
// parameters and scratch 16-byte aligned.  flags: 0, or the planted fault in
// the header.  Launches the norm pass and the projection pass on `stream`.
// Returns a cudaError_t.
int kv_gen_fwd(const void* act_pages, const void* act_scales, const void* page_index,
               const void* norm_scale, const void* norm_bias, const void* wk,
               const void* wv, const void* knorm, const void* sin_t, const void* cos_t,
               void* k_out, void* v_out, void* scratch, int n_pages, int d_model, int KVH,
               int hd, int norm_type, float eps, int dtype, int flags, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(act_pages) |
                          reinterpret_cast<uintptr_t>(norm_scale) |
                          reinterpret_cast<uintptr_t>(norm_bias) |
                          reinterpret_cast<uintptr_t>(wk) | reinterpret_cast<uintptr_t>(wv) |
                          reinterpret_cast<uintptr_t>(scratch);
  if (n_pages < 1 || d_model < 8 || d_model % 8 || hd < 32 || hd % 32 || hd > MAX_HD ||
      KVH < 1 || page_index == nullptr || norm_type < 0 || norm_type > 1 ||
      norm_scale == nullptr || (norm_type == 0 && norm_bias == nullptr) ||
      sin_t == nullptr || cos_t == nullptr || scratch == nullptr || align % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pi = static_cast<const int*>(page_index);
  const float* sn = static_cast<const float*>(sin_t);
  const float* cs = static_cast<const float*>(cos_t);
  const int ln = norm_type == 0;
#define KV_ARGS(dt) act_pages, act_scales, pi, norm_scale, norm_bias, wk, wv, knorm, sn, cs, \
    k_out, v_out, scratch, n_pages, d_model, KVH, hd, ln, eps, dt, flags, st
  switch (dtype) {
    case 1:
      return act_scales != nullptr
                 ? launch_hd<__half, int8_t>(KV_ARGS(CU_TENSOR_MAP_DATA_TYPE_FLOAT16))
                 : launch_hd<__half, __half>(KV_ARGS(CU_TENSOR_MAP_DATA_TYPE_FLOAT16));
    case 2:
      return act_scales != nullptr
                 ? launch_hd<__nv_bfloat16, int8_t>(KV_ARGS(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16))
                 : launch_hd<__nv_bfloat16, __nv_bfloat16>(
                       KV_ARGS(CU_TENSOR_MAP_DATA_TYPE_BFLOAT16));
  }
#undef KV_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
