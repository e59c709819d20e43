// Hybrid paged decode attention with KV-Gen fused in, for Hopper, sm_90a.
//
// Replaces the TPU kernel `hybrid_paged_attention` (body `_hybrid_attn_kernel`)
// of src/repro/kernels/hybrid_attention/kernel.py: its floating-point path and
// its int8 mode.
//
// What it computes: one query token per request (q (B, KVH, G, D), GQA
// grouped) attends over a typed page table (B, MAXP): type 0 is a KV page of
// the pools (P, 16, KVH, D), type 1 an ACT page of the pool (P, 16, d_model)
// whose K/V are recomputed on the card (paper Eq. 7: norm, then the head's
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
// inside the fused projection's accumulators.
//
// return_lse mode (both entry points, the TPU kernel's `return_lse`): given
// non-null m_out/l_out (B, KVH, G, 1) float32, the combine pass also writes
// each query row's merged online-softmax state: m the masked max of the
// sm_scale'd scores (-1e30 when the row attended over no token), l the sum of
// exp(s - m).  The CPU attention lane merges this partial with the host's
// partial over the spilled KV rows.  The output and its masking are untouched.
//
// int8 mode (both entry points, the TPU kernel's `k_scales`/`v_scales`/
// `act_scales`): given non-null scale pointers, the KV pools hold int8 codes
// with float16 scales (P, 16, KVH, 1), one per (token, head), and in the fused
// entry the ACT pool holds int8 codes with float16 scales (P, 16, 1), one per
// token.  Each value is dequantized as rnd<T>(code * scale): the product in
// float32, rounded to the cache dtype, which is the value the model path's
// fake quantization stores (the TPU kernel keeps it in float32).  The
// second-pool entry's act_k/act_v pools stay in the cache dtype (KV-Gen
// writes them).
//
// The fused mode's design.  An ACT page costs 2 * 2 * 16 * d_model * D
// operations per head against its 16 x d_model rows and the head's two
// d_model x D weight slices: 16 operations per weight byte pair if each head
// projected each page alone, far below the card's ~295 operations per byte.
// So pages are projected in tiles, each weight slice streamed once per tile,
// and three kernels run on the current stream:
//   - Norm pass, grid (MAXP, B), one warp per row: each ACT entry's 16 rows
//     are dequantized (int8 mode), normed in float32 once per launch (the TPU
//     kernel's hoist; not once per head) and rounded to the cache dtype into
//     a scratch of (B, width, 16, d_model) rows, width = n_tiles * 4, at the
//     entry's place in its table row.  Other entries' rows are not written.
//   - Tile pass, grid (n_tiles, B, KVH), one warpgroup of 128 threads.
//     Block (t, b, h) takes entries 4t .. 4t + 3 of request b's row: 64
//     rows, one wgmma M.  Its KV entries are staged with 16-byte cp.async
//     first.  If any entry is ACT, the tile's 64 scratch rows (one contiguous
//     TMA box per stage: the scratch is laid out by table position) and the
//     head's wk and wv slices are streamed over d_model in chunks of 64 by
//     TMA into a ring of 4 stages guarded by mbarriers, and
//     [K | V] = A . [wk_h | wv_h] runs as wgmma m64n(2 DP)k16 (DP = 64 or
//     128, D <= DP zero-filled by TMA), A and B from shared memory in the
//     128-byte swizzle, B read MN-major through the descriptor's transpose
//     bit, so neither weight is copied transposed.  The float32 accumulators
//     are rounded to the cache dtype into the ACT entries' rows of the tile's
//     K/V (rounding point B); rows of other entries are dropped, so whatever
//     their scratch rows held never reaches a score.  Then the G <= 8 query
//     rows are scored against the tile's valid rows on the CUDA cores, and
//     the tile's softmax partial (o unnormalised, m, l: the return_lse
//     basis) goes to float32 scratch; a tile with no token writes o = 0,
//     m = -1e30, l = 0.  The tile count comes from the table's width alone.
//   - Combine pass, grid (G, KVH, B): the second-pool mode's merge of the
//     partials, instantiated under the fused route's own name.
// The grid's head axis is the slowest, so that the blocks resident together
// share a few heads' weight slices in L2; each slice is read from L2 once
// per tile that holds an ACT entry.
//
// The second-pool mode's design.  Its work is bound by bytes: each valid
// token's K and V row is read once (2 x D x 2 bytes in 16 bits) for
// 4 x G x D operations, far below the card's ~295 operations per byte.  One
// block per (KV head, request) is 4 blocks on 132 SMs under gemma3's MQA, and
// a block reading one page after another keeps few bytes in flight.  So two
// kernels run on the current stream:
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
#include <type_traits>

#include "../../hopper.cuh"

namespace {

constexpr int PAGE = 16;
constexpr int MAX_D = 256;       // the second-pool mode's; the fused mode's is 128
constexpr int MAX_G = 8;
constexpr float NEG_INF = -1e30f;

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
// The fused mode runs the same merge under its own name (fused_combine_kernel,
// one thread per column of its D <= 128).
template <typename T>
__device__ __forceinline__ void combine_partials(const float* __restrict__ part_o,
                                                 const float* __restrict__ part_ml,
                                                 T* __restrict__ out,
                                                 float* __restrict__ m_out,
                                                 float* __restrict__ l_out, int KVH,
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

template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
split_combine_kernel(const float* __restrict__ part_o,
                     const float* __restrict__ part_ml, T* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ l_out, int KVH,
                     int G, int D, int n_split) {
  combine_partials<T>(part_o, part_ml, out, m_out, l_out, KVH, G, D, n_split);
}

// ----------------------------------------------------------------------------
// Fused mode: norm pass and tile pass (the combine pass is the one above)

constexpr int TILE_PAGES = 4;                 // table entries per tile
constexpr int TILE_ROWS = TILE_PAGES * PAGE;  // 64: one wgmma M
constexpr int TILE_THREADS = 128;             // one warpgroup
constexpr int NORM_THREADS = PAGE * 32;       // one warp per row of a page
constexpr int KC = 64;                        // d_model columns per ring stage
constexpr int STAGES = 4;
constexpr int MAX_D_FUSED = 128;
constexpr int ROW_BYTES = 128;                // one swizzled row: 64 16-bit values

// Norm pass.  Block (p, b) takes entry p of request b's table row; if it is
// an ACT entry, warp r norms the page's row r in float32 (LayerNorm with its
// bias, or rmsnorm by 1 + scale) and writes it rounded to T as row
// (b * width + p) * 16 + r of the scratch (norm_row, kernels/hopper.cuh).
// P: the ACT pool's payload, T or int8_t.
template <typename T, typename P>
__global__ void __launch_bounds__(NORM_THREADS)
fused_norm_kernel(const P* __restrict__ act_pages, const __half* __restrict__ act_scales,
                  const T* __restrict__ norm_scale, const T* __restrict__ norm_bias,
                  const int* __restrict__ page_table, const int* __restrict__ page_type,
                  T* __restrict__ rows, int d_model, int maxp, int width, int layernorm,
                  float eps) {
  const int p = blockIdx.x, b = blockIdx.y;
  const long e = (long)b * maxp + p;
  if (page_type[e] != 1) return;
  const int r = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long src = (long)page_table[e] * PAGE + r;           // the pool's row
  const P* row = act_pages + src * d_model;
  const float sc = act_scales != nullptr ? __half2float(act_scales[src]) : 1.f;
  norm_row<T>(row, sc, norm_scale, norm_bias,
              rows + (((long)b * width + p) * PAGE + r) * d_model, d_model, layernorm, eps,
              lane);
}

// the tile pass's dynamic shared memory: the ring (per stage the 64 x 64 A
// box, then NB boxes of wk's and NB of wv's 64 x 64 slices), the tile's K and
// V in T, and in the int8 mode their staged codes
template <int DP, bool Q8>
struct FusedTiles {
  static constexpr int NB = DP / 64;                       // 64-column blocks
  static constexpr int A_BYTES = TILE_ROWS * ROW_BYTES;
  static constexpr int W_BYTES = KC * ROW_BYTES;
  static constexpr int STAGE_BYTES = A_BYTES + 2 * NB * W_BYTES;
  static constexpr int KV_OFF = STAGES * STAGE_BYTES;
  static constexpr int KV_ELEMS = TILE_ROWS * DP;
  static constexpr int Q8_OFF = KV_OFF + 2 * KV_ELEMS * 2;
  static constexpr int BAR_OFF = Q8_OFF + (Q8 ? 2 * KV_ELEMS : 0);
  // + the barriers, + slack to align the base to the 1 KB swizzle atom
  static constexpr int SMEM = BAR_OFF + STAGES * 8 + 1024;
};

// stage `c` of the projection: the tile's scratch rows and the head's
// weight columns of d_model chunk c, one barrier for all their bytes
template <int DP, bool Q8>
__device__ __forceinline__ void load_stage(uint8_t* smem, uint64_t* full,
                                            const CUtensorMap* tm_a,
                                            const CUtensorMap* tm_wk,
                                            const CUtensorMap* tm_wv, int c, int a_row,
                                            int h) {
  using L = FusedTiles<DP, Q8>;
  uint8_t* st = smem + (c % STAGES) * L::STAGE_BYTES;
  uint64_t* bar = &full[c % STAGES];
  mbar_expect_tx(bar, L::STAGE_BYTES);
  tma_load_2d(st, tm_a, bar, c * KC, a_row);
#pragma unroll
  for (int nb = 0; nb < L::NB; ++nb) {
    tma_load_3d(st + L::A_BYTES + nb * L::W_BYTES, tm_wk, bar, nb * 64, h, c * KC);
    tma_load_3d(st + L::A_BYTES + (L::NB + nb) * L::W_BYTES, tm_wv, bar, nb * 64, h,
                c * KC);
  }
}

// Tile pass.  Block (t, b, h) attends request b's KV head h over table
// entries 4t .. 4t + 3 and writes the unnormalised float32 partial in the
// return_lse basis: o (G, D), (m, l) per query row.  DP: the instantiated
// head width, 64 or 128 (D <= DP; wk/wv columns past D are zero-filled by
// TMA and dropped).  P: the KV pools' payload, T or int8_t.
template <typename T, typename P, int DP>
__global__ void __launch_bounds__(TILE_THREADS, 1)
fused_tile_kernel(const __grid_constant__ CUtensorMap tm_a,
                  const __grid_constant__ CUtensorMap tm_wk,
                  const __grid_constant__ CUtensorMap tm_wv, const T* __restrict__ q,
                  const P* __restrict__ k_pages, const P* __restrict__ v_pages,
                  const __half* __restrict__ k_scales,
                  const __half* __restrict__ v_scales,
                  const int* __restrict__ page_table, const int* __restrict__ page_type,
                  const int* __restrict__ page_ntok, float* __restrict__ part_o,
                  float* __restrict__ part_ml, int KVH, int G, int D, int d_model,
                  int maxp, int width, float sm_scale) {
  constexpr bool Q8 = !std::is_same<P, T>::value;
  using L = FusedTiles<DP, Q8>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  T* k_s = reinterpret_cast<T*>(smem + L::KV_OFF);           // [TILE_ROWS][DP]
  T* v_s = k_s + L::KV_ELEMS;
  int8_t* k8_s = reinterpret_cast<int8_t*>(smem + L::Q8_OFF);
  int8_t* v8_s = k8_s + L::KV_ELEMS;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);   // [STAGES]
  __shared__ float q_s[MAX_G][DP];
  __shared__ float s_s[MAX_G][TILE_ROWS];      // scores, then probabilities
  __shared__ float ksc_s[TILE_ROWS], vsc_s[TILE_ROWS];
  __shared__ float m_s[MAX_G], l_s[MAX_G];
  __shared__ int ty_s[TILE_PAGES], pg_s[TILE_PAGES], nt_s[TILE_PAGES];
  __shared__ bool ok_s[TILE_ROWS];             // the row holds a token

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int tile = blockIdx.x, b = blockIdx.y, h = blockIdx.z;
  if (tid < TILE_PAGES) {
    const int p = tile * TILE_PAGES + tid;
    const long e = (long)b * maxp + p;
    ty_s[tid] = p < maxp ? page_type[e] : 2;
    pg_s[tid] = p < maxp ? page_table[e] : 0;
    nt_s[tid] = p < maxp ? page_ntok[e] : 0;
  }
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const T* qb = q + ((long)b * KVH + h) * G * D;
  for (int i = tid; i < G * D; i += TILE_THREADS) q_s[i / D][i % D] = to_f(qb[i]) * sm_scale;
  __syncthreads();

  // the KV entries' rows, 16-byte cp.async, in flight during the projection
  bool any_act = false;
  for (int e = 0; e < TILE_PAGES; ++e) {
    any_act |= ty_s[e] == 1;
    if (ty_s[e] != 0) continue;
    const long pg = pg_s[e];
    const int row_bytes = D * (int)sizeof(P), chunks = row_bytes / 16;
    uint8_t* kd = Q8 ? reinterpret_cast<uint8_t*>(k8_s) : reinterpret_cast<uint8_t*>(k_s);
    uint8_t* vd = Q8 ? reinterpret_cast<uint8_t*>(v8_s) : reinterpret_cast<uint8_t*>(v_s);
    for (int i = tid; i < PAGE * chunks; i += TILE_THREADS) {
      const int r = i / chunks, c = i % chunks;
      const long src = ((pg * PAGE + r) * KVH + h) * row_bytes + c * 16;
      const int dst = (e * PAGE + r) * DP * (int)sizeof(P) + c * 16;
      cp_async16(kd + dst, reinterpret_cast<const uint8_t*>(k_pages) + src);
      cp_async16(vd + dst, reinterpret_cast<const uint8_t*>(v_pages) + src);
    }
    if (Q8 && tid < PAGE) {
      const long row = (pg * PAGE + tid) * KVH + h;
      ksc_s[e * PAGE + tid] = __half2float(k_scales[row]);
      vsc_s[e * PAGE + tid] = __half2float(v_scales[row]);
    }
  }
  cp_async_commit();

  if (any_act) {
    // [K | V] (64 x 2 DP) = A (64 x d_model) . [wk_h | wv_h], d_model in
    // chunks of 64 through the ring: chunk c's products are started, then
    // chunk c - 1's are waited for and its stage refilled with chunk
    // c - 1 + STAGES, so three chunks' loads stay in flight
    float acc[DP];
#pragma unroll
    for (int i = 0; i < DP; ++i) acc[i] = 0.f;
    const int n_chunks = d_model / KC;
    const int a_row = (b * width + tile * TILE_PAGES) * PAGE;
    if (tid == 0)
      for (int c = 0; c < STAGES && c < n_chunks; ++c)
        load_stage<DP, Q8>(smem, full, &tm_a, &tm_wk, &tm_wv, c, a_row, h);
    for (int c = 0; c < n_chunks; ++c) {
      const int st = c % STAGES;
      mbar_wait(&full[st], (c / STAGES) & 1);
      const uint32_t a_addr = smem_u32(smem + st * L::STAGE_BYTES);
      const uint32_t w_addr = a_addr + L::A_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk) {
        // A: 8-row groups 1 KB apart, a k-step 32 bytes into the swizzle
        // atom; B: 16 d_model rows a k-step, 64-column blocks W_BYTES apart
        const uint64_t da = desc_sw128(a_addr + kk * 32, 16, 1024);
        const uint64_t db = desc_sw128(w_addr + kk * 2048, L::W_BYTES, 1024);
        if constexpr (DP == 128) wgmma_tn_n256(acc, da, db, 1, T{});
        else wgmma_tn_n128(acc, da, db, 1, T{});
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(acc);
      __syncthreads();                 // every warp is past chunk c - 1's stage
      if (tid == 0 && c >= 1 && c - 1 + STAGES < n_chunks)
        load_stage<DP, Q8>(smem, full, &tm_a, &tm_wk, &tm_wv, c - 1 + STAGES, a_row,
                           h);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    // the fragment: a thread holds rows r0 = 16 warp + lane / 4 and r0 + 8
    // (both of entry `warp`), columns n = 8 j + 2 (lane % 4) + {0, 1} of
    // [K | V] in acc[4j], acc[4j + 1] (row r0) and acc[4j + 2], acc[4j + 3]
    // (row r0 + 8).  Rounded to T: rounding point B
    if (ty_s[warp] == 1) {
      const int r0 = 16 * warp + lane / 4;
#pragma unroll
      for (int j = 0; j < DP / 4; ++j) {
        const int n = 8 * j + 2 * (lane % 4);
        const int col = n < DP ? n : n - DP;
        if (col < D) {
          T* dst = n < DP ? k_s : v_s;
          *reinterpret_cast<uint32_t*>(dst + r0 * DP + col) =
              pack2(acc[4 * j], acc[4 * j + 1], T{});
          *reinterpret_cast<uint32_t*>(dst + (r0 + 8) * DP + col) =
              pack2(acc[4 * j + 2], acc[4 * j + 3], T{});
        }
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();
  if constexpr (Q8) {                  // the KV entries' codes, dequantized
    for (int i = tid; i < TILE_ROWS * D; i += TILE_THREADS) {
      const int r = i / D, c = i % D;
      if (ty_s[r / PAGE] != 0) continue;
      k_s[r * DP + c] = from_f<T>(__fmul_rn((float)k8_s[r * DP + c], ksc_s[r]));
      v_s[r * DP + c] = from_f<T>(__fmul_rn((float)v8_s[r * DP + c], vsc_s[r]));
    }
    __syncthreads();
  }

  // scores: warp w takes rows w, w + 4, ..; lane its columns lane, lane + 32
  for (int r = warp; r < TILE_ROWS; r += TILE_THREADS / 32) {
    const int e = r / PAGE;
    const bool ok = ty_s[e] != 2 && r % PAGE < nt_s[e];
    float part[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) part[g] = 0.f;
    if (ok)
      for (int c = lane; c < D; c += 32) {
        const float kf = to_f(k_s[r * DP + c]);
#pragma unroll
        for (int g = 0; g < MAX_G; ++g)
          if (g < G) part[g] += q_s[g][c] * kf;
      }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) part[g] = warp_sum(part[g]);
    if (lane < G) {
      float sc = part[0];
#pragma unroll
      for (int g = 1; g < MAX_G; ++g) if (lane == g) sc = part[g];
      s_s[lane][r] = ok ? sc : NEG_INF;
    }
    if (lane == 0) ok_s[r] = ok;
  }
  __syncthreads();

  // the tile's softmax: warp w takes query rows w, w + 4; lane its tokens
  // lane and lane + 32
  for (int g = warp; g < G; g += TILE_THREADS / 32) {
    const float s0 = s_s[g][lane], s1 = s_s[g][lane + 32];
    float mx = fmaxf(s0, s1);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    const float p0 = ok_s[lane] ? __expf(s0 - mx) : 0.f;
    const float p1 = ok_s[lane + 32] ? __expf(s1 - mx) : 0.f;
    s_s[g][lane] = p0;
    s_s[g][lane + 32] = p1;
    const float l = warp_sum(p0 + p1);
    if (lane == 0) {
      m_s[g] = mx;
      l_s[g] = l;
    }
  }
  __syncthreads();

  // P.V: thread t owns column t; rows without a token are skipped, so
  // whatever their K/V rows hold never reaches the output
  const long part = ((long)b * KVH + h) * gridDim.x + tile;
  if (tid < D) {
    float o[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) o[g] = 0.f;
    for (int r = 0; r < TILE_ROWS; ++r) {
      if (!ok_s[r]) continue;
      const float vf = to_f(v_s[r * DP + tid]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g)
        if (g < G) o[g] += s_s[g][r] * vf;
    }
    float* po = part_o + part * G * D;
#pragma unroll
    for (int g = 0; g < MAX_G; ++g)
      if (g < G) po[g * D + tid] = o[g];
  }
  if (tid < G) {
    part_ml[(part * G + tid) * 2] = m_s[tid];
    part_ml[(part * G + tid) * 2 + 1] = l_s[tid];
  }
}

template <typename T>
__global__ void __launch_bounds__(TILE_THREADS)
fused_combine_kernel(const float* __restrict__ part_o,
                     const float* __restrict__ part_ml, T* __restrict__ out,
                     float* __restrict__ m_out, float* __restrict__ l_out, int KVH,
                     int G, int D, int n_tiles) {
  combine_partials<T>(part_o, part_ml, out, m_out, l_out, KVH, G, D, n_tiles);
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

// the scratch: the tile partials, float32 (B, KVH, n_tiles, G, D) then
// (B, KVH, n_tiles, G, 2), and from this byte offset the normed rows, T
// (B, n_tiles * 4, 16, d_model)
long fused_rows_offset(int B, int KVH, int G, int D, int n_tiles) {
  return ((long)B * KVH * n_tiles * G * (D + 2) * 4 + 255) / 256 * 256;
}

template <typename T, typename P, int DP>
int launch_fused(const void* q, const void* kp, const void* vp, const void* ap,
                 const void* scale, const void* bias, const void* wk, const void* wv,
                 const int* pt, const int* pty, const int* pn, void* out, float* m_out,
                 float* l_out, void* scratch, int B, int KVH, int G, int D, int d_model,
                 int maxp, int n_tiles, int layernorm, float eps, CUtensorMapDataType dt,
                 cudaStream_t stream, Scales sc) {
  constexpr bool Q8 = !std::is_same<P, T>::value;
  using L = FusedTiles<DP, Q8>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_tile_kernel<T, P, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const int width = n_tiles * TILE_PAGES;
  float* part_o = static_cast<float*>(scratch);
  float* part_ml = part_o + (long)B * KVH * n_tiles * G * D;
  T* rows = reinterpret_cast<T*>(static_cast<uint8_t*>(scratch) +
                                 fused_rows_offset(B, KVH, G, D, n_tiles));
  // the normed rows (d_model, rows) in 64 x 64 boxes; wk and wv as
  // (D, KVH, d_model), boxes of 64 columns of one head by 64 d_model rows
  const cuuint64_t a_dims[2] = {(cuuint64_t)d_model, (cuuint64_t)B * width * PAGE};
  const cuuint64_t a_strides[1] = {(cuuint64_t)d_model * 2};
  const cuuint32_t a_box[2] = {KC, TILE_ROWS};
  const cuuint64_t w_dims[3] = {(cuuint64_t)D, (cuuint64_t)KVH, (cuuint64_t)d_model};
  const cuuint64_t w_strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)KVH * D * 2};
  const cuuint32_t w_box[3] = {64, 1, KC};
  CUtensorMap ta, tk, tv;
  if (!make_map(&ta, rows, dt, 2, a_dims, a_strides, a_box) ||
      !make_map(&tk, wk, dt, 3, w_dims, w_strides, w_box) ||
      !make_map(&tv, wv, dt, 3, w_dims, w_strides, w_box))
    return (int)cudaErrorInvalidValue;
  if (maxp > 0) {
    fused_norm_kernel<T, P><<<dim3(maxp, B), NORM_THREADS, 0, stream>>>(
        static_cast<const P*>(ap), static_cast<const __half*>(sc.act),
        static_cast<const T*>(scale), static_cast<const T*>(bias), pt, pty, rows, d_model,
        maxp, width, layernorm, eps);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  fused_tile_kernel<T, P, DP><<<dim3(n_tiles, B, KVH), TILE_THREADS, L::SMEM, stream>>>(
      ta, tk, tv, static_cast<const T*>(q), static_cast<const P*>(kp),
      static_cast<const P*>(vp), static_cast<const __half*>(sc.k),
      static_cast<const __half*>(sc.v), pt, pty, pn, part_o, part_ml, KVH, G, D, d_model,
      maxp, width, 1.f / sqrtf((float)D));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fused_combine_kernel<T><<<dim3(G, KVH, B), TILE_THREADS, 0, stream>>>(
      part_o, part_ml, static_cast<T*>(out), m_out, l_out, KVH, G, D, n_tiles);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* ap,
           const void* scale, const void* bias, const void* wk, const void* wv,
           const int* pt, const int* pty, const int* pn, void* out, float* m_out,
           float* l_out, void* scratch, int B, int KVH, int G, int D, int d_model,
           int maxp, int n_tiles, int layernorm, float eps, CUtensorMapDataType dt,
           cudaStream_t stream, Scales sc) {
#define FUSED_ARGS q, kp, vp, ap, scale, bias, wk, wv, pt, pty, pn, out, m_out, l_out, \
    scratch, B, KVH, G, D, d_model, maxp, n_tiles, layernorm, eps, dt, stream, sc
  const bool q8 = sc.k != nullptr;
  if (D <= 64)
    return q8 ? launch_fused<T, int8_t, 64>(FUSED_ARGS) : launch_fused<T, T, 64>(FUSED_ARGS);
  return q8 ? launch_fused<T, int8_t, 128>(FUSED_ARGS) : launch_fused<T, T, 128>(FUSED_ARGS);
#undef FUSED_ARGS
}

}  // namespace

extern "C" {

// norm_type: 0 layernorm (bias required), 1 rmsnorm (bias unused).
// dtype: 1 float16, 2 bfloat16.
// m_out, l_out: both null, or both (B, KVH, G, 1) float32 (return_lse mode).
// k_scales, v_scales, act_scales: all null, or all float16 with int8 pools
// (int8 mode).  D a multiple of 16 up to 128, d_model a multiple of 64;
// every pointer 16-byte aligned.  n_tiles: the table row's tiles of 4
// entries (n_tiles * 4 >= maxp, n_tiles <= 264).  scratch: at least
// fused_rows_offset(B, KVH, G, D, n_tiles) + B * n_tiles * 4 * 16 * d_model
// * 2 bytes (the partials, then the normed rows).  Launches the norm pass,
// the tile pass and the combine pass on `stream`.  Returns a cudaError_t.
int hybrid_paged_attention_fwd(const void* q, const void* k_pages, const void* v_pages,
                               const void* act_pages, const void* k_scales,
                               const void* v_scales, const void* act_scales,
                               const void* norm_scale, const void* norm_bias,
                               const void* wk, const void* wv, const void* page_table,
                               const void* page_type, const void* page_ntok, void* out,
                               void* m_out, void* l_out, void* scratch, int B, int KVH,
                               int G, int D, int d_model, int maxp, int n_tiles,
                               int norm_type, float eps, int dtype, void* stream) {
  const int n_scales = (k_scales != nullptr) + (v_scales != nullptr) +
                       (act_scales != nullptr);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k_pages) |
      reinterpret_cast<uintptr_t>(v_pages) | reinterpret_cast<uintptr_t>(act_pages) |
      reinterpret_cast<uintptr_t>(norm_scale) | reinterpret_cast<uintptr_t>(norm_bias) |
      reinterpret_cast<uintptr_t>(wk) | reinterpret_cast<uintptr_t>(wv) |
      reinterpret_cast<uintptr_t>(scratch);
  if (D > MAX_D_FUSED || D % 16 != 0 || D <= 0 || G > MAX_G || G < 1 ||
      d_model % KC != 0 || d_model <= 0 || n_tiles < 1 || n_tiles > MAX_SPLITS ||
      (long)n_tiles * TILE_PAGES < maxp || align % 16 != 0 ||
      (norm_type == 0 && norm_bias == nullptr) ||
      ((m_out == nullptr) != (l_out == nullptr)) || (n_scales != 0 && n_scales != 3))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return (int)cudaSuccess;
  const Scales sc{k_scales, v_scales, act_scales};
  float* mo = static_cast<float*>(m_out);
  float* lo = static_cast<float*>(l_out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pt = static_cast<const int*>(page_table);
  const int* pty = static_cast<const int*>(page_type);
  const int* pn = static_cast<const int*>(page_ntok);
  const int ln = norm_type == 0;
#define FUSED_ARGS q, k_pages, v_pages, act_pages, norm_scale, norm_bias, wk, wv, pt, pty, \
    pn, out, mo, lo, scratch, B, KVH, G, D, d_model, maxp, n_tiles, ln, eps
  switch (dtype) {
    case 1: return launch<__half>(FUSED_ARGS, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, st, sc);
    case 2: return launch<__nv_bfloat16>(FUSED_ARGS, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, st,
                                         sc);
  }
#undef FUSED_ARGS
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
