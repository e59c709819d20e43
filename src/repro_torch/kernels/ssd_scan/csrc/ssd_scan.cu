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
// s: rows past s are staged as zeros with dt = 0 (TMA fills them), so the
// state goes through them unchanged (the zero padding of the model's
// `ssd_chunked`), and their y is never written.  exp(cum_i - cum_j) is
// evaluated only where j <= i: above the diagonal it can overflow to inf.
//
// What bounds it on this card: at Mamba-2's prefill shape (P = 64, N = 128,
// chunk 64, 80 heads) a chunk does ~3.7 MFLOP per (request, head) against
// ~25 KB of its own inputs and outputs: bound by bytes (x read and y written
// once, B, C and dt once) at the tensor cores' rate.  The products carry
// float32 values, so each runs as two 16-bit or TF32 products (below).  What
// holds the kernel far above that bound is neither: per chunk the threads
// build the derived operands between block barriers, a latency-bound chain
// (on an H100, tensor pipe and shared memory well under half busy), so the
// design keeps that work small, balanced and overlapped with the products.
//
// Design.  Two kernels on the current stream:
//   - Gram pass, grid (n_chunks, b), one warpgroup: G = C_c B_c^T (64 x 64,
//     depth n) once per (request, chunk) for all heads (Mamba-2 has one
//     group of B/C), on wgmma m64n64k16 with both 16-bit operands staged by
//     TMA in the 128-byte swizzle; exact products, float32 sums.  G goes to
//     a float32 scratch in the scan pass's A-fragment order, so a thread
//     reads its 32 values as 8 coalesced 16-byte loads.
//   - Scan pass, grid (P / PS, h, b), one warpgroup (128 threads) per
//     (slice of PS columns of p, head, request).  The recurrence never mixes
//     rows p of the (P, N) state, so a block keeps its slice's state in
//     registers across the chunk loop, as wgmma accumulators of
//     S^T (n x PS: two m64 tiles); no per-chunk state goes to device memory.
//     PS = 32 at mamba2's P = 64: 640 blocks at b = 4 (4.8 per SM).  Per
//     chunk, with the rows i, j of the chunk and the state width n:
//       y_intra = (G . L . dt) x      M = chunk, N = PS, K = chunk
//       y_state = (C S^T) . exp(cum)  M = chunk, N = PS, K = n
//       S^T     = S^T exp(cum_last) + B^T (x . w)       (bfloat16)
//               = S^T exp(cum_last) + (B^T . w) x       (float16)
//                                     M = n (two tiles), N = PS, K = chunk
//     on wgmma m64nPS.  B and C arrive by TMA (128-byte swizzle), x in a
//     one-stage buffer refilled as soon as it is read, G and dt by register
//     prefetch: chunk c + 1 loads while chunk c computes.  The cumulative
//     sum of dt A is a warp scan (two rows a lane).  The bfloat16 pass holds
//     one stage of B and C (~66 KB: three blocks an SM), works out chunk
//     c + 1's cumulative sums while chunk c's products run, skips G . L . dt's
//     k-steps above the diagonal, and gives the warps with fewer of them more
//     of the x . w work; the float16 pass a two-stage ring (~112 KB, two).
//
// Numerics.  The Pallas body and the plain version compute in float32; x, B
// and C are 16-bit, exact in either product type.  The operands derived in
// float32 are split v = hi + lo and enter as two products (hi . b + lo . b)
// into one float32 accumulator.
//   - bfloat16 (mamba2's dtype): 16-bit products.  hi = bf16(v),
//     lo = bf16(v - hi): 16 significant bits, v - hi - lo within 2^-17 |v|,
//     float32's exponent, and half the tensor work of TF32.  C and B^T enter
//     as the TMA left them (A from the swizzled tiles; B^T through the
//     descriptor's transpose bit), the state and x . w as B operands the
//     threads write (K-major, no swizzle), G . L . dt from registers: only
//     the derived operands cost the threads work.
//   - float16: bfloat16 cannot hold float16's 11 significant bits, so the
//     products run in TF32 (10 mantissa bits, float32's exponent; exact for
//     float16): hi = cvt.rna.tf32(v), lo = cvt.rna.tf32(v - hi), within
//     2^-22 |v|.  TF32 takes no transpose bit and a 32-bit operand, so C and
//     B^T . w enter from registers, converted by the threads.
// The rounding points: G in float32 (exact products), each derived operand
// once in float32 before its split, the accumulators in float32, y rounded to
// x's dtype once; the state never leaves float32.  The final state's limit
// (2^-13 of its largest entry) holds with either split by orders of
// magnitude; without the lo terms it would not (chip_smoke.py reads that).
//
// `flags` (planted faults and diagnostics, 0 on the model's path): bit 0
// drops the lo terms; bit 1 hands chunk c the Gram of chunk c - 1.
#include <type_traits>

#include "../../hopper.cuh"

namespace {

constexpr int THREADS = 128;      // one warpgroup
constexpr int ROWS = 64;          // a chunk's tile, wgmma's M; chunk <= 64
constexpr int NMAX = 128;         // the state width computed (N <= 128; TMA zero-fills)
constexpr int BOX = ROWS * 128;   // one TMA box of B or C: 64 rows x 64 16-bit columns
constexpr int MAX_P = 64;

// the bfloat16 scan pass's dynamic shared memory at slice width PS: one
// stage of B and C, so that three blocks share an SM (~66 KB at 32)
template <int PS> struct Scan16 {
  // from offset 0: C's two 64-column halves, then B's (four TMA boxes)
  static constexpr int X_OFF = 4 * BOX;                      // x rows as loaded [ROWS][PS]
  static constexpr int XT_OFF = X_OFF + ROWS * PS * 2;       // x, K-major over rows
  static constexpr int XW_OFF = XT_OFF + PS * ROWS * 2;      // x . w hi, then lo, likewise
  static constexpr int S_OFF = XW_OFF + 2 * PS * ROWS * 2;   // the state's hi, then lo
  static constexpr int V_OFF = S_OFF + 2 * PS * NMAX * 2;    // 2 x per row: dt, cum, exp(cum), w
  static constexpr int BAR_OFF = V_OFF + 2 * 4 * ROWS * 4;   // barriers: B/C, x
  // + slack to align the base to the 1 KB swizzle atom
  static constexpr int SMEM = BAR_OFF + 2 * 8 + 1024;
};

// the float16 (TF32) scan pass's dynamic shared memory at slice width PS
template <int PS> struct Scan {
  static constexpr int BC_STAGE = 4 * BOX;               // C's two halves, then B's
  static constexpr int X_OFF = 2 * BC_STAGE;             // x rows as loaded [ROWS][PS]
  static constexpr int XT_OFF = X_OFF + ROWS * PS * 2;   // x in TF32, K-major over rows
  static constexpr int S_OFF = XT_OFF + PS * ROWS * 4;   // the state's hi, then its lo
  static constexpr int S_BYTES = PS * NMAX * 4;
  static constexpr int V_OFF = S_OFF + 2 * S_BYTES;      // per row: dt, cum, exp(cum), w
  static constexpr int BAR_OFF = V_OFF + 4 * ROWS * 4;
  // + three barriers, + slack to align the base to the 1 KB swizzle atom
  static constexpr int SMEM = BAR_OFF + 3 * 8 + 1024;
};
constexpr int GRAM_SMEM = 4 * BOX + 8 + 1024;

// element index of (row r, column k) in a K-major, unswizzled TF32 operand
// K columns wide: 8 x 4 core matrices of 128 bytes, LBO 128, SBO 32 K bytes
__device__ __forceinline__ int op_idx(int r, int k, int K) {
  return (r >> 3) * (K * 8) + (k >> 2) * 32 + (r & 7) * 4 + (k & 3);
}

// element (row, col < 64) of a 128-byte-swizzled TMA box of 16-bit values
template <typename T>
__device__ __forceinline__ float sw_el(const uint8_t* box, int row, int col) {
  const int byte = col * 2;
  return to_f(*reinterpret_cast<const T*>(
      box + row * 128 + ((((byte >> 4) ^ (row & 7))) << 4) + (byte & 15)));
}

// index of G[i][j] in the TF32 A-fragment order: thread (w, t) reads float4
// (w * 8 + k) * 32 + t of its 16-row band w, k-step k
__device__ __forceinline__ int gram_idx(int i, int j) {
  return ((((i >> 4) * 8 + (j >> 3)) * 32 + (i & 7) * 4 + (j & 3)) * 4) +
         ((i >> 3) & 1) + 2 * ((j >> 2) & 1);
}

// index of G[i][j] in the 16-bit A-fragment order: thread (w, t) reads
// floats ((w * 4 + k) * 32 + t) * 8 .. + 7 of its 16-row band w, k-step k:
// rows 16 w + t / 4 (+ 8), column pairs 16 k + 2 (t % 4) (+ 8)
__device__ __forceinline__ int gram16_idx(int i, int j) {
  return (((i >> 4) * 4 + (j >> 4)) * 32 + (i & 7) * 4 + ((j & 7) >> 1)) * 8 + (j & 1) +
         2 * ((i >> 3) & 1) + 4 * ((j >> 3) & 1);
}

// element index of (row r, column k) in a K-major, unswizzled 16-bit
// operand K columns wide: 8 x 8 core matrices of 128 bytes, LBO 128, SBO
// 16 K bytes
__device__ __forceinline__ int op16_idx(int r, int k, int K) {
  return (r >> 3) * (K * 8) + (k >> 3) * 64 + (r & 7) * 8 + (k & 7);
}

// (a, b) = hi + lo, each a bfloat16 pair (a in the low half)
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

template <int PS>
__device__ __forceinline__ void mma_kk(float (&d)[PS / 2], uint64_t da, uint64_t db,
                                       int acc) {
  if constexpr (PS == 32) wgmma_bf16_kk_n32(d, da, db, acc);
  else wgmma_bf16_kk_n16(d, da, db, acc);
}
template <int PS>
__device__ __forceinline__ void mma_mk(float (&d)[PS / 2], uint64_t da, uint64_t db,
                                       int acc) {
  if constexpr (PS == 32) wgmma_bf16_mk_n32(d, da, db, acc);
  else wgmma_bf16_mk_n16(d, da, db, acc);
}
template <int PS>
__device__ __forceinline__ void mma_rk(float (&d)[PS / 2], const uint32_t (&a)[4],
                                       uint64_t db, int acc) {
  if constexpr (PS == 32) wgmma_bf16_rk_n32(d, a, db, acc);
  else wgmma_bf16_rk_n16(d, a, db, acc);
}

template <int PS>
__device__ __forceinline__ void mma_tf32(float (&d)[PS / 2], const uint32_t (&a)[4],
                                         uint64_t db, int acc) {
  if constexpr (PS == 32) wgmma_tf32_n32(d, a, db, acc);
  else wgmma_tf32_n16(d, a, db, acc);
}

// v = hi + lo, each a TF32 bit pattern
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(v);
  lo = tf32_rna(v - __uint_as_float(hi));
}

// Gram pass.  Block (c, b): G = C B^T over rows c * chunk .. + 63 of request
// b (rows past s zero-filled; rows past the chunk are never read with a
// weight), written in the order the scan pass for T reads its A fragments.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_gram_kernel(const __grid_constant__ CUtensorMap tm_b,
                const __grid_constant__ CUtensorMap tm_c, float* __restrict__ gram,
                int chunk, int n_chunks) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 4 * BOX);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int c = blockIdx.x, b = blockIdx.y, t0 = c * chunk;
  if (tid == 0) {
    mbar_init(bar, 1);
    mbar_fence_init();
    mbar_expect_tx(bar, 4 * BOX);
    tma_load_3d(smem, &tm_c, bar, 0, t0, b);
    tma_load_3d(smem + BOX, &tm_c, bar, 64, t0, b);
    tma_load_3d(smem + 2 * BOX, &tm_b, bar, 0, t0, b);
    tma_load_3d(smem + 3 * BOX, &tm_b, bar, 64, t0, b);
  }
  __syncthreads();
  mbar_wait(bar, 0);
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  const uint32_t c_addr = smem_u32(smem), b_addr = c_addr + 2 * BOX;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < NMAX / 16; ++kk) {
    // a k-step is 32 bytes into a swizzle row; n 64.. in the second box
    const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
    wgmma_kk_n64(acc, desc_sw128(c_addr + off, 16, 1024),
                 desc_sw128(b_addr + off, 16, 1024), kk > 0, T{});
  }
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  float* dst = gram + ((long)b * n_chunks + c) * ROWS * ROWS;
#pragma unroll
  for (int jn = 0; jn < 8; ++jn)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 16 * warp + lane / 4 + 8 * (e >> 1);
      const int j = 8 * jn + 2 * (lane % 4) + (e & 1);
      if constexpr (std::is_same<T, __half>::value) dst[gram_idx(i, j)] = acc[4 * jn + e];
      else dst[gram16_idx(i, j)] = acc[4 * jn + e];
    }
}

// the four TMA boxes of chunk rows t0 .. t0 + 63: C's two column halves,
// then B's, into `st`, completion on `bar`
__device__ __forceinline__ void load_bc(uint8_t* st, uint64_t* bar, const CUtensorMap* tm_b,
                                        const CUtensorMap* tm_c, int t0, int b) {
  mbar_expect_tx(bar, 4 * BOX);
  tma_load_3d(st, tm_c, bar, 0, t0, b);
  tma_load_3d(st + BOX, tm_c, bar, 64, t0, b);
  tma_load_3d(st + 2 * BOX, tm_b, bar, 0, t0, b);
  tma_load_3d(st + 3 * BOX, tm_b, bar, 64, t0, b);
}

// rows 2 lane and 2 lane + 1 of chunk rows t0 ..'s dt; 0 past the chunk or
// past s
__device__ __forceinline__ float2 load_dt(const float* dt, int lane, int t0, int chunk, int S,
                                          int H, int b, int h) {
  float2 v;
  const int r = 2 * lane;
  v.x = r < chunk && t0 + r < S ? dt[((long)b * S + t0 + r) * H + h] : 0.f;
  v.y = r + 1 < chunk && t0 + r + 1 < S ? dt[((long)b * S + t0 + r + 1) * H + h] : 0.f;
  return v;
}

// warp 0, holding rows 2 lane and 2 lane + 1 of the chunk's dt: cum =
// cumsum(dt A) over the tile's 64 rows by a warp scan, and per row dt, cum,
// exp(cum) and w = exp(cum_last - cum) dt into shared memory
__device__ __forceinline__ void chunk_stats(float2 d, float* dts, float* cum, float* ecum,
                                            float* wgt, float a, int lane) {
  const float v0 = d.x * a, v1 = d.y * a;
  float s = v0 + v1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(0xffffffffu, s, o);
    if (lane >= o) s += u;
  }
  const float excl = __shfl_up_sync(0xffffffffu, s, 1);
  const float c0 = (lane ? excl : 0.f) + v0, c1 = c0 + v1;
  const float last = __shfl_sync(0xffffffffu, c1, 31);
  cum[2 * lane] = c0;
  cum[2 * lane + 1] = c1;
  ecum[2 * lane] = expf(c0);
  ecum[2 * lane + 1] = expf(c1);
  dts[2 * lane] = d.x;
  dts[2 * lane + 1] = d.y;
  wgt[2 * lane] = expf(last - c0) * d.x;
  wgt[2 * lane + 1] = expf(last - c1) * d.y;
}

// y = y_intra + exp(cum) y_state for the chunk's first `rows` rows, rounded
// to T once; `yrow` is row 0's first column of the slice, rows H * P apart
template <typename T, int PS>
__device__ __forceinline__ void store_y(T* yrow, long ld, const float (&yi)[PS / 2],
                                        const float (&ys)[PS / 2], const float* ecum,
                                        int rows, int warp, int lane) {
#pragma unroll
  for (int jj = 0; jj < PS / 8; ++jj)
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int i = 16 * warp + lane / 4 + 8 * rr;
      if (i >= rows) continue;
      const int e = 4 * jj + 2 * rr;
      const float ec = ecum[i];
      *reinterpret_cast<uint32_t*>(yrow + i * ld + 8 * jj + 2 * (lane % 4)) =
          pack2(yi[e] + ec * ys[e], yi[e + 1] + ec * ys[e + 1], T{});
    }
}

// the slice's final state (p, n) from the S^T accumulators
template <int PS>
__device__ __forceinline__ void store_state(float* so, const float (&st)[2][PS / 2], int N,
                                            int warp, int lane) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int jj = 0; jj < PS / 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = 64 * t + 16 * warp + lane / 4 + 8 * (e >> 1);
        const int p = 8 * jj + 2 * (lane % 4) + (e & 1);
        if (n < N) so[(long)p * N + n] = st[t][4 * jj + e];
      }
}

// where warp w's share of the x and x . w core matrices starts, in 32nds:
// 14, 11, 6 and 1 of them, against the 1, 2, 3 and 4 causal k-steps of
// G . L . dt it builds
__device__ __forceinline__ int x_share(int w) {
  return w == 0 ? 0 : w == 1 ? 14 : w == 2 ? 25 : w == 3 ? 31 : 32;
}

// Scan pass, bfloat16 (16-bit products).  Block (slice, h, b): columns
// slice * PS .. + PS - 1 of head h's x, y and state rows, request b.
template <int PS>
__global__ void __launch_bounds__(THREADS, 3)
ssd_scan_bf16_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_b,
                     const __grid_constant__ CUtensorMap tm_c, const float* __restrict__ gram,
                     const float* __restrict__ dt, const float* __restrict__ A,
                     __nv_bfloat16* __restrict__ y, float* __restrict__ state_out, int S,
                     int H, int P, int N, int chunk, int flags) {
  using T = __nv_bfloat16;
  using L = Scan16<PS>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const T* xraw = reinterpret_cast<const T*>(smem + L::X_OFF);
  T* xt = reinterpret_cast<T*>(smem + L::XT_OFF);
  T* xw_hi = reinterpret_cast<T*>(smem + L::XW_OFF);
  T* xw_lo = xw_hi + PS * ROWS;
  T* s_hi = reinterpret_cast<T*>(smem + L::S_OFF);
  T* s_lo = s_hi + PS * NMAX;
  float* stats = reinterpret_cast<float*>(smem + L::V_OFF);  // 2 x (dt, cum, exp(cum), w)
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);  // B/C, x

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int slice = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = (S + chunk - 1) / chunk;
  const float a = A[h];
  const bool lo_terms = (flags & 1) == 0;
  const uint32_t xt_addr = smem_u32(xt), xwh_addr = smem_u32(xw_hi),
                 xwl_addr = smem_u32(xw_lo), shi_addr = smem_u32(s_hi),
                 slo_addr = smem_u32(s_lo);

  auto load_x = [&](int c) {
    mbar_expect_tx(&bars[1], ROWS * PS * 2);
    tma_load_4d(smem + L::X_OFF, &tm_x, &bars[1], slice * PS, h, c * chunk, b);
  };
  float4 gf[8];                      // this thread's G fragments of a chunk
  auto load_g = [&](int c) {
    const int gc = (flags & 2) && c > 0 ? c - 1 : c;
    const float4* src = reinterpret_cast<const float4*>(
                            gram + ((long)b * n_chunks + gc) * ROWS * ROWS) +
                        (warp * 4 * 32 + lane) * 2;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      gf[2 * k] = __ldg(src + k * 64);
      gf[2 * k + 1] = __ldg(src + k * 64 + 1);
    }
  };

  if (tid == 0) {
    mbar_init(&bars[0], 1);
    mbar_init(&bars[1], 1);
    mbar_fence_init();
    load_x(0);
    load_bc(smem, &bars[0], &tm_b, &tm_c, 0, b);
  }
  float st[2][PS / 2];               // S^T (n x PS): tile t holds n in [64 t, 64 t + 64)
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < PS / 2; ++e) st[t][e] = 0.f;
  load_g(0);
  // warp 0: chunk c's dt, its cumulative sum times A, exp(cum) and w into
  // stats buffer c % 2, chunk c + 1's dt prefetched
  float2 dtv = load_dt(dt, lane, 0, chunk, S, H, b, h);
  auto next_stats = [&](int c) {
    float* sb = stats + (c % 2) * 4 * ROWS;
    chunk_stats(dtv, sb, sb + ROWS, sb + 2 * ROWS, sb + 3 * ROWS, a, lane);
    if (c + 1 < n_chunks) dtv = load_dt(dt, lane, (c + 1) * chunk, chunk, S, H, b, h);
  };
  if (warp == 0) next_stats(0);
  __syncthreads();

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * chunk, rows = min(chunk, S - t0);
    const float* dts = stats + (c % 2) * 4 * ROWS;
    const float* cum = dts + ROWS;
    const float* ecum = cum + ROWS;
    const float* wgt = ecum + ROWS;

    // 1. A fragments of y_intra: G . L . dt split into hi + lo, from the
    //    prefetched G (pairs r, r + 1 of a k-step: rows g, g + 8, columns
    //    2 q, 2 q + 8, as a0..a3 hold them).  Causal: warp w's rows meet
    //    k-steps 0..w only; the others stay zero
    uint32_t mh[4][4], ml[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k > warp) {
#pragma unroll
        for (int r = 0; r < 4; ++r) mh[k][r] = ml[k][r] = 0u;
        continue;
      }
      const float gv[8] = {gf[2 * k].x,     gf[2 * k].y,     gf[2 * k].z,     gf[2 * k].w,
                           gf[2 * k + 1].x, gf[2 * k + 1].y, gf[2 * k + 1].z, gf[2 * k + 1].w};
      float m[8];
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = 16 * warp + g + 8 * ((r >> 1) & 1);
        const int j = 16 * k + 2 * q + (r & 1) + 8 * (r >> 2);
        m[r] = j <= i ? gv[r] * __expf(cum[i] - cum[j]) * dts[j] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) split2(m[2 * r], m[2 * r + 1], mh[k][r], ml[k][r]);
    }

    // 2. the B operands, K-major over their K: x (exact) and x . w split into
    //    hi + lo over the chunk's rows (8 x 8 core matrices, a lane one row
    //    and a pair of columns; warp w takes x_share's part of them, less
    //    where step 1 gave it more k-steps), the carried state split into
    //    hi + lo over n
    mbar_wait(&bars[1], c & 1);
    constexpr int NCORE = (PS / 8) * (ROWS / 8);
    for (int cm = NCORE * x_share(warp) / 32; cm < NCORE * x_share(warp + 1) / 32; ++cm) {
      const int p = 8 * (cm % (PS / 8)) + g, j = 8 * (cm / (PS / 8)) + 2 * q;
      const float x0 = to_f(xraw[j * PS + p]), x1 = to_f(xraw[(j + 1) * PS + p]);
      const int ix = op16_idx(p, j, ROWS);
      uint32_t hi, lo;
      split2(x0 * wgt[j], x1 * wgt[j + 1], hi, lo);
      *reinterpret_cast<uint32_t*>(xt + ix) = pack2(x0, x1, T{});
      *reinterpret_cast<uint32_t*>(xw_hi + ix) = hi;
      *reinterpret_cast<uint32_t*>(xw_lo + ix) = lo;
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int jj = 0; jj < PS / 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 64 * t + 16 * warp + g + 8 * (e >> 1);
          const int ix = op16_idx(8 * jj + 2 * q + (e & 1), n, NMAX);
          const float v = st[t][4 * jj + e];
          const T hv = from_f<T>(v);
          s_hi[ix] = hv;
          s_lo[ix] = from_f<T>(v - to_f(hv));
        }
    fence_proxy_async();
    __syncthreads();                 // operands written, x read
    if (tid == 0 && c + 1 < n_chunks) load_x(c + 1);

    // 3. y_state = C S^T, y_intra = (G . L . dt) x, and
    //    S^T = S^T exp(cum_last) + B^T (x . w), all issued before one wait
    mbar_wait(&bars[0], c & 1);
    const uint32_t c_addr = smem_u32(smem);
    const uint32_t b_addr = c_addr + 2 * BOX;
    const float decay = ecum[ROWS - 1];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < PS / 2; ++e) st[t][e] *= decay;
    float ys[PS / 2], yi[PS / 2];
#pragma unroll
    for (int e = 0; e < PS / 2; ++e) ys[e] = yi[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < NMAX / 16; ++k) {
      // C: a k-step is 32 bytes into a swizzle row; n 64.. in the second box
      const uint64_t dc = desc_sw128(c_addr + (k / 4) * BOX + (k % 4) * 32, 16, 1024);
      mma_kk<PS>(ys, dc, desc_plain(shi_addr + k * 256, 128, 16 * NMAX), k > 0);
      if (lo_terms) mma_kk<PS>(ys, dc, desc_plain(slo_addr + k * 256, 128, 16 * NMAX), 1);
    }
#pragma unroll
    for (int k = 0; k < ROWS / 16; ++k) {
      const uint64_t dx = desc_plain(xt_addr + k * 256, 128, 16 * ROWS);
      mma_rk<PS>(yi, mh[k], dx, k > 0);
      if (lo_terms) mma_rk<PS>(yi, ml[k], dx, 1);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int k = 0; k < ROWS / 16; ++k) {
        // B^T: MN-major, 16 rows of the chunk a k-step
        const uint64_t db = desc_sw128(b_addr + t * BOX + k * 2048, BOX, 1024);
        mma_mk<PS>(st[t], db, desc_plain(xwh_addr + k * 256, 128, 16 * ROWS), 1);
        if (lo_terms)
          mma_mk<PS>(st[t], db, desc_plain(xwl_addr + k * 256, 128, 16 * ROWS), 1);
      }
    wgmma_commit();
    if (c + 1 < n_chunks) {                // in flight during the products
      load_g(c + 1);
      if (warp == 0) next_stats(c + 1);
    }
    wgmma_wait<0>();
    fence_regs(ys);
    fence_regs(yi);
    fence_regs(st[0]);
    fence_regs(st[1]);

    // 4. y
    store_y<T, PS>(y + (((long)b * S + t0) * H + h) * P + slice * PS, (long)H * P, yi, ys,
                   ecum, rows, warp, lane);
    __syncthreads();                 // every warp is done with B and C, stats ready
    if (tid == 0 && c + 1 < n_chunks) load_bc(smem, &bars[0], &tm_b, &tm_c, t0 + chunk, b);
  }
  store_state<PS>(state_out + ((long)b * H + h) * P * N + (long)slice * PS * N, st, N, warp,
                  lane);
}

// Scan pass, float16 (TF32 products).  Block (slice, h, b): columns
// slice * PS .. + PS - 1 of head h's x, y and state rows, request b.
template <int PS>
__global__ void __launch_bounds__(THREADS, 2)
ssd_scan_tf32_kernel(const __grid_constant__ CUtensorMap tm_x,
                const __grid_constant__ CUtensorMap tm_b,
                const __grid_constant__ CUtensorMap tm_c, const float* __restrict__ gram,
                const float* __restrict__ dt, const float* __restrict__ A,
                __half* __restrict__ y, float* __restrict__ state_out, int S, int H, int P,
                int N, int chunk, int flags) {
  using T = __half;
  using L = Scan<PS>;
  constexpr int NJ = PS / 8;         // accumulator column groups
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const T* xraw = reinterpret_cast<const T*>(smem + L::X_OFF);
  float* xT = reinterpret_cast<float*>(smem + L::XT_OFF);
  uint32_t* s_hi = reinterpret_cast<uint32_t*>(smem + L::S_OFF);
  uint32_t* s_lo = s_hi + L::S_BYTES / 4;
  float* dts = reinterpret_cast<float*>(smem + L::V_OFF);
  float* cum = dts + ROWS;
  float* ecum = cum + ROWS;
  float* wgt = ecum + ROWS;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);  // B/C x 2, x

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int slice = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int n_chunks = (S + chunk - 1) / chunk;
  const float a = A[h];
  const bool lo_terms = (flags & 1) == 0;
  const uint32_t xT_addr = smem_u32(xT), shi_addr = smem_u32(s_hi),
                 slo_addr = smem_u32(s_lo);

  auto load_x = [&](int c) {
    mbar_expect_tx(&bars[2], ROWS * PS * 2);
    tma_load_4d(smem + L::X_OFF, &tm_x, &bars[2], slice * PS, h, c * chunk, b);
  };
  float4 gf[8];                      // this thread's G fragments of a chunk
  auto load_g = [&](int c) {
    const int gc = (flags & 2) && c > 0 ? c - 1 : c;
    const float4* src = reinterpret_cast<const float4*>(
                            gram + ((long)b * n_chunks + gc) * ROWS * ROWS) +
                        warp * 8 * 32 + lane;
#pragma unroll
    for (int k = 0; k < 8; ++k) gf[k] = __ldg(src + k * 32);
  };

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
    load_x(0);
    load_bc(smem, &bars[0], &tm_b, &tm_c, 0, b);
    if (n_chunks > 1) load_bc(smem + L::BC_STAGE, &bars[1], &tm_b, &tm_c, chunk, b);
  }
  float st[2][PS / 2];               // S^T (n x PS): tile t holds n in [64 t, 64 t + 64)
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < PS / 2; ++e) st[t][e] = 0.f;
  load_g(0);
  float2 dtv = load_dt(dt, lane, 0, chunk, S, H, b, h);       // warp 0's

  for (int c = 0; c < n_chunks; ++c) {
    const int t0 = c * chunk, rows = min(chunk, S - t0);

    // 1. dt, its cumulative sum times A, exp(cum) and w (warp 0)
    if (warp == 0) {
      chunk_stats(dtv, dts, cum, ecum, wgt, a, lane);
      if (c + 1 < n_chunks) dtv = load_dt(dt, lane, t0 + chunk, chunk, S, H, b, h);
    }
    __syncthreads();

    // 2. x in TF32 (exact), K-major over the rows; the carried state split
    //    into hi + lo, K-major over n: wgmma's B operands
    mbar_wait(&bars[2], c & 1);
    for (int e = tid; e < ROWS * PS; e += THREADS)
      xT[op_idx(e % PS, e / PS, ROWS)] = to_f(xraw[e]);
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int jj = 0; jj < NJ; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 64 * t + 16 * warp + g + 8 * (e >> 1);
          const int p = 8 * jj + 2 * q + (e & 1);
          const int ix = op_idx(p, n, NMAX);
          split(st[t][4 * jj + e], s_hi[ix], s_lo[ix]);
        }
    fence_proxy_async();
    __syncthreads();                 // operands written, x read
    if (tid == 0 && c + 1 < n_chunks) load_x(c + 1);

    // 3. A fragments: G . L . dt split into hi + lo, from the prefetched G
    uint32_t mh[8][4], ml[8][4];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float gv[4] = {gf[k].x, gf[k].y, gf[k].z, gf[k].w};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 16 * warp + g + 8 * (r & 1), j = 8 * k + q + 4 * (r >> 1);
        const float v = j <= i ? gv[r] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        split(v, mh[k][r], ml[k][r]);
      }
    }
    mbar_wait(&bars[c % 2], (c / 2) & 1);
    const uint8_t* cs = smem + (c % 2) * L::BC_STAGE;
    const uint8_t* bs = cs + 2 * BOX;
    uint32_t ca[NMAX / 8][4];          // C, exact in TF32
#pragma unroll
    for (int k = 0; k < NMAX / 8; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 16 * warp + g + 8 * (r & 1), n = 8 * k + q + 4 * (r >> 1);
        ca[k][r] = __float_as_uint(sw_el<T>(cs + (n / 64) * BOX, i, n % 64));
      }

    // 4. y_state = C S^T and y_intra = (G . L . dt) x
    float ys[PS / 2], yi[PS / 2];
#pragma unroll
    for (int e = 0; e < PS / 2; ++e) ys[e] = yi[e] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < NMAX / 8; ++k) {
      mma_tf32<PS>(ys, ca[k], desc_plain(shi_addr + k * 256, 128, 32 * NMAX), k > 0);
      if (lo_terms)
        mma_tf32<PS>(ys, ca[k], desc_plain(slo_addr + k * 256, 128, 32 * NMAX), 1);
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint64_t dx = desc_plain(xT_addr + k * 256, 128, 32 * ROWS);
      mma_tf32<PS>(yi, mh[k], dx, k > 0);
      if (lo_terms) mma_tf32<PS>(yi, ml[k], dx, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(ys);
    fence_regs(yi);
    if (c + 1 < n_chunks) load_g(c + 1);   // in flight during steps 5 and 6

    // 5. y
    store_y<T, PS>(y + (((long)b * S + t0) * H + h) * P + slice * PS, (long)H * P, yi, ys,
                   ecum, rows, warp, lane);

    // 6. S^T = S^T exp(cum_last) + (B^T . w) x, B^T . w split into hi + lo
    const float decay = ecum[ROWS - 1];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      uint32_t bh[8][4], bl[8][4];
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = 16 * warp + g + 8 * (r & 1), j = 8 * k + q + 4 * (r >> 1);
          split(sw_el<T>(bs + t * BOX, j, n) * wgt[j], bh[k][r], bl[k][r]);
        }
#pragma unroll
      for (int e = 0; e < PS / 2; ++e) st[t][e] *= decay;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const uint64_t dx = desc_plain(xT_addr + k * 256, 128, 32 * ROWS);
        mma_tf32<PS>(st[t], bh[k], dx, 1);
        if (lo_terms) mma_tf32<PS>(st[t], bl[k], dx, 1);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
    fence_regs(st[0]);
    fence_regs(st[1]);
    __syncthreads();                 // every warp is done with this stage
    if (tid == 0 && c + 2 < n_chunks)
      load_bc(smem + (c % 2) * L::BC_STAGE, &bars[c % 2], &tm_b, &tm_c, (c + 2) * chunk, b);
  }

  store_state<PS>(state_out + ((long)b * H + h) * P * N + (long)slice * PS * N, st, N, warp,
                  lane);
}

// set a kernel's dynamic shared memory (and the carveout that lets two
// blocks share an SM) once
template <typename K>
cudaError_t prepare(K kernel, int smem) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

template <typename T, int PS>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           void* y, void* state, void* gram, int batch, int S, int H, int P, int N,
           int chunk, long long sxb, long long sxs, long long sbb, long long sbs,
           long long scb, long long scs, CUtensorMapDataType dtype, int flags,
           cudaStream_t stream) {
  constexpr bool BF16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int SMEM = BF16 ? Scan16<PS>::SMEM : Scan<PS>::SMEM;
  static bool attr = false;
  if (!attr) {
    cudaError_t err;
    if constexpr (BF16) err = prepare(ssd_scan_bf16_kernel<PS>, SMEM);
    else err = prepare(ssd_scan_tf32_kernel<PS>, SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_gram_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, GRAM_SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  // x as (P, H, S, b) in boxes of one slice of one head by 64 rows; B and C
  // as (N, S, b) in swizzled 64 x 64 boxes.  Strides in bytes; a batch of
  // one never steps its batch stride
  const cuuint64_t x_dims[4] = {(cuuint64_t)P, (cuuint64_t)H, (cuuint64_t)S,
                                (cuuint64_t)batch};
  const cuuint64_t x_str[3] = {(cuuint64_t)P * 2, (cuuint64_t)sxs * 2,
                               (cuuint64_t)(batch > 1 ? sxb : S * sxs) * 2};
  const cuuint32_t x_box[4] = {PS, 1, ROWS, 1};
  const cuuint64_t n_dims[3] = {(cuuint64_t)N, (cuuint64_t)S, (cuuint64_t)batch};
  const cuuint64_t b_str[2] = {(cuuint64_t)sbs * 2,
                               (cuuint64_t)(batch > 1 ? sbb : S * sbs) * 2};
  const cuuint64_t c_str[2] = {(cuuint64_t)scs * 2,
                               (cuuint64_t)(batch > 1 ? scb : S * scs) * 2};
  const cuuint32_t n_box[3] = {64, ROWS, 1};
  CUtensorMap tx, tb, tc;
  if (!make_map(&tx, x, dtype, 4, x_dims, x_str, x_box, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !make_map(&tb, Bm, dtype, 3, n_dims, b_str, n_box) ||
      !make_map(&tc, Cm, dtype, 3, n_dims, c_str, n_box))
    return (int)cudaErrorInvalidValue;
  const int n_chunks = (S + chunk - 1) / chunk;
  float* g = static_cast<float*>(gram);
  ssd_gram_kernel<T><<<dim3(n_chunks, batch), THREADS, GRAM_SMEM, stream>>>(
      tb, tc, g, chunk, n_chunks);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(P / PS, H, batch);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  float* so = static_cast<float*>(state);
  if constexpr (BF16)
    ssd_scan_bf16_kernel<PS><<<grid, THREADS, SMEM, stream>>>(
        tx, tb, tc, g, dtf, af, static_cast<T*>(y), so, S, H, P, N, chunk, flags);
  else
    ssd_scan_tf32_kernel<PS><<<grid, THREADS, SMEM, stream>>>(
        tx, tb, tc, g, dtf, af, static_cast<T*>(y), so, S, H, P, N, chunk, flags);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_ps(const void* x, const void* dt, const void* A, const void* Bm,
              const void* Cm, void* y, void* state, void* gram, int batch, int S, int H,
              int P, int N, int chunk, long long sxb, long long sxs, long long sbb,
              long long sbs, long long scb, long long scs, CUtensorMapDataType dtype,
              int flags, cudaStream_t stream) {
  if (P % 32 == 0)
    return launch<T, 32>(x, dt, A, Bm, Cm, y, state, gram, batch, S, H, P, N, chunk,
                         sxb, sxs, sbb, sbs, scb, scs, dtype, flags, stream);
  return launch<T, 16>(x, dt, A, Bm, Cm, y, state, gram, batch, S, H, P, N, chunk, sxb,
                       sxs, sbb, sbs, scb, scs, dtype, flags, stream);
}

}  // namespace

extern "C" {

// x (batch, S, H, P) read through its batch and row strides (sxb, sxs; heads
// P apart, elements adjacent), dt (batch, S, H) float32 and A (H,) float32
// contiguous, B and C (batch, S, N) through their batch and row strides; y
// (batch, S, H, P) and state (batch, H, P, N) float32 contiguous.  gram: a
// float32 scratch of batch * ceil(S / chunk) * 64 * 64 values.  chunk, P and
// N multiples of 16 up to 64, 64 and 128; x, B and C 16-byte aligned with
// strides of multiples of 8 elements (TMA).  dtype (of x, B, C and y):
// 1 float16, 2 bfloat16.  flags: 0, or the planted faults in the header.
// Launches the Gram pass and the scan pass on `stream`.  Returns a
// cudaError_t.
int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, void* y, void* state, void* gram, int batch, int S,
                 int H, int P, int N, int chunk, long long sxb, long long sxs,
                 long long sbb, long long sbs, long long scb, long long scs, int dtype,
                 int flags, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(Bm) |
                          reinterpret_cast<uintptr_t>(Cm) |
                          reinterpret_cast<uintptr_t>(gram);
  const long long strides = (batch > 1 ? sxb | sbb | scb : 0) | sxs | sbs | scs;
  if (batch <= 0 || S <= 0 || H <= 0 || chunk <= 0 || chunk > ROWS ||
      chunk % 16 != 0 || P <= 0 || P > MAX_P || P % 16 != 0 || N <= 0 ||
      N > NMAX || N % 16 != 0 || align % 16 != 0 || strides % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SCAN_ARGS x, dt, A, Bm, Cm, y, state, gram, batch, S, H, P, N, chunk, sxb, sxs, \
    sbb, sbs, scb, scs
  switch (dtype) {
    case 1: return launch_ps<__half>(SCAN_ARGS, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, flags, st);
    case 2: return launch_ps<__nv_bfloat16>(SCAN_ARGS, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                            flags, st);
  }
#undef SCAN_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// the backward (the training path's gradient), in the same library
#include "ssd_scan_bwd.cuh"
