// GQA flash-attention backward for Hopper (sm_90a): dQ, dK and dV, in the
// forward's three modes (causal, sliding window, non-causal with keys of
// their own length).
//
// Replaces no Pallas kernel.  The JAX package's attention gradient is the
// custom VJP of `blockwise_attention` (`_bw_attn_b` -> `_bw_attn_bwd_impl`,
// src/repro/models/layers.py:205-311), which XLA compiles; this kernel is
// its counterpart for the port's training forward, which runs the flash
// kernel (flash_attention.cu) with its lse output: lse = m + log l per
// query row, in float32.
//
// What it computes, per request b and query head h (kv head h / G):
//   P = exp(Q.K^T / sqrt(D) - lse) under the mask of `_tile_mask`
//       (src/repro/models/layers.py:115-123): causal, key j <= query i, and
//       with a window W > 0 also j > i - W; non-causal, every key j < Sk,
//   dV = sum over the group's heads of P^T.dO,
//   dP = dO.V^T, Delta_i = rowsum(dO_i * O_i),
//   dS = P * (dP - Delta) / sqrt(D),
//   dQ = dS.K, dK = sum over the group's heads of dS^T.Q,
// with q, dO, o (B, Sq, H, D), k, v (B, Sk, KVH, D) read in place and lse
// (B, H, Sq).  That is the reference's backward without the softcap (no
// model the port trains has one).  D is 64, 128 or 256.
//
// What bounds it on this card: five products of (live pairs) x D per head
// (the recomputed scores, dV, dP, dQ, dK) against reading q, k, v, o, dO and
// lse once and writing dq, dk, dv once: at the training shapes (S = 512 to
// 1500) a few hundred operations per byte, at or above the H100's ~295, so
// the tensor cores' rate (989 TFLOP/s in 16 bits) is the bound, and only
// `wgmma` approaches it.
//
// The design (the forward's wgmma + TMA shape, FlashAttention-3's order):
//   - a pre-pass (one warp per (b, i, h) row) takes Delta in float32 and
//     zeroes the row's float32 dQ accumulator;
//   - the main pass runs one block per (query head, request, 64-key tile),
//     the key tile slowest, so the causal grid starts with its longest
//     blocks.  Each block takes one query head: the group's G heads are G
//     blocks, not a serial walk, so a grid of few kv heads still fills the
//     card (the 6.9x-SDPA shape of the first design had 52 blocks; 208 now).
//     384 threads: a producer warpgroup and two consumer warpgroups that
//     split the work by product, not by column:
//       WG0: S^T = K.Q^T, P^T = exp(S^T / sqrt(D) - lse) under the mask,
//            dV += P^T.dO (P^T rounded to the input dtype, the A operand
//            from registers);
//       WG1: dP^T = V.dO^T, dS^T = P^T (dP^T - Delta) / sqrt(D), with P^T
//            handed over in float32 through shared memory in the
//            accumulator's fragment order, dK += dS^T.Q (dS^T rounded, A
//            from registers), and dS^T into shared memory (128-byte
//            swizzle) for dQ;
//       both: dQ (BQ x D) = dS.K, read as MN-major operands from the same
//            two tiles (the descriptors' transpose bits), each warpgroup
//            64 rows (D <= 128) or half the columns (D = 256), staged as
//            float32 boxes (128-byte swizzle) over the stage's dO (WG0)
//            or Q (WG1) and added into the float32 accumulator by TMA
//            reduce-add, as FlashAttention-3 does; each warpgroup's first
//            thread releases the stage to the producer once its add has
//            read it, under the next tile's first products.  A
//            fixed-order dQ would take a second pass recomputing S and dP
//            (7 products instead of 5); dQ is the one output that depends
//            on the order of the adds.
//     S^T and dP^T are each computed once per tile at every D, so D = 256
//     does no recomputation (its dK and dV are 128 accumulator registers a
//     thread, one accumulator per warpgroup).  Named barriers order the
//     two hand-overs (P^T, dS^T) and the reuse of their buffers.
//   - the producer's first warp loads K and V once and each tile's Q and dO
//     by TMA (4-D maps over (D, heads, S, B): a ragged tile zero-fills), and
//     its lse and Delta with plain loads, into a ring of two stages on
//     mbarriers, so the next tile loads under the current one's products.
//     Query tiles of BQ = 128 rows (64 at D = 256); causal, only those at or
//     after the block's first key, and with a window only those before its
//     last key + W (the TPU kernel's tile skip).
//   - every product is wgmma m64n64k16 (a row of them for a wider N), 16-bit
//     inputs, float32 accumulators;
//   - dK and dV: with G = 1 the block writes them rounded to the input
//     dtype; with G > 1 each block writes its head's float32 partials to a
//     scratch (2, B, Sk, H, D), and the last pass sums the group's G heads
//     in head order (deterministic) and rounds them; the same pass rounds dQ.
// The roundings against the float32 plain version are the first design's:
// P and dS in 16 bits before their products, as the forward rounds P.
//
// One C call launches the three passes on the caller's stream.
//
// Included at the end of flash_attention.cu: one library holds the forward
// and its gradient; the Hopper helpers come from kernels/hopper.cuh.
// Everything here sits in the namespace `bwd` inside an anonymous namespace.
#pragma once

namespace {
namespace bwd {

constexpr int BKV = 64;               // keys per block: one m64 tile
constexpr int CONSUMERS = 256;        // WG0 (P^T, dV) and WG1 (dS^T, dK)
constexpr int THREADS = CONSUMERS + 128;   // and the producer warpgroup
// registers a thread keeps after setmaxnreg, as in the forward:
// 128 x 40 + 256 x 232 = 64,512 of 65,536
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int STAGES = 2;
constexpr int ROWB = 128;             // one swizzled row: 64 16-bit values
constexpr float LOG2E = 1.4426950408889634f;
// named barriers of the two consumer warpgroups (0 is __syncthreads)
constexpr int BAR_P_FULL = 1, BAR_P_EMPTY = 2, BAR_DS_FULL = 3, BAR_DS_EMPTY = 4;
// planted faults (flags; 0 on every model path): the causal mask left out
// (every query tile, every key), dK/dV not summed over the group (only the
// group's last head survives), the window left out (the mask and the tile
// skip: the causal gradient), and the keys cut at Sq (those past the
// queries' length take no part)
constexpr int FAULT_NO_CAUSAL = 1;
constexpr int FAULT_NO_GROUP_SUM = 2;
constexpr int FAULT_NO_WINDOW = 4;
constexpr int FAULT_SK_AS_SQ = 8;
// a diagnostic (read, never on a path): the main pass adds no dQ
constexpr int DIAG_NO_DQ_ADD = 16;

// the shared-memory plan at head width D, offsets from a 1 KB-aligned base
template <int D>
struct Cfg {
  static constexpr int BQ = D == 256 ? 64 : 128;   // queries per tile
  static constexpr int NB = D / 64;                // 64-column blocks of D
  static constexpr int QB = BQ / 64;               // 64-query blocks of a tile
  static constexpr int KV_BYTES = NB * BKV * ROWB;  // K or V: NB blocks of 64 rows
  static constexpr int QT_BYTES = NB * BQ * ROWB;   // one stage of Q or dO
  static constexpr int K_OFF = 0;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;                   // [STAGES]
  static constexpr int DO_OFF = Q_OFF + STAGES * QT_BYTES;     // [STAGES]
  static constexpr int DS_OFF = DO_OFF + STAGES * QT_BYTES;    // dS^T: QB blocks [64 keys][64 q]
  static constexpr int P_OFF = DS_OFF + QB * BKV * ROWB;       // P^T float32, fragment order
  static constexpr int ST_OFF = P_OFF + BKV * BQ * 4;          // [STAGES]: lse (log2), Delta
  static constexpr int BAR_OFF = ST_OFF + STAGES * 2 * BQ * 4;
  static constexpr int SMEM = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
  // dQ per consumer warpgroup: its 64 rows and every column (D <= 128), or
  // the tile's 64 rows and half the columns (D = 256)
  static constexpr int DQ_NB = D == 256 ? 2 : NB;
};

// the forward's wgmma helpers at a width N: S^T or dP^T (both operands
// K-major from shared memory), and dV or dK (A from registers, B MN-major)
template <typename T, int N>
__device__ __forceinline__ void mma_kk(float (&d)[N / 2], uint64_t da, uint64_t db, int acc) {
  if constexpr (N == 128) wgmma_ss_n128(d, da, db, acc, T{});
  else wgmma_ss_n64(d, da, db, acc, T{});
}
template <typename T, int N>
__device__ __forceinline__ void mma_rt(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (N == 256) wgmma_rs_n256(d, a, db, T{});
  else if constexpr (N == 128) wgmma_rs_n128(d, a, db, T{});
  else wgmma_rs_n64(d, a, db, T{});
}

// Delta_i = rowsum(dO_i * O_i) per (b, i, h) row, one warp each, written
// (B, H, Sq); the row's float32 dQ accumulator zeroed
template <typename T>
__global__ void flash_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                                       float* __restrict__ delta,
                                       float* __restrict__ dq_acc, long rows, int Sq,
                                       int H, int D) {
  const long row = (blockIdx.x * (long)blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const long base = row * D;
  float s = 0.f;
  for (int d = lane; d < D; d += 32) {
    s += to_f(o[base + d]) * to_f(dout[base + d]);
    dq_acc[base + d] = 0.f;
  }
  s = warp_sum(s);
  if (lane == 0) {
    const int h = row % H;
    const long bi = row / H;
    delta[(bi / Sq * H + h) * Sq + bi % Sq] = s;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ CUtensorMap tm_dq, const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                 float* __restrict__ kv_part,
                 int Sq, int Sk, int H, int KVH, int window, int causal_in, float scale,
                 int flags) {
  using C = Cfg<D>;
  constexpr int BQ = C::BQ, NB = C::NB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + C::BAR_OFF);
  uint64_t* kv_full = bars;
  uint64_t* full = bars + 1;                     // [STAGES]
  uint64_t* empty = bars + 1 + STAGES;           // [STAGES]

  const int h = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * BKV;
  const int G = H / KVH, kvh = h / G;
  const bool causal = causal_in && !(flags & FAULT_NO_CAUSAL);
  const int W = (flags & FAULT_NO_WINDOW) ? 0 : window;
  // the keys that take part: all Sk, or under the fault those below Sq
  const int n_keys = (flags & FAULT_SK_AS_SQ) ? min(Sq, Sk) : Sk;
  // the query tiles that see any of the block's keys: causal, from the one
  // holding its first key, and with a window, before its last key + W
  const int q_lo = causal ? k0 / BQ * BQ : 0;
  const int q_hi = causal && W > 0 ? min(Sq, k0 + BKV - 1 + W) : Sq;
  const int n_tiles = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1 + 32);               // the TMA's bytes, the warp's loads
      mbar_init(&empty[s], 2);                   // each warpgroup's dQ add has read it
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {                // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int lane = threadIdx.x - CONSUMERS;
    if (lane >= 32) return;                      // one warp loads
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * C::KV_BYTES);
      for (int nb = 0; nb < NB; ++nb) {
        tma_load_4d(smem + C::K_OFF + nb * BKV * ROWB, &tm_k, kv_full, nb * 64, kvh, k0, b);
        tma_load_4d(smem + C::V_OFF + nb * BKV * ROWB, &tm_v, kv_full, nb * 64, kvh, k0, b);
      }
    }
    const float* lse_bh = lse + ((long)b * H + h) * Sq;
    const float* dl_bh = delta + ((long)b * H + h) * Sq;
    for (int it = 0; it < n_tiles; ++it) {
      const int st = it % STAGES, q0 = q_lo + it * BQ;
      if (it >= STAGES) mbar_wait(&empty[st], (it / STAGES - 1) & 1);
      if (lane == 0) {
        mbar_expect_tx(&full[st], 2 * C::QT_BYTES);
        for (int nb = 0; nb < NB; ++nb) {
          const int off = st * C::QT_BYTES + nb * BQ * ROWB;
          tma_load_4d(smem + C::Q_OFF + off, &tm_q, &full[st], nb * 64, h, q0, b);
          tma_load_4d(smem + C::DO_OFF + off, &tm_do, &full[st], nb * 64, h, q0, b);
        }
      }
      float* stl = reinterpret_cast<float*>(smem + C::ST_OFF) + st * 2 * BQ;
      for (int c = lane; c < BQ; c += 32) {
        const bool live = q0 + c < Sq;
        stl[c] = live ? lse_bh[q0 + c] * LOG2E : 0.f;
        stl[BQ + c] = live ? dl_bh[q0 + c] : 0.f;
      }
      mbar_arrive(&full[st]);
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  // consumer warpgroup wg, thread t: in an m64 accumulator fragment it holds
  // rows 16 wl + g (entries i with i % 4 < 2) and + 8, columns
  // 8 (i / 4) + 2 q4 + i % 2
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int wl = t / 32, lane = t % 32, g = lane / 4, q4 = lane % 4;
  const uint32_t k_addr = smem_u32(smem + C::K_OFF), v_addr = smem_u32(smem + C::V_OFF);
  const uint32_t ds_addr = smem_u32(smem + C::DS_OFF);
  uint8_t* ds_s = smem + C::DS_OFF;
  float* pbuf = reinterpret_cast<float*>(smem + C::P_OFF);
  const float scale_log2 = scale * LOG2E;

  // accumulator fragments of an m64 tile, entry e: row 16 wl + g (+ 8 for
  // e % 4 >= 2), column 8 (e / 4) + 2 q4 + e % 2
  float acc[D / 2];                              // WG0: dV, WG1: dK (64 keys x D)
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;

  // the warpgroup's rows of a tile, and its first 64-column block of dQ
  const int row0 = D == 256 ? 0 : 64 * wg;
  const int cb0 = D == 256 ? 2 * wg : 0;
  const bool add = !(flags & DIAG_NO_DQ_ADD);
  // the warpgroup's first thread adds its dQ piece by TMA and releases the
  // stage (which staged the piece) once that add has read it
  const bool elected = t == 0;
  auto release = [&](int stage) {
    if (!elected) return;
    if (add) bulk_wait_read<0>();
    mbar_arrive(&empty[stage]);
  };

  mbar_wait(kv_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES, q0 = q_lo + it * BQ;
    mbar_wait(&full[st], (it / STAGES) & 1);
    const uint32_t q_addr = smem_u32(smem + C::Q_OFF + st * C::QT_BYTES);
    const uint32_t do_addr = smem_u32(smem + C::DO_OFF + st * C::QT_BYTES);
    const float* stl = reinterpret_cast<const float*>(smem + C::ST_OFF) + st * 2 * BQ;

    // S^T = K.Q^T (WG0) or dP^T = V.dO^T (WG1): 64 keys x BQ queries, one
    // m64nBQ product a k-step of 16 columns of D
    float s[BQ / 2];
#pragma unroll
    for (int e = 0; e < BQ / 2; ++e) s[e] = 0.f;
    {
      const uint32_t a_base = wg == 0 ? k_addr : v_addr;
      const uint32_t b_base = wg == 0 ? q_addr : do_addr;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        mma_kk<T, BQ>(s, desc_sw128(a_base + (kk >> 2) * BKV * ROWB + (kk & 3) * 32, 16, 1024),
                      desc_sw128(b_base + (kk >> 2) * BQ * ROWB + (kk & 3) * 32, 16, 1024),
                      kk > 0);
      wgmma_commit();
      if (it > 0) release((it - 1) % STAGES);   // under the products
      wgmma_wait<0>();
      fence_regs(s);
    }

    // the tile crosses the ragged ends, the diagonal or the window's edge
    const bool need_mask =
        q0 + BQ > Sq || k0 + BKV > n_keys ||
        (causal && (q0 < k0 + BKV - 1 || (W > 0 && q0 + BQ - 1 - k0 >= W)));
    if (wg == 0) {
      // P^T under the mask, float32
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        const int col = 8 * (e >> 2) + 2 * q4 + (e & 1);
        float p = ex2(fmaf(s[e], scale_log2, -stl[col]));
        if (need_mask) {
          const int key = k0 + 16 * wl + g + 8 * ((e >> 1) & 1), qi = q0 + col;
          const bool ok = qi < Sq && key < n_keys &&
                          (!causal || (key <= qi && (W <= 0 || key > qi - W)));
          if (!ok) p = 0.f;
        }
        s[e] = p;
      }
      // hand P^T to WG1 once it has read the last one
      if (it > 0) named_sync(BAR_P_EMPTY, CONSUMERS);
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) pbuf[e * 128 + t] = s[e];
      named_arrive(BAR_P_FULL, CONSUMERS);
    } else {
      // dS^T = P^T (dP^T - Delta) / sqrt(D)
      named_sync(BAR_P_FULL, CONSUMERS);
#pragma unroll
      for (int e = 0; e < BQ / 2; ++e) {
        const int col = 8 * (e >> 2) + 2 * q4 + (e & 1);
        s[e] = pbuf[e * 128 + t] * (s[e] - stl[BQ + col]) * scale;
      }
      if (it + 1 < n_tiles) named_arrive(BAR_P_EMPTY, CONSUMERS);
      // dS^T rounded into shared memory for dQ, once both warpgroups' last dQ
      // has read the previous one
      if (it > 0) named_sync(BAR_DS_EMPTY, CONSUMERS);
#pragma unroll
      for (int e = 0; e < BQ / 2; e += 2) {
        const int r = 16 * wl + g + 8 * ((e >> 1) & 1), c8 = e >> 2;
        *reinterpret_cast<uint32_t*>(ds_s + (c8 >> 3) * BKV * ROWB + r * ROWB +
                                     (((c8 & 7) ^ (r & 7)) << 4) + 4 * q4) =
            pack2(s[e], s[e + 1], T{});
      }
      fence_proxy_async();
    }
    // the 16 queries of a k-step of the accumulator are one register A
    // fragment: P^T (WG0) or dS^T (WG1) rounded to T
    uint32_t pa[BQ / 16][4];
#pragma unroll
    for (int k = 0; k < BQ / 16; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[k][j] = pack2(s[8 * k + 2 * j], s[8 * k + 2 * j + 1], T{});

    // dV += P^T.dO (WG0), dK += dS^T.Q (WG1): the stage's dO or Q as an
    // MN-major operand (its 64-column blocks BQ rows apart), 16 queries a
    // k-step, all of D in one product
    {
      const uint32_t y_addr = wg == 0 ? do_addr : q_addr;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BQ / 16; ++k)
        mma_rt<T, D>(acc, pa[k], desc_sw128(y_addr + k * 2048, BQ * ROWB, 1024));
      wgmma_commit();
    }
    named_sync(BAR_DS_FULL, CONSUMERS);          // dS^T is in shared memory

    // dQ = dS.K: A = dS^T read MN-major, B = K read MN-major, 16 keys a k-step
    float dq[C::DQ_NB][32];
#pragma unroll
    for (int j = 0; j < C::DQ_NB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) dq[j][i] = 0.f;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
      const uint64_t da =
          desc_sw128(ds_addr + (row0 / 64) * BKV * ROWB + kk * 2048, BKV * ROWB, 1024);
#pragma unroll
      for (int j = 0; j < C::DQ_NB; ++j)
        wgmma_ss64<1, 1>(dq[j], da,
                         desc_sw128(k_addr + (cb0 + j) * BKV * ROWB + kk * 2048, BKV * ROWB,
                                    1024),
                         kk > 0, T{});
    }
    wgmma_commit();
    wgmma_wait<0>();                             // dV or dK, and dQ
    fence_regs(acc);
#pragma unroll
    for (int j = 0; j < C::DQ_NB; ++j) fence_regs(dq[j]);
    if (wg == 0 && it + 1 < n_tiles) named_arrive(BAR_DS_EMPTY, CONSUMERS);

    // dQ added into its float32 accumulator by TMA: the piece staged as
    // boxes of 64 rows x 32 columns (128-byte swizzle) over the stage's dO
    // (WG0) or Q (WG1), which this warpgroup has read; rows past Sq are not
    // written
    if (add) {
      uint8_t* box = smem + (wg == 0 ? C::DO_OFF : C::Q_OFF) + st * C::QT_BYTES;
#pragma unroll
      for (int j = 0; j < C::DQ_NB; ++j)
#pragma unroll
        for (int e = 0; e < 32; e += 2) {
          const int r = 16 * wl + g + 8 * ((e >> 1) & 1), c8 = e >> 2;
          const int chunk = 2 * (c8 & 3) + (q4 >> 1);
          *reinterpret_cast<float2*>(box + (2 * j + (c8 >> 2)) * 8192 + r * 128 +
                                     ((chunk ^ (r & 7)) << 4) + 8 * (q4 & 1)) =
              make_float2(dq[j][e], dq[j][e + 1]);
        }
      fence_proxy_async();
      named_sync(5 + wg, 128);
      if (elected) {
#pragma unroll
        for (int k = 0; k < 2 * C::DQ_NB; ++k)
          tma_reduce_add_4d(&tm_dq, box + k * 8192, 64 * cb0 + 32 * k, h, q0 + row0, b);
        bulk_commit();
      }
    } else {
      named_sync(5 + wg, 128);
    }
  }
  if (n_tiles > 0) release((n_tiles - 1) % STAGES);
  if (elected) bulk_wait<0>();                   // the last dQ add written

  // dV (WG0) or dK (WG1) of the block's keys: rounded to T with G = 1, else
  // this head's float32 partial
#pragma unroll
  for (int e = 0; e < D / 2; e += 2) {
    const int key = k0 + 16 * wl + g + 8 * ((e >> 1) & 1);
    const int col = 8 * (e >> 2) + 2 * q4;
    if (key >= Sk) continue;
    if (G == 1) {
      T* out = wg == 0 ? dv : dk;
      *reinterpret_cast<uint32_t*>(out + ((long)b * Sk + key) * KVH * D + (long)kvh * D + col) =
          pack2(acc[e], acc[e + 1], T{});
    } else {
      const long plane = (long)gridDim.y * Sk * H * D;   // dK's partials, then dV's
      *reinterpret_cast<float2*>(kv_part + (wg == 0 ? plane : 0) +
                                 ((long)b * Sk + key) * H * D + (long)h * D + col) =
          make_float2(acc[e], acc[e + 1]);
    }
  }
}

// dQ rounded to T from its float32 accumulator; with G > 1 also dK and dV:
// the group's G float32 partials summed in head order (only the last head
// under the planted fault) and rounded to T.  Four elements a thread (D is a
// multiple of 64)
template <typename T>
__device__ __forceinline__ void store4(T* dst, float4 v) {
  uint2 raw;
  raw.x = pack2(v.x, v.y, T{});
  raw.y = pack2(v.z, v.w, T{});
  *reinterpret_cast<uint2*>(dst) = raw;
}

template <typename T>
__global__ void flash_bwd_post_kernel(const float* __restrict__ dq_acc, T* __restrict__ dq,
                                      long n_q, const float* __restrict__ kv_part,
                                      T* __restrict__ dk, T* __restrict__ dv, long n_kv,
                                      int G, int D, int flags) {
  const long n = n_q > n_kv ? n_q : n_kv;
  const int g0 = (flags & FAULT_NO_GROUP_SUM) ? G - 1 : 0;
  for (long i = 4 * (blockIdx.x * (long)blockDim.x + threadIdx.x); i < n;
       i += 4 * (long)gridDim.x * blockDim.x) {
    if (i < n_q) store4(dq + i, *reinterpret_cast<const float4*>(dq_acc + i));
    if (kv_part != nullptr && i < n_kv) {
      // i = ((b Sk + key) KVH + kvh) D + d; head kvh G + g's partial sits at
      // ((b Sk + key) H + kvh G + g) D + d
      const long base = (i / D) * G * D + i % D;
      float4 sk = make_float4(0.f, 0.f, 0.f, 0.f), sv = sk;
      for (int g = g0; g < G; ++g) {
        const float4 a = *reinterpret_cast<const float4*>(kv_part + base + (long)g * D);
        const float4 c =
            *reinterpret_cast<const float4*>(kv_part + n_kv * G + base + (long)g * D);
        sk.x += a.x; sk.y += a.y; sk.z += a.z; sk.w += a.w;
        sv.x += c.x; sv.y += c.y; sv.z += c.z; sv.w += c.w;
      }
      store4(dk + i, sk);
      store4(dv + i, sv);
    }
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const void* o, const void* lse,
             const void* dout, void* dq, void* dk, void* dv, void* dq_acc, void* delta,
             void* kv_part, int B, int Sq, int Sk, int H, int KVH, int window, int causal,
             int flags, CUtensorMapDataType dt, cudaStream_t stream) {
  using C = Cfg<D>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  // dQ's float32 accumulator as (D, H, Sq, B) in boxes of 32 columns by 64
  // rows (the TMA add)
  const cuuint64_t dq_dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)Sq, (cuuint64_t)B};
  const cuuint64_t dq_str[3] = {(cuuint64_t)D * 4, (cuuint64_t)H * D * 4,
                                (cuuint64_t)Sq * H * D * 4};
  const cuuint32_t dq_box[4] = {32, 1, 64, 1};
  CUtensorMap tq, tk, tv, tdo, tdq;
  if (!make_map(&tq, q, dt, B, Sq, H, D, C::BQ) || !make_map(&tdo, dout, dt, B, Sq, H, D, C::BQ) ||
      !make_map(&tk, k, dt, B, Sk, KVH, D, BKV) || !make_map(&tv, v, dt, B, Sk, KVH, D, BKV) ||
      !make_map(&tdq, dq_acc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, dq_dims, dq_str, dq_box))
    return (int)cudaErrorInvalidValue;
  const long rows = (long)B * Sq * H;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), static_cast<float*>(dq_acc), rows, Sq, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int G = H / KVH;
  float* part = G > 1 ? static_cast<float*>(kv_part) : nullptr;
  const dim3 grid(H, B, (Sk + BKV - 1) / BKV);
  flash_bwd_kernel<T, D><<<grid, THREADS, C::SMEM, stream>>>(
      tq, tk, tv, tdo, tdq, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), part, Sq, Sk,
      H, KVH, window, causal, 1.f / sqrtf((float)D), flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long n_q = rows * D, n_kv = G > 1 ? (long)B * Sk * KVH * D : 0;
  const long n = n_q > n_kv ? n_q : n_kv;
  const long blocks = (n / 4 + 255) / 256;
  flash_bwd_post_kernel<T><<<(unsigned)(blocks < 8192 ? blocks : 8192), 256, 0, stream>>>(
      static_cast<const float*>(dq_acc), static_cast<T*>(dq), n_q, part,
      static_cast<T*>(dk), static_cast<T*>(dv), n_kv, G, D, flags);
  return (int)cudaGetLastError();
}

// the instantiations: D 64, 128 and 256, and an error for any other D
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
           const void* dout, void* dq, void* dk, void* dv, void* dq_acc, void* delta,
           void* kv_part, int B, int Sq, int Sk, int H, int KVH, int D, int window,
           int causal, int flags, CUtensorMapDataType dt, cudaStream_t stream) {
#define D_ARGS q, k, v, o, lse, dout, dq, dk, dv, dq_acc, delta, kv_part, B, Sq, Sk, H, KVH, \
               window, causal, flags, dt, stream
  switch (D) {
    case 64: return launch_d<T, 64>(D_ARGS);
    case 128: return launch_d<T, 128>(D_ARGS);
    case 256: return launch_d<T, 256>(D_ARGS);
  }
  return (int)cudaErrorInvalidValue;
#undef D_ARGS
}

}  // namespace bwd
}  // namespace

extern "C" {

// q, o, dout, dq (B, Sq, H, D); k, v, dk, dv (B, Sk, KVH, D); lse (B, H, Sq)
// float32 from the forward; scratch: dq_acc (B, Sq, H, D) and delta (B, H,
// Sq) float32, and with H > KVH kv_part (2, B, Sk, H, D) float32 (dK's and
// dV's per-head partials; may be null when H = KVH).  causal 1: keys j <= i
// (Sq = Sk), and window > 0 only j > i - window; causal 0: every key j <
// Sk, no window.  D 64, 128 or 256; any other D returns
// cudaErrorInvalidValue and launches nothing.  dtype: 1 float16, 2
// bfloat16.  The 16-bit tensors 16-byte aligned.  flags: planted faults, 0
// on every model path.  Returns a cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* lse, const void* dout, void* dq, void* dk, void* dv,
                        void* dq_acc, void* delta, void* kv_part, int B, int Sq, int Sk,
                        int H, int KVH, int D, int window, int causal, int dtype, int flags,
                        void* stream) {
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
      reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
      reinterpret_cast<uintptr_t>(dv);
  if (KVH <= 0 || H % KVH != 0 || Sq <= 0 || Sk <= 0 || B <= 0 || window < 0 ||
      (causal && Sq != Sk) || (!causal && window > 0) || align % 16 != 0 ||
      (H > KVH && kv_part == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return bwd::launch<__half>(q, k, v, o, lse, dout, dq, dk, dv, dq_acc, delta,
                                       kv_part, B, Sq, Sk, H, KVH, D, window, causal, flags,
                                       CU_TENSOR_MAP_DATA_TYPE_FLOAT16, st);
    case 2: return bwd::launch<__nv_bfloat16>(q, k, v, o, lse, dout, dq, dk, dv, dq_acc,
                                              delta, kv_part, B, Sq, Sk, H, KVH, D, window,
                                              causal, flags,
                                              CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, st);
  }
  return (int)cudaErrorInvalidValue;
}

// the main pass's dynamic shared memory at head_dim D (bytes), -1 if none
int flash_attention_bwd_smem(int D) {
  switch (D) {
    case 64: return bwd::Cfg<64>::SMEM;
    case 128: return bwd::Cfg<128>::SMEM;
    case 256: return bwd::Cfg<256>::SMEM;
  }
  return -1;
}

}  // extern "C"
