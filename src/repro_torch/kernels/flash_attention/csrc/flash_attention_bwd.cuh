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
// lse once and writing dq, dk, dv once.  At the training shapes (S = 512,
// D = 128, causal) that is ~250 operations per byte, under the H100's ~295:
// the bound is the bytes, by a little, and a design near it needs the tensor
// cores and a few passes over the inputs.
//
// The design, simple first (the forward's wgmma/TMA redesign is later work):
//   - a pre-pass (one warp per (b, i, h) row) takes Delta in float32 and
//     zeroes the row's float32 dQ accumulator;
//   - the main pass runs one block of four warps per (64-key tile, kv head,
//     column part of D, request).  The block loads its K and V tiles once,
//     then loops over the G query heads of its group and over the 32-query
//     tiles that see any of its keys: causal, those at or after its first
//     key, and with a window W only those before its last key + W (the
//     TPU kernel's tile skip); non-causal, every query tile.  Each warp
//     owns 16 keys: it recomputes S^T = K.Q^T and P^T for them over the
//     whole D, and keeps dK and dV of its keys for the whole group in
//     float32 registers, so no atomic touches dK or dV.  dS^T goes through
//     shared memory (rounded to the input dtype), and the block's partial
//     dQ of the tile (32 queries x its columns, over its 64 keys) is added
//     to the float32 accumulator with atomics;
//   - a last pass rounds dQ to the input dtype.
// D = 256 is split in two column parts of 128, one block each (the grid's
// y is kv head x part): a thread's dK and dV are DC = min(D, 128) columns,
// 128 floats of registers at any D.  Whole-D accumulators would be 256
// floats a thread beside the operands, past the 255 registers a thread
// has.  Each part recomputes S^T and dP^T over the whole D, so D = 256
// does 7/5 of the tensor-core work of one pass, and its blocks share no
// accumulator.
// All five products are mma.sync m16n8k16 on the tensor cores (16-bit
// inputs, float32 accumulators), their operands loaded by ldmatrix from
// shared-memory tiles padded by 16 bytes a row (no bank conflicts).  The
// new roundings against the float32 plain version: P and dS in 16 bits
// before their products, as the forward rounds P.
//
// One C call launches the three passes on the caller's stream.
//
// Included at the end of flash_attention.cu: one library holds the forward
// and its gradient.  Everything here sits in the namespace `bwd` inside an
// anonymous namespace, beside the forward's own helpers.
#pragma once
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <cstdint>

namespace {
namespace bwd {

constexpr int BKV = 64;            // keys per block, 16 per warp
constexpr int BQ = 32;             // queries per inner tile
constexpr int THREADS = 128;
constexpr int PAD = 8;             // 16 bytes a row: ldmatrix without conflicts
constexpr float LOG2E = 1.4426950408889634f;
// planted faults (flags; 0 on every model path): the causal mask left out
// (every query tile, every key), dK/dV not summed over the group (each head
// restarts them: only the group's last head survives), the window left out
// (the mask and the tile skip: the causal gradient), and the keys cut at Sq
// (those past the queries' length take no part)
constexpr int FAULT_NO_CAUSAL = 1;
constexpr int FAULT_NO_GROUP_SUM = 2;
constexpr int FAULT_NO_WINDOW = 4;
constexpr int FAULT_SK_AS_SQ = 8;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) x += __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

__device__ __forceinline__ uint32_t pack(float lo, float hi, __half) {
  __half2 h = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack(float lo, float hi, __nv_bfloat16) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// four 8 x 8 matrices of 16-bit values; thread i gives the address of row
// i % 8 of matrix i / 8, and gets (row lane / 4, columns 2 (lane % 4) + {0,
// 1}) of each, or with .trans the same of each matrix transposed
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c (16 x 8, float32) += a (16 x 16, row-major) . b (16 x 8, column-major).
// Fragments (g = lane / 4, t = lane % 4): a0 (g, 2t..2t+1), a1 (g + 8, ..),
// a2 (g, 2t + 8..), a3 (g + 8, 2t + 8..); b0 (k 2t..2t+1, n g), b1 (k 2t + 8..,
// n g); c0, c1 (g, 2t..2t+1), c2, c3 (g + 8, 2t..2t+1)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1, __nv_bfloat16) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1, __half) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two accumulator tiles of 8 columns (keys x queries) as one A fragment of
// 16 columns: the register layouts coincide
template <typename T>
__device__ __forceinline__ void as_a(uint32_t (&a)[4], const float (&lo)[4],
                                     const float (&hi)[4]) {
  a[0] = pack(lo[0], lo[1], T{});
  a[1] = pack(lo[2], lo[3], T{});
  a[2] = pack(hi[0], hi[1], T{});
  a[3] = pack(hi[2], hi[3], T{});
}

// acc (16 rows x BQ queries) = A (16 rows of `rows`, row-major, D wide) .
// Q^T, Q's tile [BQ][LD] in shared memory: S^T = K.Q^T, or dP^T = V.dO^T
template <typename T, int D, int LD>
__device__ __forceinline__ void times_qt(float (&acc)[BQ / 8][4], const T* rows,
                                         const T* qs, int lane) {
#pragma unroll
  for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldsm(a, rows + (lane % 16) * LD + 16 * kk + 8 * (lane / 16));
#pragma unroll
    for (int j = 0; j < BQ / 16; ++j) {
      uint32_t b[4];
      ldsm(b, qs + (16 * j + lane % 8 + 8 * (lane / 16)) * LD + 16 * kk +
                  8 * ((lane / 8) % 2));
      mma(acc[2 * j], a, b[0], b[1], T{});
      mma(acc[2 * j + 1], a, b[2], b[3], T{});
    }
  }
}

// acc (16 keys x D) += X^T (16 keys x BQ queries, accumulator tiles) .
// Y (BQ x D, the tile [BQ][LD] in shared memory): dV += P^T.dO, dK += dS^T.Q
template <typename T, int D, int LD>
__device__ __forceinline__ void accumulate(float (&acc)[D / 8][4],
                                           const float (&x)[BQ / 8][4], const T* ys,
                                           int lane) {
#pragma unroll
  for (int kk = 0; kk < BQ / 16; ++kk) {
    uint32_t a[4];
    as_a<T>(a, x[2 * kk], x[2 * kk + 1]);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      uint32_t b[4];
      ldsm_t(b, ys + (16 * kk + lane % 8 + 8 * ((lane / 8) % 2)) * LD + 16 * n +
                    8 * (lane / 16));
      mma(acc[2 * n], a, b[0], b[1], T{});
      mma(acc[2 * n + 1], a, b[2], b[3], T{});
    }
  }
}

template <int D>
struct Smem {
  static constexpr int LD = D + PAD;          // row stride of the D-wide tiles
  static constexpr int LDS = BQ + PAD;        // row stride of dS^T
  static constexpr int ELEMS = 2 * BKV * LD + 2 * BQ * LD + BKV * LDS;
  static constexpr int BYTES = ELEMS * 2 + 2 * BQ * 4;
};

// the columns of dK, dV and dQ one block accumulates: all of D up to 128,
// else 128 (the grid's y holds D / DC parts per kv head)
template <int D>
struct Part {
  static constexpr int DC = D > 128 ? 128 : D;
  static constexpr int PARTS = D / DC;
};

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
__global__ void __launch_bounds__(THREADS)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq_acc, T* __restrict__ dk, T* __restrict__ dv,
                 int Sq, int Sk, int H, int KVH, int window, int causal_in,
                 float scale, int flags) {
  using M = Smem<D>;
  constexpr int LD = M::LD, LDS = M::LDS;
  constexpr int DC = Part<D>::DC, PARTS = Part<D>::PARTS;
  extern __shared__ __align__(16) uint8_t bwd_smem[];
  T* ks = reinterpret_cast<T*>(bwd_smem);
  T* vs = ks + BKV * LD;
  T* qs = vs + BKV * LD;
  T* dos = qs + BQ * LD;
  T* dss = dos + BQ * LD;                             // dS^T [BKV keys][BQ]
  float* lse_s = reinterpret_cast<float*>(dss + BKV * LDS);   // log2 units
  float* dl_s = lse_s + BQ;

  const int k0 = blockIdx.x * BKV, b = blockIdx.z;
  const int kvh = blockIdx.y / PARTS, d0 = DC * (blockIdx.y % PARTS);
  const int G = H / KVH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const long kv_row = (long)KVH * D, q_row = (long)H * D;
  const bool causal = causal_in && !(flags & FAULT_NO_CAUSAL);
  const int W = (flags & FAULT_NO_WINDOW) ? 0 : window;
  // the keys that take part: all Sk, or under the fault those below Sq
  const int n_keys = (flags & FAULT_SK_AS_SQ) ? min(Sq, Sk) : Sk;
  const float scale_log2 = scale * LOG2E;

  // the block's K and V tiles over the whole D, rows past Sk zero-filled
  for (int c = tid; c < BKV * D / 8; c += THREADS) {
    const int r = c / (D / 8), col = c % (D / 8) * 8;
    uint4 kx = make_uint4(0, 0, 0, 0), vx = kx;
    if (k0 + r < Sk) {
      const long off = ((long)b * Sk + k0 + r) * kv_row + (long)kvh * D + col;
      kx = *reinterpret_cast<const uint4*>(k + off);
      vx = *reinterpret_cast<const uint4*>(v + off);
    }
    *reinterpret_cast<uint4*>(ks + r * LD + col) = kx;
    *reinterpret_cast<uint4*>(vs + r * LD + col) = vx;
  }

  // this warp's 16 keys; the thread's accumulator rows are keys key0, key0 + 8,
  // its columns those of the block's part, d0 ..
  const int wk = 16 * warp;
  const int key0 = k0 + wk + g;
  float dk_acc[DC / 8][4], dv_acc[DC / 8][4];
#pragma unroll
  for (int n = 0; n < DC / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  // the dQ piece this warp adds: 16 query rows x DC/2 columns of the tile
  const int m0 = 16 * (warp % 2), c0 = d0 + (DC / 2) * (warp / 2);
  // the query tiles that see any of the block's keys: causal, from its
  // first key on, and with a window, before its last key + W
  const int q_lo = causal ? k0 : 0;
  const int q_hi = causal && W > 0 ? min(Sq, k0 + BKV - 1 + W) : Sq;

  for (int hg = 0; hg < G; ++hg) {
    const int h = kvh * G + hg;
    if ((flags & FAULT_NO_GROUP_SUM) && hg > 0) {
#pragma unroll
      for (int n = 0; n < DC / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;
    }
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();                  // the last tile's Q, dO and dS^T are read
      for (int c = tid; c < BQ * D / 8; c += THREADS) {
        const int r = c / (D / 8), col = c % (D / 8) * 8;
        uint4 qx = make_uint4(0, 0, 0, 0), ox = qx;
        if (q0 + r < Sq) {
          const long off = ((long)b * Sq + q0 + r) * q_row + (long)h * D + col;
          qx = *reinterpret_cast<const uint4*>(q + off);
          ox = *reinterpret_cast<const uint4*>(dout + off);
        }
        *reinterpret_cast<uint4*>(qs + r * LD + col) = qx;
        *reinterpret_cast<uint4*>(dos + r * LD + col) = ox;
      }
      if (tid < BQ) {
        const bool live = q0 + tid < Sq;
        const long at = ((long)b * H + h) * Sq + q0 + tid;
        lse_s[tid] = live ? lse[at] * LOG2E : 0.f;
        dl_s[tid] = live ? delta[at] : 0.f;
      }
      __syncthreads();

      // P^T (16 keys x BQ queries): the recomputed scores under the mask
      float pt[BQ / 8][4];
      times_qt<T, D, LD>(pt, ks + wk * LD, qs, lane);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = key0 + 8 * (e / 2);
          const int qi = q0 + 8 * j + 2 * t4 + (e % 2);
          const bool ok = qi < Sq && key < n_keys &&
                          (!causal || (key <= qi && (W <= 0 || key > qi - W)));
          pt[j][e] = ok ? exp2f(pt[j][e] * scale_log2 - lse_s[qi - q0]) : 0.f;
        }
      accumulate<T, DC, LD>(dv_acc, pt, dos + d0, lane);    // dV += P^T.dO

      // dS^T = P^T * (dP^T - Delta) * scale, dP^T = V.dO^T
      float ds[BQ / 8][4];
      times_qt<T, D, LD>(ds, vs + wk * LD, dos, lane);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = 8 * j + 2 * t4 + (e % 2);
          ds[j][e] = pt[j][e] * (ds[j][e] - dl_s[ql]) * scale;
        }
      accumulate<T, DC, LD>(dk_acc, ds, qs + d0, lane);     // dK += dS^T.Q
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const int col = 8 * j + 2 * t4;
        *reinterpret_cast<uint32_t*>(dss + (wk + g) * LDS + col) =
            pack(ds[j][0], ds[j][1], T{});
        *reinterpret_cast<uint32_t*>(dss + (wk + g + 8) * LDS + col) =
            pack(ds[j][2], ds[j][3], T{});
      }
      __syncthreads();

      // dQ (BQ x DC) += dS (BQ x BKV) . K: this warp's 16 rows x DC/2
      // columns, dS read transposed out of dS^T
      float dq[DC / 16][4];
#pragma unroll
      for (int n = 0; n < DC / 16; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BKV / 16; ++kk) {
        uint32_t a[4];
        ldsm_t(a, dss + (16 * kk + lane % 8 + 8 * (lane / 16)) * LDS + m0 +
                      8 * ((lane / 8) % 2));
#pragma unroll
        for (int n = 0; n < DC / 32; ++n) {
          uint32_t bk[4];
          ldsm_t(bk, ks + (16 * kk + lane % 8 + 8 * ((lane / 8) % 2)) * LD + c0 +
                         16 * n + 8 * (lane / 16));
          mma(dq[2 * n], a, bk[0], bk[1], T{});
          mma(dq[2 * n + 1], a, bk[2], bk[3], T{});
        }
      }
#pragma unroll
      for (int n = 0; n < DC / 16; ++n) {
        const int col = c0 + 8 * n + 2 * t4;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int qi = q0 + m0 + g + 8 * half;
          if (qi < Sq) {
            float* at = dq_acc + ((long)b * Sq + qi) * q_row + (long)h * D + col;
            atomicAdd(at, dq[n][2 * half]);
            atomicAdd(at + 1, dq[n][2 * half + 1]);
          }
        }
      }
    }
  }

  // dK and dV of the warp's keys in the block's columns, rounded to T
#pragma unroll
  for (int n = 0; n < DC / 8; ++n) {
    const int col = d0 + 8 * n + 2 * t4;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = key0 + 8 * half;
      if (key < Sk) {
        const long off = ((long)b * Sk + key) * kv_row + (long)kvh * D + col;
        *reinterpret_cast<uint32_t*>(dk + off) =
            pack(dk_acc[n][2 * half], dk_acc[n][2 * half + 1], T{});
        *reinterpret_cast<uint32_t*>(dv + off) =
            pack(dv_acc[n][2 * half], dv_acc[n][2 * half + 1], T{});
      }
    }
  }
}

// dQ rounded to T from its float32 accumulator
template <typename T>
__global__ void flash_bwd_dq_kernel(const float* __restrict__ dq_acc, T* __restrict__ dq,
                                    long n) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < n;
       i += (long)gridDim.x * blockDim.x)
    dq[i] = from_f<T>(dq_acc[i]);
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, const void* o,
             const void* lse, const void* dout, void* dq, void* dk, void* dv,
             void* dq_acc, void* delta, int B, int Sq, int Sk, int H, int KVH,
             int window, int causal, int flags, cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        Smem<D>::BYTES);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const long rows = (long)B * Sq * H;
  flash_bwd_delta_kernel<T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(delta), static_cast<float*>(dq_acc), rows, Sq, H, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Sk + BKV - 1) / BKV, KVH * Part<D>::PARTS, B);
  flash_bwd_kernel<T, D><<<grid, THREADS, Smem<D>::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq_acc),
      static_cast<T*>(dk), static_cast<T*>(dv), Sq, Sk, H, KVH, window, causal,
      1.f / sqrtf((float)D), flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long n = rows * D;
  const long blocks = (n + 255) / 256;
  flash_bwd_dq_kernel<T><<<(unsigned)(blocks < 4096 ? blocks : 4096), 256, 0, stream>>>(
      static_cast<const float*>(dq_acc), static_cast<T*>(dq), n);
  return (int)cudaGetLastError();
}

// the instantiations: D 64, 128 and 256, and an error for any other D
template <typename T>
int launch(const void* q, const void* k, const void* v, const void* o, const void* lse,
           const void* dout, void* dq, void* dk, void* dv, void* dq_acc, void* delta,
           int B, int Sq, int Sk, int H, int KVH, int D, int window, int causal,
           int flags, cudaStream_t stream) {
#define D_ARGS q, k, v, o, lse, dout, dq, dk, dv, dq_acc, delta, B, Sq, Sk, H, KVH, \
               window, causal, flags, stream
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
// Sq) float32.  causal 1: keys j <= i (Sq = Sk), and window > 0 only j > i -
// window; causal 0: every key j < Sk, no window.  D 64, 128 or 256; any
// other D returns cudaErrorInvalidValue and launches nothing.  dtype: 1
// float16, 2 bfloat16.  The 16-bit tensors 16-byte aligned.  flags: planted
// faults, 0 on every model path.  Returns a cudaError_t.
int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                        const void* lse, const void* dout, void* dq, void* dk, void* dv,
                        void* dq_acc, void* delta, int B, int Sq, int Sk, int H, int KVH,
                        int D, int window, int causal, int dtype, int flags,
                        void* stream) {
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(dout) |
      reinterpret_cast<uintptr_t>(dq) | reinterpret_cast<uintptr_t>(dk) |
      reinterpret_cast<uintptr_t>(dv);
  if (KVH <= 0 || H % KVH != 0 || Sq <= 0 || Sk <= 0 || B <= 0 || window < 0 ||
      (causal && Sq != Sk) || (!causal && window > 0) || align % 16 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return bwd::launch<__half>(q, k, v, o, lse, dout, dq, dk, dv, dq_acc, delta, B,
                                       Sq, Sk, H, KVH, D, window, causal, flags, st);
    case 2: return bwd::launch<__nv_bfloat16>(q, k, v, o, lse, dout, dq, dk, dv, dq_acc,
                                              delta, B, Sq, Sk, H, KVH, D, window, causal,
                                              flags, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
