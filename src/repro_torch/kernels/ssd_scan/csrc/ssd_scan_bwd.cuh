// Mamba-2 chunked SSD scan, backward, for Hopper (sm_90a): dx, ddt, dA, dB
// and dC of the forward in ssd_scan.cu, from a zero initial state.
//
// Replaces no Pallas kernel.  The JAX package trains through XLA's autodiff
// of `ssd_chunked`'s lax.scan (src/repro/models/layers.py:497-559); this is
// its counterpart for the port's training path.  Its plain version is
// `ssd_scan_bwd_ref` (kernels/ssd_scan/ref.py), whose docstring derives the
// formulas below.
//
// What it computes, per request b and head h, for each chunk of 64 rows i, j
// with a_k = dt_k A, cum_i = sum_{k <= i} a_k, the state S entering the
// chunk, M_ij = (C_i . B_j) e^(cum_i - cum_j) dt_j and w_j = e^(cum_last -
// cum_j) dt_j for j <= i, and dS, the cotangent of the state leaving it (the
// final state's cotangent at the last chunk, zero where nothing reads it):
//   dx_j  = sum_{i >= j} M_ij dy_i + w_j dS B_j
//   dC_i  = sum_{j <= i} e^(cum_i - cum_j) dt_j (dy_i . x_j) B_j + e^(cum_i) S^T dy_i
//   dB_j  = sum_{i >= j} e^(cum_i - cum_j) dt_j (dy_i . x_j) C_i + w_j dS^T x_j
//   ddt_j = its direct part + A sum_{i >= j} dcum_i,  dA += sum_j dt_j sum_{i >= j} dcum_i
//   dS   <- e^(cum_last) dS + sum_i e^(cum_i) dy_i C_i^T   (carried to the chunk before)
// dB and dC are summed over the heads (Mamba-2's one group of B/C), dA over
// the requests and chunks.  Rows past s load as zeros with dt = 0 (the zero
// padding of `ssd_chunked`), so they contribute nothing.  No initial-state
// gradient: every caller starts the scan from zero.
//
// What bounds it on this card: at mamba2's training shape (P = 64, N = 128,
// chunk 64, 80 heads, 4 x 1024 rows) the products are ~6.3 MFLOP per
// (request, head, chunk), and ~3.1 MFLOP per (request, chunk) for C B^T and
// the intra terms of dB and dC, which the heads share (B and C are one
// group: the heads' 64 x 64 weights can be summed before the product):
// ~32 GFLOP in all against ~143 MB of inputs and outputs (x, dy and dx at
// 42 MB each): ~230 operations per byte, under the H100's ~295, so at the
// tensor cores' rate the bound is the bytes.  This first design is far
// from it: it forms C B^T once per head, and runs its products in float32
// on the CUDA cores (67 TFLOP/s at most, 15x under the 16-bit tensor rate)
// from shared memory, one block an SM.  Right first; the tensor-core
// design is later work.
//
// The design:
//   - one block of 256 threads per (head, request), 201 KB of dynamic
//     shared memory (one block an SM).  It first walks the chunks forward
//     and stores the state entering each one, (b, n_chunks, h, P, N) float32,
//     in a scratch (the state pass: the recurrence's state is never stored by
//     the forward, which keeps it in registers);
//   - then it walks the chunks from the last to the first, carrying dS
//     (P x N float32, 32 KB) in shared memory.  Per chunk it stages x, dy, B,
//     C and the entering state as float32 in shared memory, forms C B^T and
//     dy x^T (64 x 64), their masked products with e^(cum_i - cum_j) dt_j
//     (M and Q) and the row and column sums that dcum takes, then dx, dC, dB
//     and the new dS, each thread a 4 x 4 or 4 x 8 tile of float32 sums;
//   - the sums over heads, deterministic: each block writes its dB and dC
//     rows to a per-head float32 scratch (b, s, h, N) and its dA part to a
//     (b, h) scratch, and a last pass sums them in a fixed order (heads 0..h-1,
//     requests 0..b-1) and rounds dB and dC to the input dtype.  That moves
//     b.s.h.N.4.2.2 bytes (0.67 GB at mamba2's 4 x 1024, ~0.2 ms at the
//     card's rate) where float32 atomics would move none, but atomics add
//     the heads in no fixed order, and at mamba2's 64 layers any rounding
//     change moves step 1's bf16 gradients by ~3% (chip_smoke.py's
//     BWD_GRAD_REL_L2 note): a deterministic backward gives the same step
//     every run.
// The shapes it is built for: P = 64, N = 128, chunk 64 (mamba2-2.7b's and
// jamba's); the C entry returns an error for any other and touches nothing.
//
// `flags` (planted faults, 0 on every model path; bits 0 and 1 are the
// forward's): bit 2 resets dS at each chunk (the state's cotangent not
// carried); bit 3 takes dB and dC from head 0 alone (not summed over the
// heads).

namespace {
namespace sbwd {

constexpr int THREADS = 256;
constexpr int CH = 64;         // the chunk
constexpr int PP = 64;         // the head dim P
constexpr int NN = 128;        // the state width N
constexpr int XS = PP + 1;     // row stride of the 64-wide tiles (floats; no bank conflicts)
constexpr int NS = NN + 1;     // row stride of the 128-wide tiles
constexpr int NVEC = 9;        // per-row vectors: dt, cum, e^cum, w, rowT, intra, u, v, dcum
constexpr int SMEM_FLOATS = 4 * CH * XS + 2 * CH * NS + 2 * PP * NS + NVEC * CH + 16;
constexpr int SMEM = SMEM_FLOATS * 4;
constexpr int FAULT_STATE_NOT_CARRIED = 4, FAULT_HEADS_NOT_SUMMED = 8;

// rows [r0, r0 + CH) of a (rows, W) 16-bit matrix read through its row
// stride into a float tile of row stride `ld`; rows past S as zeros
template <typename T, int W>
__device__ __forceinline__ void stage_rows(float* dst, int ld, const T* src, long long stride,
                                           int r0, int S) {
  for (int e = threadIdx.x; e < CH * W; e += THREADS) {
    const int i = e / W, c = e % W, r = r0 + i;
    dst[i * ld + c] = r < S ? to_f(src[(long long)r * stride + c]) : 0.f;
  }
}

// dt of the chunk's rows (0 past S), the cumulative sums of dt A, e^cum and
// w = e^(cum_last - cum) dt; two barriers inside
__device__ __forceinline__ void chunk_decay(const float* dt_bh, int H, int r0, int S,
                                            float a, float* v_dt, float* v_cum,
                                            float* v_ecum, float* v_w) {
  const int t = threadIdx.x;
  if (t < CH) v_dt[t] = r0 + t < S ? dt_bh[(long long)(r0 + t) * H] : 0.f;
  __syncthreads();
  if (t < CH) {
    float c = 0.f;
    for (int k = 0; k <= t; ++k) c += v_dt[k] * a;
    v_cum[t] = c;
  }
  __syncthreads();
  if (t < CH) {
    v_ecum[t] = expf(v_cum[t]);
    v_w[t] = expf(v_cum[CH - 1] - v_cum[t]) * v_dt[t];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
ssd_bwd_kernel(const T* x, const float* dt, const float* A, const T* Bm, const T* Cm,
               const T* dy, const float* dfinal, T* dx, float* ddt, float* dA_part,
               float* partB, float* partC, float* states, int S, int H, long long sxb,
               long long sxs, long long sbb, long long sbs, long long scb, long long scs,
               int flags) {
  extern __shared__ float sm[];
  float* xs = sm;                    // x rows [CH][XS]
  float* dys = xs + CH * XS;         // dy rows [CH][XS]
  float* Gs = dys + CH * XS;         // C B^T, then M [CH][XS]
  float* Ds = Gs + CH * XS;          // dy x^T, then Q [CH][XS]
  float* Bs = Ds + CH * XS;          // B rows [CH][NS]
  float* Cs = Bs + CH * NS;          // C rows [CH][NS]
  float* Ss = Cs + CH * NS;          // the entering state [PP][NS]
  float* dSs = Ss + PP * NS;         // the carried cotangent dS [PP][NS]
  float* v_dt = dSs + PP * NS;
  float* v_cum = v_dt + CH;
  float* v_ecum = v_cum + CH;
  float* v_w = v_ecum + CH;
  float* v_rowT = v_w + CH;          // sum_j T_ij
  float* v_intra = v_rowT + CH;      // sum_{i >= j} G_ij E_ij D_ij
  float* v_u = v_intra + CH;         // e^cum_i dy_i^T S C_i
  float* v_v = v_u + CH;             // x_j^T dS B_j
  float* v_dcum = v_v + CH;
  float* red = v_dcum + CH;          // 8 warps' partial <dS, S>, then dA's 2

  const int h = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int ty = tid >> 4, tx = tid & 15;
  const int n_chunks = (S + CH - 1) / CH;
  const float a = A[h];
  const T* xb = x + b * sxb + (long long)h * PP;
  const T* Bb = Bm + b * sbb;
  const T* Cb = Cm + b * scb;
  const long long row_hp = (long long)H * PP;
  const T* dyb = dy + (long long)b * S * row_hp + (long long)h * PP;
  const float* dtb = dt + (long long)b * S * H + h;
  const long long chunk_state = (long long)H * PP * NN;
  float* stb = states + (long long)b * n_chunks * chunk_state + (long long)h * PP * NN;

  // the state pass: the state entering each chunk, a 4 x 8 tile a thread
  // (rows p = ty * 4 + r, columns n = tx + 16 c)
  float st[4][8];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) st[r][c] = 0.f;
  for (int ci = 0; ci < n_chunks; ++ci) {
    float* dst = stb + ci * chunk_state;
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) dst[(ty * 4 + r) * NN + tx + 16 * c] = st[r][c];
    stage_rows<T, PP>(xs, XS, xb, sxs, ci * CH, S);
    stage_rows<T, NN>(Bs, NS, Bb, sbs, ci * CH, S);
    chunk_decay(dtb, H, ci * CH, S, a, v_dt, v_cum, v_ecum, v_w);
    __syncthreads();
    const float decay = expf(v_cum[CH - 1]);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) st[r][c] *= decay;
    for (int j = 0; j < CH; ++j) {
      const float wj = v_w[j];
      float xa[4], bb[8];
#pragma unroll
      for (int r = 0; r < 4; ++r) xa[r] = xs[j * XS + ty * 4 + r] * wj;
#pragma unroll
      for (int c = 0; c < 8; ++c) bb[c] = Bs[j * NS + tx + 16 * c];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) st[r][c] += xa[r] * bb[c];
    }
    __syncthreads();                 // before the next chunk overwrites the tiles
  }

  // the reverse walk, dS from the final state's cotangent
  const float* dfb = dfinal ? dfinal + ((long long)b * H + h) * PP * NN : nullptr;
  for (int e = tid; e < PP * NN; e += THREADS)
    dSs[(e / NN) * NS + e % NN] = dfb ? dfb[e] : 0.f;
  const long long part_row = (long long)H * NN;   // a row of the per-head scratch
  float dA_sum = 0.f;
  for (int ci = n_chunks - 1; ci >= 0; --ci) {
    const int r0 = ci * CH;
    stage_rows<T, PP>(xs, XS, xb, sxs, r0, S);
    stage_rows<T, PP>(dys, XS, dyb, row_hp, r0, S);
    stage_rows<T, NN>(Bs, NS, Bb, sbs, r0, S);
    stage_rows<T, NN>(Cs, NS, Cb, scs, r0, S);
    const float* src = stb + ci * chunk_state;
    for (int e = tid; e < PP * NN; e += THREADS) Ss[(e / NN) * NS + e % NN] = src[e];
    chunk_decay(dtb, H, r0, S, a, v_dt, v_cum, v_ecum, v_w);
    __syncthreads();

    // G = C B^T and D = dy x^T: rows i = ty * 4 + r, columns j = tx + 16 c
    {
      float g[4][4] = {}, d[4][4] = {};
      for (int k = 0; k < NN; ++k) {
        float ca[4], bb[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) ca[r] = Cs[(ty * 4 + r) * NS + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) bb[c] = Bs[(tx + 16 * c) * NS + k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) g[r][c] += ca[r] * bb[c];
      }
      for (int k = 0; k < PP; ++k) {
        float ya[4], xa[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) ya[r] = dys[(ty * 4 + r) * XS + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) xa[c] = xs[(tx + 16 * c) * XS + k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) d[r][c] += ya[r] * xa[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          Gs[(ty * 4 + r) * XS + tx + 16 * c] = g[r][c];
          Ds[(ty * 4 + r) * XS + tx + 16 * c] = d[r][c];
        }
    }
    __syncthreads();

    // dcum's intra-chunk sums: row i's sum_j T_ij, column j's sum_i G E D
    if (tid < CH) {
      const int i = tid;
      float s = 0.f;
      for (int j = 0; j <= i; ++j)
        s += Gs[i * XS + j] * expf(v_cum[i] - v_cum[j]) * v_dt[j] * Ds[i * XS + j];
      v_rowT[i] = s;
    } else if (tid < 2 * CH) {
      const int j = tid - CH;
      float s = 0.f;
      for (int i = j; i < CH; ++i)
        s += Gs[i * XS + j] * expf(v_cum[i] - v_cum[j]) * Ds[i * XS + j];
      v_intra[j] = s;
    }
    __syncthreads();

    // M = G . K and Q = D . K in place, K_ij = e^(cum_i - cum_j) dt_j (j <= i)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = ty * 4 + r, j = tx + 16 * c;
        const float k = j <= i ? expf(v_cum[i] - v_cum[j]) * v_dt[j] : 0.f;
        Gs[i * XS + j] *= k;
        Ds[i * XS + j] *= k;
      }
    __syncthreads();

    // dx: rows j = ty * 4 + r, columns p = tx + 16 c
    {
      float m[4][4] = {}, q[4][4] = {};
      for (int i = 0; i < CH; ++i) {
        float ma[4], ya[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) ma[r] = Gs[i * XS + ty * 4 + r];
#pragma unroll
        for (int c = 0; c < 4; ++c) ya[c] = dys[i * XS + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) m[r][c] += ma[r] * ya[c];
      }
      for (int n = 0; n < NN; ++n) {
        float ba[4], sa[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) ba[r] = Bs[(ty * 4 + r) * NS + n];
#pragma unroll
        for (int c = 0; c < 4; ++c) sa[c] = dSs[(tx + 16 * c) * NS + n];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) q[r][c] += ba[r] * sa[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = ty * 4 + r;
        if (r0 + j < S) {
          T* out = dx + ((long long)(b * (long long)S + r0 + j) * H + h) * PP;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            out[tx + 16 * c] = from_f<T>(m[r][c] + v_w[j] * q[r][c]);
        }
      }
    }

    // dC: rows i = ty * 4 + r, columns n = tx + 16 c; u_i on the way
    {
      float q[4][8] = {}, s[4][8] = {};
      for (int j = 0; j < CH; ++j) {
        float qa[4], bb[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) qa[r] = Ds[(ty * 4 + r) * XS + j];
#pragma unroll
        for (int c = 0; c < 8; ++c) bb[c] = Bs[j * NS + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) q[r][c] += qa[r] * bb[c];
      }
      for (int p = 0; p < PP; ++p) {
        float ya[4], sb[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) ya[r] = dys[(ty * 4 + r) * XS + p];
#pragma unroll
        for (int c = 0; c < 8; ++c) sb[c] = Ss[p * NS + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) s[r][c] += ya[r] * sb[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = ty * 4 + r;
        const float ec = v_ecum[i];
        float u = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) u += s[r][c] * Cs[i * NS + tx + 16 * c];
#pragma unroll
        for (int m = 8; m > 0; m >>= 1) u += __shfl_xor_sync(0xffffffffu, u, m);
        if (tx == 0) v_u[i] = ec * u;
        if (r0 + i < S) {
          float* out = partC + (b * (long long)S + r0 + i) * part_row + h * NN;
#pragma unroll
          for (int c = 0; c < 8; ++c) out[tx + 16 * c] = q[r][c] + ec * s[r][c];
        }
      }
    }

    // dB: rows j = ty * 4 + r, columns n = tx + 16 c; v_j on the way
    {
      float q[4][8] = {}, s[4][8] = {};
      for (int i = 0; i < CH; ++i) {
        float qa[4], cb[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) qa[r] = Ds[i * XS + ty * 4 + r];
#pragma unroll
        for (int c = 0; c < 8; ++c) cb[c] = Cs[i * NS + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) q[r][c] += qa[r] * cb[c];
      }
      for (int p = 0; p < PP; ++p) {
        float xa[4], sb[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) xa[r] = xs[(ty * 4 + r) * XS + p];
#pragma unroll
        for (int c = 0; c < 8; ++c) sb[c] = dSs[p * NS + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) s[r][c] += xa[r] * sb[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = ty * 4 + r;
        const float wj = v_w[j];
        float v = 0.f;
#pragma unroll
        for (int c = 0; c < 8; ++c) v += s[r][c] * Bs[j * NS + tx + 16 * c];
#pragma unroll
        for (int m = 8; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
        if (tx == 0) v_v[j] = v;
        if (r0 + j < S) {
          float* out = partB + (b * (long long)S + r0 + j) * part_row + h * NN;
#pragma unroll
          for (int c = 0; c < 8; ++c) out[tx + 16 * c] = q[r][c] + wj * s[r][c];
        }
      }
    }

    // the new dS (rows p = ty * 4 + r, columns n = tx + 16 c) and <dS, S>;
    // written after the barrier that ends every read of the old dS
    {
      float n_ds[4][8] = {};
      for (int i = 0; i < CH; ++i) {
        const float ec = v_ecum[i];
        float ya[4], cb[8];
#pragma unroll
        for (int r = 0; r < 4; ++r) ya[r] = dys[i * XS + ty * 4 + r] * ec;
#pragma unroll
        for (int c = 0; c < 8; ++c) cb[c] = Cs[i * NS + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 8; ++c) n_ds[r][c] += ya[r] * cb[c];
      }
      const float decay = expf(v_cum[CH - 1]);
      const bool carry = !(flags & FAULT_STATE_NOT_CARRIED);
      float dot = 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int e = (ty * 4 + r) * NS + tx + 16 * c;
          const float old = dSs[e];
          dot += old * Ss[e];
          n_ds[r][c] = carry ? decay * old + n_ds[r][c] : 0.f;
        }
      dot = warp_sum(dot);
      if ((tid & 31) == 0) red[tid >> 5] = dot;
      __syncthreads();
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) dSs[(ty * 4 + r) * NS + tx + 16 * c] = n_ds[r][c];
    }

    // dcum, its reverse cumulative sums, ddt and dA's part
    if (tid < CH) {
      const int k = tid;
      float dc = v_rowT[k] - v_dt[k] * v_intra[k] + v_u[k] - v_w[k] * v_v[k];
      if (k == CH - 1) {
        float dot = 0.f, wv = 0.f;
        for (int w = 0; w < THREADS / 32; ++w) dot += red[w];
        for (int j = 0; j < CH; ++j) wv += v_w[j] * v_v[j];
        dc += expf(v_cum[CH - 1]) * dot + wv;
      }
      v_dcum[k] = dc;
    }
    __syncthreads();
    if (tid < CH) {
      const int k = tid;
      float rc = 0.f;
      for (int i = CH - 1; i >= k; --i) rc += v_dcum[i];
      if (r0 + k < S)
        ddt[(b * (long long)S + r0 + k) * H + h] =
            v_intra[k] + expf(v_cum[CH - 1] - v_cum[k]) * v_v[k] + a * rc;
      dA_sum += v_dt[k] * rc;
    }
    __syncthreads();                 // before the next chunk overwrites the tiles
  }
  // dA's part of this (request, head): the two warps' sums in order
  if (tid < CH) {
    dA_sum = warp_sum(dA_sum);
    if ((tid & 31) == 0) red[tid >> 5] = dA_sum;
  }
  __syncthreads();
  if (tid == 0) dA_part[(long long)b * H + h] = red[0] + red[1];
}

// dB and dC: the heads' float32 parts summed in order (head 0 alone under
// the planted fault) and rounded to the input dtype; dA: the requests'
// parts summed in order
template <typename T>
__global__ void ssd_bwd_reduce_kernel(const float* partB, const float* partC,
                                      const float* dA_part, T* dB, T* dC, float* dA,
                                      long long rows, int batch, int H, int flags) {
  const int heads = (flags & FAULT_HEADS_NOT_SUMMED) ? 1 : H;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < rows * NN;
       i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / NN, n = i % NN;
    const float* pb = partB + row * H * NN + n;
    const float* pc = partC + row * H * NN + n;
    float sb = 0.f, sc = 0.f;
    for (int h = 0; h < heads; ++h) {
      sb += pb[(long long)h * NN];
      sc += pc[(long long)h * NN];
    }
    dB[i] = from_f<T>(sb);
    dC[i] = from_f<T>(sc);
  }
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t < H) {
    float a = 0.f;
    for (int b = 0; b < batch; ++b) a += dA_part[(long long)b * H + t];
    dA[t] = a;
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* dy, const void* dfinal, void* dx, void* ddt, void* dA, void* dB,
           void* dC, void* states, void* partB, void* partC, void* dA_part, int batch,
           int S, int H, long long sxb, long long sxs, long long sbb, long long sbs,
           long long scb, long long scs, int flags, cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  ssd_bwd_kernel<T><<<dim3(H, batch), THREADS, SMEM, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm), static_cast<const T*>(Cm),
      static_cast<const T*>(dy), static_cast<const float*>(dfinal), static_cast<T*>(dx),
      static_cast<float*>(ddt), static_cast<float*>(dA_part), static_cast<float*>(partB),
      static_cast<float*>(partC), static_cast<float*>(states), S, H, sxb, sxs, sbb, sbs,
      scb, scs, flags);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)batch * S;
  long long blocks = (rows * NN + 255) / 256;
  blocks = blocks < 4096 ? blocks : 4096;
  blocks = blocks * 256 < H ? (H + 255) / 256 : blocks;   // a thread per dA entry
  ssd_bwd_reduce_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const float*>(partB), static_cast<const float*>(partC),
      static_cast<const float*>(dA_part), static_cast<T*>(dB), static_cast<T*>(dC),
      static_cast<float*>(dA), rows, batch, H, flags);
  return (int)cudaGetLastError();
}

}  // namespace sbwd
}  // namespace

extern "C" {

// x (batch, S, H, P) read through its batch and row strides (sxb, sxs; heads
// P apart, elements adjacent), dt (batch, S, H) and A (H,) float32, B and C
// (batch, S, N) through their batch and row strides, dy (batch, S, H, P)
// contiguous in x's dtype, dfinal (batch, H, P, N) float32 or null (zero).
// Outputs: dx (batch, S, H, P) and dB, dC (batch, S, N) in x's dtype, ddt
// (batch, S, H) and dA (H,) float32, all contiguous.  Scratch, float32:
// states (batch, ceil(S / 64), H, P, N), partB and partC (batch, S, H, N),
// dA_part (batch, H).  P = 64, N = 128 and chunk = 64 only: any other
// returns cudaErrorInvalidValue and touches nothing.  dtype: 1 float16, 2
// bfloat16.  flags: the planted faults in the header, 0 on every model
// path.  Launches the main pass and the reduction on `stream`.  Returns a
// cudaError_t.
int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* dy, const void* dfinal, void* dx, void* ddt,
                 void* dA, void* dB, void* dC, void* states, void* partB, void* partC,
                 void* dA_part, int batch, int S, int H, int P, int N, int chunk,
                 long long sxb, long long sxs, long long sbb, long long sbs, long long scb,
                 long long scs, int dtype, int flags, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || P != sbwd::PP || N != sbwd::NN ||
      chunk != sbwd::CH)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SBWD_ARGS x, dt, A, Bm, Cm, dy, dfinal, dx, ddt, dA, dB, dC, states, partB, partC, \
    dA_part, batch, S, H, sxb, sxs, sbb, sbs, scb, scs, flags, st
  switch (dtype) {
    case 1: return sbwd::launch<__half>(SBWD_ARGS);
    case 2: return sbwd::launch<__nv_bfloat16>(SBWD_ARGS);
  }
#undef SBWD_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
