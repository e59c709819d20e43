// Mamba-2 chunked SSD scan, backward, for Hopper (sm_90a): dx, ddt, dA, dB
// and dC of the forward in ssd_scan.cu, from a zero initial state.
//
// Replaces no Pallas kernel.  The JAX package trains through XLA's autodiff
// of `ssd_chunked`'s lax.scan (src/repro/models/layers.py:497-559); this is
// its counterpart for the port's training path.  Its plain version is
// `ssd_scan_bwd_ref` (kernels/ssd_scan/ref.py), whose docstring derives the
// formulas below; `ssd_scan_bwd_split_ref` is this design in plain PyTorch.
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
// chunk 64, 80 heads, 4 x 1024 rows) ~32 GFLOP of products against ~143 MB
// of inputs and outputs: ~230 operations per byte, under the H100's ~295,
// so at the tensor cores' rate the bytes bound it.  A chunk-parallel
// design also moves each chunk's entering state and its cotangent (P x N
// per (request, chunk, head)) through device memory once each way: 2 x
// 168 MB at that shape in 16-bit hi + lo pieces, which the design pays to
// run the chunks in parallel.
//
// The design, Mamba-2's chunk-parallel decomposition on `wgmma`:
//   1. The state pass, one warpgroup per (half of N, head, request) (grid
//      (2, h, b); 640 blocks at mamba2's shape, all resident): the only
//      sequential part.  The recurrence never mixes columns n, so the block
//      keeps its half of S (P x 64) in registers as a wgmma accumulator and
//      walks the chunks forward, S <- e^(cum_last) S + (x . w)^T B (A =
//      (x . w)^T built in registers from the x tile and split into hi + lo,
//      B = B's TMA tile through the descriptor's transpose bit), storing
//      each chunk's entering S; then backward from the final state's
//      cotangent, dS <- e^(cum_last) dS + (dy . e^cum)^T C, storing each
//      chunk's dS.  Both go to a scratch (4, b, chunks, h, 2, P, N / 2) as
//      hi + lo pieces in the input dtype, each half of N a contiguous 8 KB
//      box: the operands of pass 2, stored and loaded by TMA.
//      B, C, x and dy arrive by TMA into a three-stage ring.
//   2. The chunk pass, one block per (head group, chunk, request), 384
//      threads in three warpgroups, the heads of its group in order with a
//      two-stage TMA ring of each head's x, dy, S and dS (80 KB a stage):
//        WG2 (the i, j side): G^T = B C^T once per block; per head
//          D^T = x dy^T, dx = w . (B dS^T) + M^T dy (M^T from registers,
//          split into hi + lo; dy through the transpose bit; dx out by a
//          TMA store), the sums of
//          T = M . D over rows and columns and ddt's direct part, and
//          Q^T = D^T . K added into a float32 sum over the heads;
//        WG0 (the C side): dC += e^cum . (dy S), and u_i = e^cum_i dy_i^T S C_i;
//        WG1 (the B side): dB += w . (x dS), and v_j = x_j^T dS B_j.
//      dC and dB stay in float32 registers across the heads: the heads are
//      summed inside the block, in head order.  After the last head the
//      intra terms take the summed Q once: dC += Q B, dB += Q^T C (Q^T's
//      hi + lo pieces in shared memory, read K-major for one and MN-major
//      for the other).  Per head, two warps take dcum's reverse sums, ddt
//      and the (request, chunk, head) part of dA.  The head groups are as
//      many as fill one wave of blocks (`head_groups`, the wrapper's), each
//      writing its float32 dB and dC parts.
//   3. A last pass sums the head groups' parts in order and rounds dB and dC
//      to the input dtype, and sums dA's parts over requests and chunks in
//      order.  Every sum has a fixed order: the gradients are bit-equal from
//      run to run (at mamba2's 64 layers any rounding change moves step 1's
//      bf16 gradients by ~3%; chip_smoke.py's BWD_GRAD_REL_L2 note).
// Every product is wgmma m64n64k16 with 16-bit inputs and float32
// accumulators.  x, dy, B and C enter as loaded (exact); each operand
// derived in float32 (x . w, dy . e^cum, S, dS, M^T, Q) is split v = hi + lo
// in the input dtype and enters as two products, as the forward's
// bfloat16 pass does: about 16 significant bits.  exp(cum_i - cum_j) only
// where j <= i (fault Q of the reference, src/repro/models/layers.py:544).
// The shapes it is built for: P = 64, N = 128, chunk 64 (mamba2-2.7b's and
// jamba's); the C entry returns an error for any other and touches nothing.
//
// `flags` (planted faults, 0 on every model path; bits 0 and 1 are the
// forward's): bit 2 resets dS at each chunk (the state's cotangent not
// carried); bit 3 takes dB and dC from head 0 alone (not summed over the
// heads).

namespace {
namespace sbwd {

constexpr int CH = 64;         // the chunk
constexpr int PP = 64;         // the head dim P
constexpr int NN = 128;        // the state width N
constexpr int ROWB = 128;      // one swizzled row: 64 16-bit values
constexpr int TILE = 2 * BOX;    // a state tile (P rows x N columns, two swizzled boxes): 16 KB
constexpr int FAULT_STATE_NOT_CARRIED = 4, FAULT_HEADS_NOT_SUMMED = 8;
// diagnostics (read, never on a path; their outputs are not valid): the
// state pass stores no state; the chunk pass loads its tiles and computes
// nothing, or loads its first two heads' tiles only and computes every
// head on them
constexpr int DIAG_NO_STATE_STORES = 16, DIAG_CHUNK_LOADS_ONLY = 64,
              DIAG_CHUNK_COMPUTE_ONLY = 128;

// (a, b) = hi + lo, each a pair of T (a in the low half)
template <typename T>
__device__ __forceinline__ void split_pair(float a, float b, uint32_t& hi, uint32_t& lo) {
  hi = pack2(a, b, T{});
  const T* h = reinterpret_cast<const T*>(&hi);
  lo = pack2(a - to_f(h[0]), b - to_f(h[1]), T{});
}

// byte offset of the pair (row r, columns 2 c2, 2 c2 + 1) in a tile of
// 64-column rows with the 128-byte swizzle
__device__ __forceinline__ int sw_pair(int r, int c2) {
  return r * ROWB + ((((c2 >> 2)) ^ (r & 7)) << 4) + (c2 & 3) * 4;
}

// the pair (row, columns col, col + 1) of a 128-byte-swizzled TMA box of
// 16-bit values, as floats (col even)
template <typename T>
__device__ __forceinline__ float2 sw_el2(const uint8_t* box, int row, int col) {
  const uint32_t raw = *reinterpret_cast<const uint32_t*>(box + sw_pair(row, col / 2));
  const T* e = reinterpret_cast<const T*>(&raw);
  return make_float2(to_f(e[0]), to_f(e[1]));
}

// ----------------------------------------------------------- 1. state pass
struct StateSmem {
  static constexpr int STAGE = 2 * BOX;                 // R's n half, then X
  static constexpr int V_OFF = 2 * STAGE;               // per stage: dt, cum, e^cum, w
  static constexpr int BAR_OFF = V_OFF + 2 * 4 * CH * 4;
  static constexpr int SMEM = BAR_OFF + 2 * 8 + 1024;
};

// Block (u, h, b): columns 64 u .. 64 u + 63 of the (P, N) state of head h,
// request b (the recurrence never mixes columns n; 640 blocks at mamba2's
// shape, five an SM: one wave).  Step gs of 2 n_chunks: the forward walk
// over chunks 0 .., then the backward walk from the last chunk.  R is B
// (forward) or C (backward), X is x or dy, the weight w or e^cum.  The
// block holds its S (or dS) half, P x 64, as an m64n64 accumulator; per
// chunk S <- e^(cum_last) S + (X . weight)^T R with A = (X . weight)^T
// built in registers from the swizzled X tile and split into hi + lo, and
// B = R's half read MN-major (16 rows of the chunk a k-step) from its TMA
// tile.  Each step's S goes out as hi + lo boxes by TMA stores, staged in
// the stage the last step consumed, which takes the next step's tiles once
// the stores have read it (two stages).
template <typename T>
__global__ void __launch_bounds__(THREADS, 5)
ssd_bwd_state_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_dy,
                     const __grid_constant__ CUtensorMap tm_b,
                     const __grid_constant__ CUtensorMap tm_c,
                     const __grid_constant__ CUtensorMap tm_planes, const float* __restrict__ dt,
                     const float* __restrict__ A, const float* __restrict__ dfinal, int S,
                     int H, int flags) {
  using L = StateSmem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* stats = reinterpret_cast<float*>(smem + L::V_OFF);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);   // [2]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, q = lane % 4;
  const int u = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nc = (S + CH - 1) / CH, steps = 2 * nc;
  const int prow = gridDim.z * nc * H * 2 * PP;   // rows of one plane
  const float a = A[h];
  auto chunk_of = [&](int gs) { return gs < nc ? gs : steps - 1 - gs; };
  auto load = [&](int gs) {
    uint8_t* st = smem + (gs % 2) * L::STAGE;
    const int t0 = chunk_of(gs) * CH;
    mbar_expect_tx(&full[gs % 2], 2 * BOX);
    tma_load_3d(st, gs < nc ? &tm_b : &tm_c, &full[gs % 2], 64 * u, t0, b);
    tma_load_4d(st + BOX, gs < nc ? &tm_x : &tm_dy, &full[gs % 2], 0, h, t0, b);
  };
  if (tid == 0) {
    mbar_init(&full[0], 1);
    mbar_init(&full[1], 1);
    mbar_fence_init();
    load(0);
  }
  // S's half or dS's (P x 64): entry e at p = 16 warp + g (+ 8 for e % 4 >=
  // 2), n = 64 u + 8 (e / 4) + 2 q + e % 2
  float st[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) st[e] = 0.f;
  float2 dtv = load_dt(dt, lane, 0, CH, S, H, b, h);
  const int p0 = 16 * warp + g;                  // this thread's rows p0, p0 + 8

  for (int gs = 0; gs < steps; ++gs) {
    const int c = chunk_of(gs);
    const bool fwd = gs < nc;
    float* sb = stats + (gs % 2) * 4 * CH;
    if (warp == 0) {
      chunk_stats(dtv, sb, sb + CH, sb + 2 * CH, sb + 3 * CH, a, lane);
      if (gs + 1 < steps) dtv = load_dt(dt, lane, chunk_of(gs + 1) * CH, CH, S, H, b, h);
    }
    if (gs == nc) {                    // the backward walk starts from dfinal
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int p = p0 + 8 * ((e >> 1) & 1), n = 64 * u + 8 * (e >> 2) + 2 * q + (e & 1);
        st[e] = dfinal ? dfinal[(((long)b * H + h) * PP + p) * NN + n] : 0.f;
      }
    }
    __syncthreads();                   // stats written; the last step's tiles read

    // the chunk's entering state (forward) or its dS (backward) as hi + lo
    // boxes (P rows x 64 columns, swizzled) in the consumed stage, stored by
    // TMA into planes 0, 1 (S) or 2, 3 (dS); then that stage takes the next
    // step's tiles
    uint8_t* out = smem + ((gs + 1) % 2) * L::STAGE;
    const bool store = !(flags & DIAG_NO_STATE_STORES);
    if (store) {
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const int off = sw_pair(p0 + 8 * ((e >> 1) & 1), 4 * (e >> 2) + q);
        split_pair<T>(st[e], st[e + 1], *reinterpret_cast<uint32_t*>(out + off),
                      *reinterpret_cast<uint32_t*>(out + BOX + off));
      }
      fence_proxy_async();
    }
    __syncthreads();
    if (tid == 0 && store) {
      const int row = (((b * nc + c) * H + h) * 2 + u) * PP + (fwd ? 0 : 2 * prow);
      tma_store_2d(&tm_planes, out, 0, row);
      tma_store_2d(&tm_planes, out + BOX, 0, row + prow);
      bulk_commit();
    }
    // once the stores have read it, the stage takes the next step's tiles
    // (issued under this step's products)
    auto refill = [&]() {
      if (tid != 0) return;
      if (store) bulk_wait_read<0>();
      if (gs + 1 < steps) load(gs + 1);
    };
    mbar_wait(&full[gs % 2], (gs / 2) & 1);
    if (!fwd && (flags & FAULT_STATE_NOT_CARRIED)) {
#pragma unroll
      for (int e = 0; e < 32; ++e) st[e] = 0.f;
      refill();
      continue;
    }

    // A = (X . weight)^T (p x j), 16 rows j of the chunk a k-step: rows p0,
    // p0 + 8, columns 16 k + 2 q (+ 1, + 8, + 9), split into hi + lo
    const float* wgt = fwd ? sb + 3 * CH : sb + 2 * CH;
    const uint8_t* stg = smem + (gs % 2) * L::STAGE;
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int k = 0; k < CH / 16; ++k)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int p = p0 + 8 * (r & 1), j = 16 * k + 2 * q + 8 * (r >> 1);
        split_pair<T>(sw_el<T>(stg + BOX, j, p) * wgt[j], sw_el<T>(stg + BOX, j + 1, p) * wgt[j + 1],
                      ah[k][r], al[k][r]);
      }
    const float decay = sb[2 * CH + CH - 1];
#pragma unroll
    for (int e = 0; e < 32; ++e) st[e] *= decay;
    const uint32_t r_addr = smem_u32(stg);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < CH / 16; ++k) {
      const uint64_t db = desc_sw128(r_addr + k * 2048, BOX, 1024);
      wgmma_rs64<1>(st, ah[k], db, 1, T{});
      wgmma_rs64<1>(st, al[k], db, 1, T{});
    }
    wgmma_commit();
    refill();
    wgmma_wait<0>();
    fence_regs(st);
  }
  if (tid == 0) bulk_wait<0>();        // the last stores written
}

// ----------------------------------------------------------- 2. chunk pass
struct ChunkSmem {
  // B's and C's tiles (two 64-column halves each), loaded once
  static constexpr int C_OFF = 0;
  static constexpr int B_OFF = 2 * BOX;
  // per head, two stages: x, dy, S hi, S lo, dS hi, dS lo
  static constexpr int ST_OFF = 4 * BOX;
  static constexpr int X = 0, DY = BOX, SH = 2 * BOX, SL = SH + TILE, DSH = SL + TILE,
                       DSL = DSH + TILE;
  static constexpr int STAGE = DSL + TILE;                     // 80 KB
  // a head's dx tile, staged for its TMA store
  static constexpr int DX_OFF = ST_OFF + 2 * STAGE;
  // Q^T's float32 sum over the heads (WG2's fragment order)
  static constexpr int Q_OFF = DX_OFF + BOX;
  static constexpr int V_OFF = Q_OFF + CH * CH * 4;            // 2 x (dt, cum, e^cum, w)
  // per head, two buffers (the head's parity): u, v, the column sums of T,
  // ddt's direct part, the 4 warps' row sums of T, and WG0's and WG1's 8
  // warps' parts of <dS, S>
  static constexpr int X_FLOATS = 8 * CH + 8;
  static constexpr int X_OFF = V_OFF + 2 * 4 * CH * 4;
  static constexpr int BAR_OFF = X_OFF + 2 * X_FLOATS * 4;
  static constexpr int SMEM = BAR_OFF + 3 * 8 + 1024;
};

template <typename T>
__global__ void __launch_bounds__(3 * THREADS, 1)
ssd_bwd_chunk_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_dy,
                     const __grid_constant__ CUtensorMap tm_b,
                     const __grid_constant__ CUtensorMap tm_c,
                     const __grid_constant__ CUtensorMap tm_planes,
                     const __grid_constant__ CUtensorMap tm_dx,
                     const float* __restrict__ dt, const float* __restrict__ A,
                     float* __restrict__ ddt,
                     float* __restrict__ dA_part, float* __restrict__ part_bc, int S,
                     int H, int flags) {
  using L = ChunkSmem;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  float* qsum = reinterpret_cast<float*>(smem + L::Q_OFF);
  uint8_t* dx_s = smem + L::DX_OFF;
  float* stats = reinterpret_cast<float*>(smem + L::V_OFF);
  // head hh's scratch: u, v, sum_i T_ij, direct_j, [4][CH] sum_j T_ij, [8]
  // parts of <dS, S>
  auto scratch = [&](int hh) {
    return reinterpret_cast<float*>(smem + L::X_OFF) + (hh % 2) * L::X_FLOATS;
  };
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);  // B/C, stage 0, 1

  const int tid = threadIdx.x, wg = tid / THREADS, t = tid % THREADS;
  const int wl = t / 32, lane = t % 32, g = lane / 4, q = lane % 4;
  const int hg = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int HG = gridDim.x, nc = gridDim.y, batch = gridDim.z;
  const int h0 = hg * H / HG, h1 = (hg + 1) * H / HG, n_heads = h1 - h0;
  const int t0 = c * CH, rows = min(CH, S - t0);
  const long prow = (long)batch * nc * H * 2 * PP;             // rows of one plane
  const uint32_t c_addr = smem_u32(smem + L::C_OFF), b_addr = smem_u32(smem + L::B_OFF);
  const uint8_t* c_s = smem + L::C_OFF;
  const uint8_t* b_s = smem + L::B_OFF;

  auto load = [&](int hh) {
    const int h = h0 + hh;
    uint8_t* st = smem + L::ST_OFF + (hh % 2) * L::STAGE;
    uint64_t* bar = &bars[1 + hh % 2];
    const int row = (int)((((long)b * nc + c) * H + h) * 2 * PP);
    mbar_expect_tx(bar, 2 * BOX + 4 * TILE);
    tma_load_4d(st + L::X, &tm_x, bar, 0, h, t0, b);
    tma_load_4d(st + L::DY, &tm_dy, bar, 0, h, t0, b);
    const int off[4] = {L::SH, L::SL, L::DSH, L::DSL};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int u = 0; u < 2; ++u)
        tma_load_2d(st + off[k] + u * BOX, &tm_planes, bar, 0, (int)(row + u * PP + k * prow));
  };
  // WG2's first thread issues every TMA load
  const bool issuer = tid == 2 * THREADS;
  if (issuer) {
    for (int i = 0; i < 3; ++i) mbar_init(&bars[i], 1);
    mbar_fence_init();
    mbar_expect_tx(&bars[0], 4 * BOX);
    tma_load_3d(smem + L::C_OFF, &tm_c, &bars[0], 0, t0, b);
    tma_load_3d(smem + L::C_OFF + BOX, &tm_c, &bars[0], 64, t0, b);
    tma_load_3d(smem + L::B_OFF, &tm_b, &bars[0], 0, t0, b);
    tma_load_3d(smem + L::B_OFF + BOX, &tm_b, &bars[0], 64, t0, b);
    load(0);
    if (n_heads > 1) load(1);
  }
  for (int i = tid; i < CH * CH; i += 3 * THREADS) qsum[i] = 0.f;
  __syncthreads();
  mbar_wait(&bars[0], 0);

  // accumulator fragment of an m64 tile: entry e at row 16 wl + g (+ 8 for
  // e % 4 >= 2), column 8 (e / 4) + 2 q + e % 2
  auto row_of = [&](int e) { return 16 * wl + g + 8 * ((e >> 1) & 1); };
  auto col_of = [&](int e) { return 8 * (e >> 2) + 2 * q + (e & 1); };
  // the per-head stats of head hh: dt, cum, e^cum, w
  auto stats_of = [&](int hh) { return stats + (hh % 2) * 4 * CH; };
  auto summed = [&](int h) { return !(flags & FAULT_HEADS_NOT_SUMMED) || h == 0; };
  // the block's barrier (every warp reaches it from one of the two role loops)
  auto sync_all = [&]() { named_sync(1, 3 * THREADS); };
  uint8_t* qt_hi = smem + L::ST_OFF;   // Q^T's pieces, over stage 0 at the end
  uint8_t* qt_lo = qt_hi + BOX;

  // dcum, its reverse cumulative sums, ddt and the (chunk, head) part of dA
  // of head hh, from its scratch and stats: one warp, rows 2 lane, 2 lane + 1
  auto head_sums = [&](int hh) {
    const int h = h0 + hh;
    const float* sb = stats_of(hh);
    const float *dts = sb, *cum = sb + CH, *ecum = sb + 2 * CH, *wgt = sb + 3 * CH;
    const float* x = scratch(hh);
    const float *xu = x, *xv = x + CH, *xcol = x + 2 * CH, *xdir = x + 3 * CH;
    const float *xrow = x + 4 * CH, *xdss = x + 8 * CH;
    float dc[2], wv = 0.f;
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const int k = 2 * lane + o;
      const float rt = xrow[k] + xrow[CH + k] + xrow[2 * CH + k] + xrow[3 * CH + k];
      dc[o] = rt - xcol[k] + xu[k] - wgt[k] * xv[k];
      wv += wgt[k] * xv[k];
    }
    wv = warp_sum(wv);
    if (lane == 31)
      dc[1] += ecum[CH - 1] * (((xdss[0] + xdss[1]) + (xdss[2] + xdss[3])) +
                               ((xdss[4] + xdss[5]) + (xdss[6] + xdss[7]))) + wv;
    // suffix sums: rc_k = sum_{i >= k} dcum_i
    float s = dc[0] + dc[1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float v = __shfl_down_sync(0xffffffffu, s, o);
      if (lane + o < 32) s += v;
    }
    float da = 0.f;
    const float a = A[h];
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const int k = 2 * lane + o;
      const float rc = o ? s - dc[0] : s;
      if (k < rows)
        ddt[((long)b * S + t0 + k) * H + h] =
            xdir[k] + __expf(cum[CH - 1] - cum[k]) * xv[k] + a * rc;
      da += dts[k] * rc;
    }
    da = warp_sum(da);
    if (lane == 0) dA_part[((long)b * nc + c) * H + h] = da;
  };

  if (wg == 2) {
    // ---- WG2, the i, j side.  G^T = B C^T (j x i), exact products
    float gt[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < NN / 16; ++kk) {
      const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
      wgmma_ss64<0, 0>(gt, desc_sw128(b_addr + off, 16, 1024),
                       desc_sw128(c_addr + off, 16, 1024), kk > 0, T{});
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(gt);
    const bool stats_warp = wl == 0;
    float2 dtv = make_float2(0.f, 0.f);
    if (stats_warp) dtv = load_dt(dt, lane, t0, CH, S, H, b, h0);

    for (int hh = 0; hh < n_heads; ++hh) {
      const int h = h0 + hh;
      float* sb = stats_of(hh);
      const float* dts = sb;
      const float* cum = sb + CH;
      const float* wgt = sb + 3 * CH;
      float* x = scratch(hh);
      if (stats_warp) {
        chunk_stats(dtv, sb, sb + CH, sb + 2 * CH, sb + 3 * CH, A[h], lane);
        if (hh + 1 < n_heads) dtv = load_dt(dt, lane, t0, CH, S, H, b, h + 1);
      }
      sync_all();                      // stats written; the last head's tiles read
      const bool loads = !(flags & DIAG_CHUNK_COMPUTE_ONLY);
      if (issuer && hh >= 1 && hh + 1 < n_heads && loads) load(hh + 1);
      const uint32_t st_addr = smem_u32(smem + L::ST_OFF + (hh % 2) * L::STAGE);
      const uint32_t x_addr = st_addr + L::X, dy_addr = st_addr + L::DY;
      if (loads || hh < 2) mbar_wait(&bars[1 + hh % 2], (hh / 2) & 1);
      if (flags & DIAG_CHUNK_LOADS_ONLY) continue;

      // D^T = x dy^T (j x i) and B dS^T (j x p): one commit
      float dT[32], dxa[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < PP / 16; ++kk)
        wgmma_ss64<0, 0>(dT, desc_sw128(x_addr + kk * 32, 16, 1024),
                         desc_sw128(dy_addr + kk * 32, 16, 1024), kk > 0, T{});
#pragma unroll
      for (int kk = 0; kk < NN / 16; ++kk) {
        // A = B (j x n), B = dS^T (N = p rows, K = n): both K-major
        const uint32_t off = (kk / 4) * BOX + (kk % 4) * 32;
        const uint64_t da = desc_sw128(b_addr + off, 16, 1024);
        wgmma_ss64<0, 0>(dxa, da, desc_sw128(st_addr + L::DSH + off, 16, 1024), kk > 0, T{});
        wgmma_ss64<0, 0>(dxa, da, desc_sw128(st_addr + L::DSL + off, 16, 1024), 1, T{});
      }
      wgmma_commit();
      if (stats_warp && hh > 0) head_sums(hh - 1);   // under the products
      wgmma_wait<0>();
      fence_regs(dT);
      fence_regs(dxa);

      // K_ij = e^(cum_i - cum_j) dt_j (j <= i), M^T = G^T . K, Q^T = D^T . K
      // (added into the heads' sum), T^T = M^T . D^T and its row and column
      // sums, ddt's direct part sum_i G^T E D^T; M^T split into A fragments
      const bool add_q = summed(h);
      uint32_t mh[4][4], ml[4][4];
      float col0 = 0.f, col1 = 0.f, dir0 = 0.f, dir1 = 0.f;
      const int j0 = 16 * wl + g;
#pragma unroll
      for (int c8 = 0; c8 < 8; ++c8) {
        // the entries 4 c8 .. 4 c8 + 3: rows j0, j0 + 8, columns i0, i0 + 1
        const int i0 = 8 * c8 + 2 * q;
        float mt[4], tt[4];
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          const int e = 4 * c8 + o, j = j0 + 8 * (o >> 1), i = i0 + (o & 1);
          const float E = i >= j ? __expf(cum[i] - cum[j]) : 0.f;
          const float K = E * dts[j];
          mt[o] = gt[e] * K;
          tt[o] = mt[o] * dT[e];
          if (add_q) qsum[e * THREADS + t] += dT[e] * K;
          const float dr = gt[e] * E * dT[e];
          if (o >> 1) {
            col1 += tt[o];
            dir1 += dr;
          } else {
            col0 += tt[o];
            dir0 += dr;
          }
        }
        split_pair<T>(mt[0], mt[1], mh[c8 >> 1][2 * (c8 & 1)], ml[c8 >> 1][2 * (c8 & 1)]);
        split_pair<T>(mt[2], mt[3], mh[c8 >> 1][2 * (c8 & 1) + 1],
                      ml[c8 >> 1][2 * (c8 & 1) + 1]);
        // columns i0, i0 + 1 summed over this warp's 16 rows
        float r0 = tt[0] + tt[2], r1 = tt[1] + tt[3];
#pragma unroll
        for (int m = 4; m < 32; m <<= 1) {
          r0 += __shfl_xor_sync(0xffffffffu, r0, m);
          r1 += __shfl_xor_sync(0xffffffffu, r1, m);
        }
        if (g == 0) {
          x[4 * CH + wl * CH + i0] = r0;
          x[4 * CH + wl * CH + i0 + 1] = r1;
        }
      }
#pragma unroll
      for (int m = 1; m < 4; m <<= 1) {
        col0 += __shfl_xor_sync(0xffffffffu, col0, m);
        col1 += __shfl_xor_sync(0xffffffffu, col1, m);
        dir0 += __shfl_xor_sync(0xffffffffu, dir0, m);
        dir1 += __shfl_xor_sync(0xffffffffu, dir1, m);
      }
      if (q == 0) {
        x[2 * CH + j0] = col0;
        x[2 * CH + j0 + 8] = col1;
        x[3 * CH + j0] = dir0;
        x[3 * CH + j0 + 8] = dir1;
      }

      // dx = w . (B dS^T) + M^T dy: A = M^T from registers (hi, lo), B = dy
      // (K = i rows, N = p) MN-major
#pragma unroll
      for (int e = 0; e < 32; ++e) dxa[e] *= wgt[row_of(e)];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < CH / 16; ++k) {
        const uint64_t db = desc_sw128(dy_addr + k * 2048, BOX, 1024);
        wgmma_rs64<1>(dxa, mh[k], db, 1, T{});
        wgmma_rs64<1>(dxa, ml[k], db, 1, T{});
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(dxa);
      // dx rounded to T into its staging box (the last head's store has read
      // it), then one TMA store; rows past s are not written
      if (issuer) bulk_wait_read<0>();
      named_sync(2, THREADS);
#pragma unroll
      for (int e = 0; e < 32; e += 2)
        *reinterpret_cast<uint32_t*>(dx_s + sw_pair(row_of(e), col_of(e) / 2)) =
            pack2(dxa[e], dxa[e + 1], T{});
      fence_proxy_async();
      named_sync(2, THREADS);
      if (issuer) {
        tma_store_4d(&tm_dx, dx_s, 0, h, t0, b);
        bulk_commit();
      }
    }

    // the last head's sums, then Q^T's float32 sum split into hi + lo,
    // [j rows][i columns], swizzled, over stage 0
    sync_all();                        // every head's tiles read and scratch written
    if (stats_warp) head_sums(n_heads - 1);
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      uint32_t hi, lo;
      split_pair<T>(qsum[e * THREADS + t], qsum[(e + 1) * THREADS + t], hi, lo);
      const int off = sw_pair(row_of(e), col_of(e) / 2);
      *reinterpret_cast<uint32_t*>(qt_hi + off) = hi;
      *reinterpret_cast<uint32_t*>(qt_lo + off) = lo;
    }
    fence_proxy_async();
    sync_all();
    if (issuer) bulk_wait<0>();        // the last dx written
    return;
  }

  // ---- WG0, the C side: dC (i x n); WG1, the B side: dB (j x n), float32
  // across the heads
  float acc[2][32];
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[u][e] = 0.f;
  const uint8_t* rs = wg == 0 ? c_s : b_s;       // the rows' C or B
  for (int hh = 0; hh < n_heads; ++hh) {
    const int h = h0 + hh;
    sync_all();                        // stats written; the last head's tiles read
    float* x = scratch(hh);
    const float* sb = stats_of(hh);
    const float* sc = wg == 0 ? sb + 2 * CH : sb + 3 * CH;   // e^cum or w
    const uint8_t* stg = smem + L::ST_OFF + (hh % 2) * L::STAGE;
    const uint32_t st_addr = smem_u32(stg);
    if (!(flags & DIAG_CHUNK_COMPUTE_ONLY) || hh < 2)
      mbar_wait(&bars[1 + hh % 2], (hh / 2) & 1);
    if (flags & DIAG_CHUNK_LOADS_ONLY) continue;

    // WG0: dy S (i x n); WG1: x dS (j x n).  A = dy or x (K = p) K-major,
    // B = the state tile (K = p rows, N = n) MN-major, hi and lo
    const uint32_t a_addr = st_addr + (wg == 0 ? L::DY : L::X);
    const uint32_t s_addr = st_addr + (wg == 0 ? L::SH : L::DSH);
    float tmp[2][32];
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int kk = 0; kk < PP / 16; ++kk) {
        const uint64_t da = desc_sw128(a_addr + kk * 32, 16, 1024);
        wgmma_ss64<0, 1>(tmp[u], da, desc_sw128(s_addr + u * BOX + kk * 2048, BOX, 1024),
                         kk > 0, T{});
        wgmma_ss64<0, 1>(tmp[u], da,
                         desc_sw128(s_addr + TILE + u * BOX + kk * 2048, BOX, 1024), 1, T{});
      }
    wgmma_commit();
    {                                  // <dS, S> meanwhile, half the raw tiles each
      const uint4* sh = reinterpret_cast<const uint4*>(stg + L::SH);
      const uint4* sl = reinterpret_cast<const uint4*>(stg + L::SL);
      const uint4* dh = reinterpret_cast<const uint4*>(stg + L::DSH);
      const uint4* dl = reinterpret_cast<const uint4*>(stg + L::DSL);
      float dot = 0.f;
      for (int v = wg * (TILE / 32) + t; v < (wg + 1) * (TILE / 32); v += THREADS) {
        const uint4 a0 = sh[v], a1 = sl[v], b0 = dh[v], b1 = dl[v];
        const T* e0 = reinterpret_cast<const T*>(&a0);
        const T* e1 = reinterpret_cast<const T*>(&a1);
        const T* f0 = reinterpret_cast<const T*>(&b0);
        const T* f1 = reinterpret_cast<const T*>(&b1);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          dot += (to_f(e0[k]) + to_f(e1[k])) * (to_f(f0[k]) + to_f(f1[k]));
      }
      dot = warp_sum(dot);
      if (lane == 0) x[8 * CH + 4 * wg + wl] = dot;
    }
    wgmma_wait<0>();
    fence_regs(tmp[0]);
    fence_regs(tmp[1]);
    // u_i = e^cum_i sum_n (dy S)_in C_in (WG0), v_j = sum_n (x dS)_jn B_jn
    // (WG1); the product scaled by its rows' e^cum or w, added into dC or dB
    float r0 = 0.f, r1 = 0.f;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 32; e += 2) {
        const float2 rv = sw_el2<T>(rs + u * BOX, row_of(e), col_of(e));
        const float y = tmp[u][e] * rv.x + tmp[u][e + 1] * rv.y;
        if ((e >> 1) & 1) r1 += y;
        else r0 += y;
      }
#pragma unroll
    for (int m = 1; m < 4; m <<= 1) {
      r0 += __shfl_xor_sync(0xffffffffu, r0, m);
      r1 += __shfl_xor_sync(0xffffffffu, r1, m);
    }
    if (q == 0) {
      const int i0 = 16 * wl + g;
      float* dst = x + (wg == 0 ? 0 : CH);     // u or v
      dst[i0] = wg == 0 ? sc[i0] * r0 : r0;
      dst[i0 + 8] = wg == 0 ? sc[i0 + 8] * r1 : r1;
    }
    if (summed(h)) {
#pragma unroll
      for (int u = 0; u < 2; ++u)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[u][e] += sc[row_of(e)] * tmp[u][e];
    }
  }

  // the intra terms, once: dC += Q B (WG0), dB += Q^T C (WG1)
  sync_all();
  sync_all();                          // Q^T's pieces written
  {
    // WG0: A = Q (i x j), Q^T's tile read MN-major; B = B's tile (K = j rows)
    // MN-major.  WG1: A = Q^T (j x i) K-major; B = C's tile MN-major
    const uint32_t qh = smem_u32(qt_hi), ql = smem_u32(qt_lo);
    const uint32_t r_addr = wg == 0 ? b_addr : c_addr;
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int k = 0; k < CH / 16; ++k) {
        const uint64_t db = desc_sw128(r_addr + u * BOX + k * 2048, BOX, 1024);
        if (wg == 0) {
          wgmma_ss64<1, 1>(acc[u], desc_sw128(qh + k * 2048, BOX, 1024), db, 1, T{});
          wgmma_ss64<1, 1>(acc[u], desc_sw128(ql + k * 2048, BOX, 1024), db, 1, T{});
        } else {
          wgmma_ss64<0, 1>(acc[u], desc_sw128(qh + k * 32, 16, 1024), db, 1, T{});
          wgmma_ss64<0, 1>(acc[u], desc_sw128(ql + k * 32, 16, 1024), db, 1, T{});
        }
      }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
  }
  // this head group's float32 part of dC (plane 0) or dB (plane 1)
  float* out = part_bc + (wg == 0 ? 0 : (long)batch * S * HG * NN);
#pragma unroll
  for (int u = 0; u < 2; ++u)
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const int r = row_of(e);
      if (r < rows)
        *reinterpret_cast<float2*>(out + (((long)b * S + t0 + r) * HG + hg) * NN + 64 * u +
                                   col_of(e)) = make_float2(acc[u][e], acc[u][e + 1]);
    }
}

// ----------------------------------------------------------- 3. last pass
// dC and dB: the head groups' float32 parts summed in order and rounded to
// the input dtype; dA: the (request, chunk) parts summed in order
template <typename T>
__global__ void ssd_bwd_sum_kernel(const float* __restrict__ part_bc,
                                   const float* __restrict__ dA_part, T* __restrict__ dB,
                                   T* __restrict__ dC, float* __restrict__ dA, long rows,
                                   int HG, int parts, int H) {
  for (long i = blockIdx.x * (long)blockDim.x + threadIdx.x; i < rows * NN;
       i += (long)gridDim.x * blockDim.x) {
    const long row = i / NN, n = i % NN;
    const float* pc = part_bc + row * HG * NN + n;
    const float* pb = pc + rows * HG * NN;
    float sc = 0.f, sb = 0.f;
    for (int k = 0; k < HG; ++k) {
      sc += pc[(long)k * NN];
      sb += pb[(long)k * NN];
    }
    dC[i] = from_f<T>(sc);
    dB[i] = from_f<T>(sb);
  }
  const long t = blockIdx.x * (long)blockDim.x + threadIdx.x;
  if (t < H) {
    float a = 0.f;
    for (int k = 0; k < parts; ++k) a += dA_part[(long)k * H + t];
    dA[t] = a;
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm, const void* Cm,
           const void* dy, const void* dfinal, void* dx, void* ddt, void* dA, void* dB,
           void* dC, void* planes, void* part_bc, void* dA_part, int batch, int S, int H,
           int HG, long long sxb, long long sxs, long long sbb, long long sbs,
           long long scb, long long scs, CUtensorMapDataType dtype, int flags,
           cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    cudaError_t err = cudaFuncSetAttribute(ssd_bwd_state_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           StateSmem::SMEM);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_state_kernel<T>,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(ssd_bwd_chunk_kernel<T>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, ChunkSmem::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  const int nc = (S + CH - 1) / CH;
  // x as (P, H, S, b) and dy likewise (contiguous), boxes of one head's 64
  // rows; B and C as (N, S, b) in 64 x 64 boxes; the state planes as
  // 64-column rows, a box one (request, chunk, head, half of N)'s P rows.
  // All with the
  // 128-byte swizzle.  Strides in bytes; a batch of one never steps its
  // batch stride
  const cuuint64_t x_dims[4] = {(cuuint64_t)PP, (cuuint64_t)H, (cuuint64_t)S,
                                (cuuint64_t)batch};
  const cuuint64_t x_str[3] = {(cuuint64_t)PP * 2, (cuuint64_t)sxs * 2,
                               (cuuint64_t)(batch > 1 ? sxb : S * sxs) * 2};
  const cuuint64_t dy_str[3] = {(cuuint64_t)PP * 2, (cuuint64_t)H * PP * 2,
                                (cuuint64_t)S * H * PP * 2};
  const cuuint32_t x_box[4] = {64, 1, CH, 1};
  const cuuint64_t n_dims[3] = {(cuuint64_t)NN, (cuuint64_t)S, (cuuint64_t)batch};
  const cuuint64_t b_str[2] = {(cuuint64_t)sbs * 2,
                               (cuuint64_t)(batch > 1 ? sbb : S * sbs) * 2};
  const cuuint64_t c_str[2] = {(cuuint64_t)scs * 2,
                               (cuuint64_t)(batch > 1 ? scb : S * scs) * 2};
  const cuuint32_t n_box[3] = {64, CH, 1};
  const cuuint64_t p_dims[2] = {64, (cuuint64_t)4 * batch * nc * H * 2 * PP};
  const cuuint64_t p_str[1] = {128};
  const cuuint32_t p_box[2] = {64, PP};
  CUtensorMap tx, tdy, tdx, tb, tc, tp;
  if (!make_map(&tx, x, dtype, 4, x_dims, x_str, x_box) ||
      !make_map(&tdy, dy, dtype, 4, x_dims, dy_str, x_box) ||
      !make_map(&tdx, dx, dtype, 4, x_dims, dy_str, x_box) ||
      !make_map(&tb, Bm, dtype, 3, n_dims, b_str, n_box) ||
      !make_map(&tc, Cm, dtype, 3, n_dims, c_str, n_box) ||
      !make_map(&tp, planes, dtype, 2, p_dims, p_str, p_box))
    return (int)cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  ssd_bwd_state_kernel<T><<<dim3(2, H, batch), THREADS, StateSmem::SMEM, stream>>>(
      tx, tdy, tb, tc, tp, dtf, af, static_cast<const float*>(dfinal), S, H, flags);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssd_bwd_chunk_kernel<T><<<dim3(HG, nc, batch), 3 * THREADS, ChunkSmem::SMEM, stream>>>(
      tx, tdy, tb, tc, tp, tdx, dtf, af, static_cast<float*>(ddt),
      static_cast<float*>(dA_part), static_cast<float*>(part_bc), S, H, flags);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)batch * S;
  long long blocks = (rows * NN + 255) / 256;
  blocks = blocks < 4096 ? blocks : 4096;
  blocks = blocks * 256 < H ? (H + 255) / 256 : blocks;   // a thread per dA entry
  ssd_bwd_sum_kernel<T><<<(unsigned)blocks, 256, 0, stream>>>(
      static_cast<const float*>(part_bc), static_cast<const float*>(dA_part),
      static_cast<T*>(dB), static_cast<T*>(dC), static_cast<float*>(dA), rows, HG,
      batch * nc, H);
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
// (batch, S, H) and dA (H,) float32, all contiguous.  Scratch: planes (4,
// batch, ceil(S / 64), H, 2, P, N / 2) in x's dtype (each chunk's entering state
// and its cotangent, hi and lo pieces), part_bc (2, batch, S, head_groups,
// N) and dA_part (batch, ceil(S / 64), H) float32.  head_groups: how many
// blocks share a chunk's heads, 1 .. H.  P = 64, N = 128 and chunk = 64
// only: any other returns cudaErrorInvalidValue and touches nothing.
// dtype: 1 float16, 2 bfloat16.  x, B, C 16-byte aligned with strides of
// multiples of 8 elements (TMA).  flags: the planted faults in the header,
// 0 on every model path.  Launches the state pass, the chunk pass and the
// last pass on `stream`.  Returns a cudaError_t.
int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* dy, const void* dfinal, void* dx, void* ddt,
                 void* dA, void* dB, void* dC, void* planes, void* part_bc, void* dA_part,
                 int batch, int S, int H, int P, int N, int chunk, int head_groups,
                 long long sxb, long long sxs, long long sbb, long long sbs, long long scb,
                 long long scs, int dtype, int flags, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(x) |
                          reinterpret_cast<uintptr_t>(Bm) |
                          reinterpret_cast<uintptr_t>(Cm) |
                          reinterpret_cast<uintptr_t>(dy) |
                          reinterpret_cast<uintptr_t>(planes);
  const long long strides = (batch > 1 ? sxb | sbb | scb : 0) | sxs | sbs | scs;
  if (batch <= 0 || S <= 0 || H <= 0 || P != sbwd::PP || N != sbwd::NN ||
      chunk != sbwd::CH || head_groups < 1 || head_groups > H || align % 16 != 0 ||
      strides % 8 != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SBWD_ARGS x, dt, A, Bm, Cm, dy, dfinal, dx, ddt, dA, dB, dC, planes, part_bc, \
    dA_part, batch, S, H, head_groups, sxb, sxs, sbb, sbs, scb, scs
  switch (dtype) {
    case 1: return sbwd::launch<__half>(SBWD_ARGS, CU_TENSOR_MAP_DATA_TYPE_FLOAT16, flags, st);
    case 2: return sbwd::launch<__nv_bfloat16>(SBWD_ARGS, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                               flags, st);
  }
#undef SBWD_ARGS
  return (int)cudaErrorInvalidValue;
}

// the dynamic shared memory (bytes) of the state pass (0) or the chunk pass (1)
int ssd_scan_bwd_smem(int pass) {
  return pass == 0 ? sbwd::StateSmem::SMEM : sbwd::ChunkSmem::SMEM;
}

}  // extern "C"
