// Causal, sliding-window and bidirectional GQA flash-attention forward
// (prefill) for Hopper, sm_90a, on the tensor cores.
//
// Replaces the TPU kernel `flash_attention` (body `_flash_kernel`) of
// src/repro/kernels/flash_attention/kernel.py, in all three of its modes.
//
// What it computes: o[b, i, h] = softmax_j(q[b, i, h] . k[b, j, h/G] / sqrt(D))
// . v[b, j, h/G] over keys j < Sk, and j <= i (causal, Sq = Sk), and with a
// window W > 0 also j > i - W (sliding window, the windowed family's local
// layers), for q (B, Sq, H, D) and k/v (B, Sk, KVH, D) read in place,
// without a transpose.  The non-causal mode masks only the ragged ends: the
// encoder-decoder family's encoder (Sq = Sk) and its decoder's cross
// attention over the encoder's frames (Sq != Sk).  Online softmax with
// float32 statistics; scores never reach device memory.
//
// What bounds it on this card: at prefill lengths the work is
// 4 * S^2/2 * H * D operations (4 * S * W * H * D in the window mode,
// 4 * Sq * Sk * H * D non-causal) against (3 + 1) * S * H * D * 2 bytes,
// far above the H100's ~295 operations per byte, so it is bound by
// operations, and only the tensor cores (989 TFLOP/s in 16 bits) can
// approach that bound.
//
// The design.  One block per (128-query tile, head, request), 384 threads:
// two consumer warpgroups of 64 query rows each and a producer warpgroup.
// The producer hands its registers to the consumers (setmaxnreg: 40 and
// 232 a thread), which at D = 256 hold a 64 x 256 float32 O accumulator.
//   - The producer's first thread loads the Q tile once and then each K/V
//     tile with TMA (cp.async.bulk.tensor, 4-D maps over (D, heads, S, B),
//     so a ragged tile zero-fills at the request's end), into a ring of two
//     stages guarded by "full" and "empty" mbarriers.  The tensor maps are
//     encoded on the host through cudaGetDriverEntryPoint and passed as
//     __grid_constant__ parameters, so the library needs no -lcuda.
//   - Tiles live in shared memory as 64-column blocks with the 128-byte
//     swizzle, the layout TMA writes and wgmma's descriptors read.  Q and K
//     are K-major operands; V is read as an MN-major operand (the
//     descriptor's 16-bit transpose bit), so it needs no transposed copy.
//   - S = Q.K^T runs as wgmma m64nBKk16 (BK = 128 keys for D <= 128, 64 at
//     D = 256), A and B from shared memory, the accumulator in registers.
//     Each row's max and sum are a two-shuffle reduction over the quad of
//     threads that holds the row in the accumulator fragment; the sum stays
//     a per-thread partial until the end.
//   - P is rounded to the input dtype in registers, where the accumulator
//     fragment of 16 keys is exactly wgmma's register A fragment, and
//     O += P.V runs as wgmma m64nDk16 with A from registers.
//   - Causal: key tiles past the block's last live query are skipped, and
//     in the window mode so are the tiles wholly before its first query's
//     window (the TPU kernel's tile skip); non-causal: every key tile up to
//     Sk.  Masks (the ragged tail, causality, the window) are applied only
//     on tiles that cross one.  Masked scores
//     take the finite basis -1e30 and contribute exactly zero.  Query tiles
//     are scheduled longest first.
//   - D is instantiated at 64, 128 and 256; any multiple of 16 up to 256
//     takes the next instantiation, its columns past D zero-filled by TMA
//     (zeros add nothing to a dot product) and not stored.
// With a non-null `lse` the epilogue also writes each row's m + log l
// (natural units, float32), the input of the backward (flash_attention_bwd.cuh,
// included at the end of this file).
// Shared memory: Q 16/32/64 KB plus two stages of K and V, 80/160/192 KB at
// D = 64/128/256, one block per SM.  The one new rounding against the
// float32 plain version is P in 16 bits before P.V.
#include "../../hopper.cuh"

namespace {

constexpr int BQ = 128;          // queries per block, 64 per consumer warpgroup
constexpr int CONSUMERS = 256;   // two warpgroups
constexpr int THREADS = CONSUMERS + 128;  // and the producer warpgroup
// registers a thread of each role keeps after setmaxnreg: the block starts
// at 168 (65,536 / 384); the producer gives back what the consumers take,
// 128 x 40 + 256 x 232 = 64,512
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr int STAGES = 2;
constexpr int MAX_D = 256;
constexpr float NEG_INF = -1e30f;
constexpr int ROW_BYTES = 128;   // one swizzled row: 64 16-bit values

// ---------------------------------------------------------------- PTX helpers
// (the rest, mbarriers, TMA, descriptors, live in kernels/hopper.cuh)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// wgmma m64nNk16, float32 accumulator.  _ss: A and B from shared memory
// (both K-major); _rs: A from registers, B MN-major (transposed).  `acc` 0
// overwrites the accumulator.  The last argument selects the input type.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                                  int acc, __half) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                  int acc, __half) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db, __half) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t db, __half) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                                  uint64_t db, __half) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.f16.f16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                                  int acc, __nv_bfloat16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db,
                                                  int acc, __nv_bfloat16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4],
                                                  uint64_t db, __nv_bfloat16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                                  uint64_t db, __nv_bfloat16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                                  uint64_t db, __nv_bfloat16) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// S = Q.K^T for one K tile: DP/16 steps of 16 along D
template <typename T, int BK, int DP>
__device__ __forceinline__ void qk_tile(float (&s)[BK / 2], uint32_t q_addr,
                                        uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint64_t da = desc_sw128(q_addr + (kk >> 2) * BQ * ROW_BYTES + (kk & 3) * 32,
                                   16, 1024);
    const uint64_t db = desc_sw128(k_addr + (kk >> 2) * BK * ROW_BYTES + (kk & 3) * 32,
                                   16, 1024);
    if constexpr (BK == 128) wgmma_ss_n128(s, da, db, kk > 0, T{});
    else wgmma_ss_n64(s, da, db, kk > 0, T{});
  }
}

// O += P.V for one V tile: BK/16 steps of 16 keys; V's 64-column blocks lie
// BK rows apart (the descriptor's leading offset), its 8-key groups 1 KB apart
template <typename T, int BK, int DP>
__device__ __forceinline__ void pv_tile(float (&o)[DP / 2], const uint32_t (&p)[BK / 16][4],
                                        uint32_t v_addr) {
#pragma unroll
  for (int t = 0; t < BK / 16; ++t) {
    const uint64_t db = desc_sw128(v_addr + t * 2048, BK * ROW_BYTES, 1024);
    if constexpr (DP == 64) wgmma_rs_n64(o, p[t], db, T{});
    else if constexpr (DP == 128) wgmma_rs_n128(o, p[t], db, T{});
    else wgmma_rs_n256(o, p[t], db, T{});
  }
}

template <int DP>
struct Tiles {
  static constexpr int BK = DP <= 128 ? 128 : 64;       // keys per K/V tile
  static constexpr int NB = DP / 64;                     // 64-column blocks
  static constexpr int Q_BYTES = NB * BQ * ROW_BYTES;
  static constexpr int KV_BYTES = NB * BK * ROW_BYTES;   // one K or V tile
  static constexpr int BAR_OFF = Q_BYTES + 2 * STAGES * KV_BYTES;
  // + the barriers, + slack to align the base to the 1 KB swizzle atom
  static constexpr int SMEM = BAR_OFF + 64 + 1024;
};

// DP: the instantiated head width (64, 128 or 256), D <= DP the real one
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int KVH, int D,
                 int window, int causal, float scale_log2) {
  using L = Tiles<DP>;
  constexpr int BK = L::BK;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* q_s = smem;
  uint8_t* k_s = smem + L::Q_BYTES;                        // [STAGES][KV_BYTES]
  uint8_t* v_s = k_s + STAGES * L::KV_BYTES;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;                               // [STAGES]
  uint64_t* empty = bars + 1 + STAGES;                     // [STAGES]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;        // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KVH);
  // causal: keys past the tile's last live query are masked for every row,
  // and with a window so are keys before the first query's window: skip
  // those tiles.  Non-causal: every key (the wrapper refuses a window)
  const int k_end = causal ? min(q0 + BQ, Sk) : Sk;
  const int k_begin = window > 0 ? max(0, q0 - window + 1) / BK * BK : 0;
  const int n_tiles = (k_end - k_begin + BK - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {                          // the producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == CONSUMERS) {
      mbar_expect_tx(q_full, L::Q_BYTES);
      for (int nb = 0; nb < L::NB; ++nb)
        tma_load_4d(q_s + nb * BQ * ROW_BYTES, &tm_q, q_full, nb * 64, h, q0, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int st = it % STAGES;
        if (it >= STAGES) mbar_wait(&empty[st], (it / STAGES - 1) & 1);
        const int k0 = k_begin + it * BK;
        mbar_expect_tx(&full[st], 2 * L::KV_BYTES);
        for (int nb = 0; nb < L::NB; ++nb) {
          const int off = st * L::KV_BYTES + nb * BK * ROW_BYTES;
          tma_load_4d(k_s + off, &tm_k, &full[st], nb * 64, kvh, k0, b);
          tma_load_4d(v_s + off, &tm_v, &full[st], nb * 64, kvh, k0, b);
        }
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  // a consumer warpgroup: query rows row_lo .. row_lo + 63.  In the m64nN
  // accumulator fragment a thread holds rows r0 (entries i % 4 < 2) and
  // r0 + 8 (the others), columns 8 * (i / 4) + cq + (i % 2)
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int lane = t % 32;
  const int row_lo = q0 + 64 * wg;
  const int r0 = row_lo + 16 * (t / 32) + lane / 4, r1 = r0 + 8;
  const int cq = 2 * (lane % 4);
  const uint32_t q_addr = smem_u32(q_s) + 64 * wg * ROW_BYTES;

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;   // l: this thread's part

  mbar_wait(q_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = it % STAGES;
    const int k0 = k_begin + it * BK;
    mbar_wait(&full[st], (it / STAGES) & 1);

    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    wgmma_fence();
    qk_tile<T, BK, DP>(s, q_addr, smem_u32(k_s + st * L::KV_BYTES));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // the tile crosses the diagonal, the ragged end or the window's edge
    const bool masked = (causal && k0 + BK - 1 > row_lo) || k0 + BK > Sk ||
                        (window > 0 && k0 <= row_lo + 63 - window);
    if (masked) {
#pragma unroll
      for (int i = 0; i < BK / 2; ++i) {
        const int row = (i % 4) < 2 ? r0 : r1;
        const int col = k0 + 8 * (i / 4) + cq + (i % 2);
        const bool ok = col < Sk && (!causal || col <= row) &&
                        (window <= 0 || col > row - window);
        if (!ok) s[i] = NEG_INF;
      }
    }
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      if ((i % 4) < 2) mx0 = fmaxf(mx0, s[i]);
      else mx1 = fmaxf(mx1, s[i]);
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float c0 = ex2((m0 - mx0) * scale_log2), c1 = ex2((m1 - mx1) * scale_log2);
    m0 = mx0;
    m1 = mx1;
    const float mc0 = mx0 * scale_log2, mc1 = mx1 * scale_log2;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const bool lo = (i % 4) < 2;
      float p = ex2(fmaf(s[i], scale_log2, lo ? -mc0 : -mc1));
      if (masked && s[i] == NEG_INF) p = 0.f;   // a row with no live key yet
      s[i] = p;
      if (lo) sum0 += p;
      else sum1 += p;
    }
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] *= (i % 4) < 2 ? c0 : c1;
    // 16 keys of the accumulator fragment are one register A fragment
    uint32_t p16[BK / 16][4];
#pragma unroll
    for (int k = 0; k < BK / 16; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        p16[k][j] = pack2(s[8 * k + 2 * j], s[8 * k + 2 * j + 1], T{});

    wgmma_fence();
    pv_tile<T, BK, DP>(acc, p16, smem_u32(v_s + st * L::KV_BYTES));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[st]);                   // this thread is done with the stage
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  // lse = m + log l of each row in natural units, (B, H, Sq) float32, for
  // the backward: one thread of the quad that holds the row writes it
  if (lse != nullptr && lane % 4 == 0) {
    float* lb = lse + ((long)b * H + h) * Sq;
    constexpr float LN2 = 0.6931471805599453f;
    if (r0 < Sq) lb[r0] = (m0 * scale_log2 + log2f(fmaxf(l0, 1e-30f))) * LN2;
    if (r1 < Sq) lb[r1] = (m1 * scale_log2 + log2f(fmaxf(l1, 1e-30f))) * LN2;
  }
  const long q_row = (long)H * D;              // stride between positions of o
  T* ob = o + (long)b * Sq * q_row + (long)h * D;
#pragma unroll
  for (int c = 0; c < DP / 8; ++c) {
    const int col = 8 * c + cq;
    if (col >= D) continue;
    if (r0 < Sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * q_row + col) =
          pack2(acc[4 * c] * inv0, acc[4 * c + 1] * inv0, T{});
    if (r1 < Sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * q_row + col) =
          pack2(acc[4 * c + 2] * inv1, acc[4 * c + 3] * inv1, T{});
  }
}

// ------------------------------------------------------------------ host side
// a (B, S, heads, D) tensor as a 4-D map {D, heads, S, B}; a box is `rows`
// positions of one head, 64 columns, swizzled by 128 bytes
bool make_map(CUtensorMap* map, const void* base, CUtensorMapDataType dt, int B, int S,
              int heads, int D, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)heads, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)heads * D * 2,
                                 (cuuint64_t)S * heads * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, dt, 4, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int DP>
int launch_dp(const void* q, const void* k, const void* v, void* o, float* lse, int B,
              int Sq, int Sk,
              int H, int KVH, int D, int window, int causal, CUtensorMapDataType dt,
              cudaStream_t stream) {
  using L = Tiles<DP>;
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, L::SMEM);
    if (err != cudaSuccess) return (int)err;
    attr = true;
  }
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, dt, B, Sq, H, D, BQ) ||
      !make_map(&tk, k, dt, B, Sk, KVH, D, L::BK) ||
      !make_map(&tv, v, dt, B, Sk, KVH, D, L::BK))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  flash_fwd_kernel<T, DP><<<grid, THREADS, L::SMEM, stream>>>(
      tq, tk, tv, static_cast<T*>(o), lse, Sq, Sk, H, KVH, D, window, causal,
      1.4426950408889634f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int Sq,
           int Sk, int H, int KVH, int D, int window, int causal, CUtensorMapDataType dt,
           cudaStream_t stream) {
#define DP_ARGS q, k, v, o, lse, B, Sq, Sk, H, KVH, D, window, causal, dt, stream
  if (D <= 64) return launch_dp<T, 64>(DP_ARGS);
  if (D <= 128) return launch_dp<T, 128>(DP_ARGS);
  return launch_dp<T, 256>(DP_ARGS);
#undef DP_ARGS
}

}  // namespace

extern "C" {

// q (B, Sq, H, D), k/v (B, Sk, KVH, D).  causal 1: keys j <= i (Sq = Sk),
// and window > 0 a sliding window of that many keys (the query's own
// included); causal 0: every key j < Sk, no window.  dtype: 1 float16,
// 2 bfloat16.  q, k, v: 16-byte aligned.  lse: null, or (B, H, Sq) float32
// that receives each query row's log-sum-exp of its scaled scores (the
// backward's input).  Returns a cudaError_t.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int Sq, int Sk, int H, int KVH, int D,
                        int window, int causal, int dtype, void* stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(q) |
                          reinterpret_cast<uintptr_t>(k) |
                          reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(o);
  if (D > MAX_D || D % 16 != 0 || D <= 0 || KVH <= 0 || H % KVH != 0 || Sq <= 0 ||
      Sk <= 0 || window < 0 || align % 16 != 0 || (causal && Sq != Sk) ||
      (!causal && window > 0))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 1: return launch<__half>(q, k, v, o, static_cast<float*>(lse), B, Sq, Sk, H,
                                  KVH, D, window, causal,
                                  CU_TENSOR_MAP_DATA_TYPE_FLOAT16, st);
    case 2: return launch<__nv_bfloat16>(q, k, v, o, static_cast<float*>(lse), B, Sq, Sk,
                                         H, KVH, D, window, causal,
                                         CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"

// the backward (the training path's gradient), in the same library
#include "flash_attention_bwd.cuh"
