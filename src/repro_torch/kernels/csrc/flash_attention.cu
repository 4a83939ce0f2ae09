// Blocked online-softmax (flash) attention for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py::
// flash_attention (Pallas body `_kernel`, wrapped by src/repro/kernels/
// ops.py::flash_attention).  For q (B, S, H, hd) and k, v (B, S, KV, hd) in
// T (float32 or bfloat16), in the model's layout, it computes per (b, h)
//
//     o = softmax(q k^T * hd^-1/2 + mask) v      (k, v of KV head h / (H/KV))
//
// with mask -1e30 where k > q (causal) or q - k >= window (window > 0) or
// k >= S, the running max, sum and output in float32, the denominator
// clamped at 1e-30 and o written in T: the TPU kernel's arithmetic.
//
// What bounds it on the card.  Operations: 4 * hd flops per unmasked
// (query, key) pair.  At the recurrentgemma-9b path shape (B 2, H 16, KV 1,
// S 4096, hd 256, window 2048, bfloat16) there are 201.4 M pairs, 206
// GFLOP: 0.208 ms at the 989 TFLOP/s bfloat16 tensor-core peak.  Bytes:
// q and o (67 MB each) and the unrepeated k and v (4.2 MB each), 142 MB,
// 0.042 ms.  So it is bound by operations, on the tensor cores, and only
// wgmma reaches their full rate.
//
// What the design does about it.  Both kernels below walk, for one block
// per (b, h, query tile), the key tiles from the first one the window can
// reach to the causal diagonal, computing that range instead of testing
// every tile (the TPU kernel's whole-tile skip).  The GQA repeat is not
// materialized: the block reads KV head h / (H/KV).  A ragged sequence
// tail is masked, not padded.
//
// bfloat16 (the LM path): `attention_wgmma_kernel`, three warpgroups on
// 128 query rows.  Warpgroup 2 is the producer: it gives up registers
// (setmaxnreg 40) and one of its threads issues TMA loads, q once, then
// the K and the V tiles of 64 keys into two rings of kStages stages, each
// stage guarded by a full and an empty mbarrier.  Warpgroups 0 and 1 are
// consumers (setmaxnreg 232), 64 query rows each: S = Q K^T is wgmma
// m64n64k16 with both operands read from shared memory (K-major), the
// online softmax runs on S's float32 accumulator fragments in registers
// (log2 units, one ex2 each), and P, rounded to bfloat16 in registers, is
// the A operand of O += P V, wgmma m64n{hd}k16 with V read from shared
// memory as an MN-major B operand (the transpose bit): no ldmatrix, no
// transposed copy.  The consumers pipeline in software: S of tile i and
// PV of tile i - 1 are issued together and tile i's softmax runs while PV
// is on the tensor cores; a K tile is released as soon as its S is in
// and a V tile once its PV is, so with separate K and V rings the loads
// stay a tile ahead (one shared ring stalled the pipeline on each load).
// The O rescale is skipped when no row of a warp moved its max.  The 64 x hd
// float32 O accumulator stays in registers (128 a thread at hd 256).  The
// tensor maps address the model layout in place (4-D: hd, heads, positions,
// batch), so the strides H*hd and KV*hd need no copy; rows past S arrive as
// zeros (TMA's out-of-bounds fill) and are masked.  A row of hd values
// arrives as hd/64 boxes of 64 columns (128-byte swizzle; hd 32: one 64-byte
// box and 64-byte swizzle), placed as the K-chunks the wgmma descriptors
// walk. At hd 256 q takes 64 KB and each stage of K and V 64 KB: one block
// an SM, so blocks are launched longest first (the query tiles nearest the
// end of the sequence reach the most keys).  Registers are the tight
// resource: the consumers' loop lives in the 232 that setmaxnreg gives them
// (ptxas reports the 168 of the launch); live state added to it spills and
// makes ptxas serialize the wgmmas (its C7512 warning).
//
// float32 (the tests and the card-vs-CPU checks): `attention_fma_kernel`
// on the CUDA cores in float32 FMAs, exact to float32 rounding, which
// tensor cores in TF32 would not be.  Each of 256 threads owns a 4 x 4
// block of the 64 x 64 score tile and 4 rows x hd/16 columns of the
// output in registers; q and k are staged transposed so a thread reads
// its 4 rows and 4 keys at one d as two 16-byte loads.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>


namespace {

constexpr int kBQ = 64;          // queries per consumer warpgroup (and per
                                 // float32 block)
constexpr int kBK = 64;          // keys per tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

enum DType { kFloat32 = 0, kBFloat16 = 1 };

// the key tiles [begin, end) a query tile of kBQ rows starting at q0 can
// reach: the TPU kernel's relevant tiles, k_start <= q0 + kBQ - 1 (causal)
// and q0 - k_end < window
__device__ __forceinline__ void key_tiles(int q0, int S, int causal,
                                          int window, int& begin, int& end) {
  const int q_last = min(q0 + kBQ - 1, S - 1);
  end = causal ? q_last / kBK + 1 : (S + kBK - 1) / kBK;
  begin = 0;
  if (window > 0) {
    const int x = q0 - window - kBK + 2;     // least k_start allowed
    begin = x <= 0 ? 0 : (x + kBK - 1) / kBK;
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int S,
                                        int causal, int window) {
  return kpos < S && (!causal || kpos <= qpos) &&
         (window <= 0 || qpos - kpos < window);
}

// ------------------------------------------ bfloat16: TMA, wgmma, mbarrier
constexpr int kConsumers = 2;                    // warpgroups of kBQ rows
constexpr int kBlockQ = kConsumers * kBQ;        // 128 query rows a block
constexpr int kWgmmaThreads = 128 * (kConsumers + 1);   // and a producer

template <int HD>
struct Tile {
  static constexpr int kCW = HD < 64 ? HD : 64;      // columns a box
  static constexpr int kSwizzle = 2 * kCW;           // bytes: 128 or 64
  static constexpr int kChunks = HD / kCW;           // boxes a row
  static constexpr int kStages = HD == 256 ? 2 : HD == 128 ? 3 : 4;
  static constexpr int kQBytes = kBQ * HD * 2;       // a consumer's q
  static constexpr int kKVBytes = kBK * HD * 2;      // one K (or V) tile
  static constexpr int kChunkBytes = kBK * kSwizzle;  // a 64-row box
  static constexpr int kBarOffset =
      kConsumers * kQBytes + 2 * kStages * kKVBytes;
  // 1 KB to align the base to the 128-byte swizzle's 1024-byte atoms
  static constexpr int kSmemBytes = kBarOffset + 8 * (1 + 4 * kStages) + 1024;
  static_assert(kSmemBytes <= 232448, "shared memory");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" :: "r"(bar)
               : "memory");
}

// returns once the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// one box of a 4-D tensor map (coordinates innermost first) into shared
// memory, completing on `bar`
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// a wgmma shared-memory matrix descriptor: start address, leading and
// stride byte offsets (16-byte units), swizzle (1: 128 B, 2: 64 B)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 |
         (uint64_t)(swizzle == 128 ? 1 : 2) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// waits until at most N of this warpgroup's committed groups are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" :: "n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma's issue and wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4][4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i)
    asm volatile("" : "+r"(r[i / 4][i % 4]) :: "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// d (+)= a b for a 64 x 16 tile of A (shared, K-major) and a 16 x 64 tile
// of B (shared, K-major); d is overwritten unless `accumulate`
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d += a b for a 64 x 16 tile of A in registers and a 16 x 32 tile of
// B (shared, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[16],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// d += a b for a 64 x 16 tile of A in registers and a 16 x 64 tile of
// B (shared, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// d += a b for a 64 x 16 tile of A in registers and a 16 x 128 tile of
// B (shared, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// d += a b for a 64 x 16 tile of A in registers and a 16 x 256 tile of
// B (shared, MN-major: the transpose bit)
__device__ __forceinline__ void wgmma_rs(float (&d)[128],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(1));
}

// grid (ceil(S / kBlockQ) * H * B), kWgmmaThreads threads,
// Tile<HD>::kSmemBytes of shared memory; the maps address q (B, S, H, hd)
// and k, v (B, S, KV, hd) in boxes of 64 positions x kCW columns of one head
template <int HD>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       __nv_bfloat16* __restrict__ o, int S, int H, int KV,
                       int causal, int window, float scale) {
  using TL = Tile<HD>;
  constexpr int kStages = TL::kStages, kSw = TL::kSwizzle;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_smem = base;                  // consumer w: + w kQBytes
  const uint32_t k_smem = base + kConsumers * TL::kQBytes;  // + s kKVBytes
  const uint32_t v_smem = k_smem + kStages * TL::kKVBytes;
  // barriers: q, then full and empty for each K stage and each V stage
  const uint32_t q_full = base + TL::kBarOffset;
  auto full_k = [&](int s) { return q_full + 8 * (1 + s); };
  auto empty_k = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  auto full_v = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return q_full + 8 * (1 + 3 * kStages + s); };

  // block -> (query tile, head, batch row), the longest query tiles first
  const int nqt = (S + kBlockQ - 1) / kBlockQ;
  const int per_tile = gridDim.x / nqt;          // H * B
  const int qt = nqt - 1 - blockIdx.x / per_tile;
  const int h = blockIdx.x % per_tile % H, bb = blockIdx.x % per_tile / H;
  const int kvh = h / (H / KV);
  const int q0 = qt * kBlockQ;
  int kb, ke, kb1, ke1;                          // the block's key tiles
  key_tiles(q0, S, causal, window, kb, ke);
  key_tiles(q0 + kBQ, S, causal, window, kb1, ke1);
  ke = max(ke, ke1);
  const int ntiles = ke - kb;

  const int tid = threadIdx.x;
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), kConsumers * 128);
      mbar_init(empty_v(s), kConsumers * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);   // warp-uniform
  if (wg == kConsumers) {
    // ------------------------------------------------------ producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == kConsumers * 128) {
      mbar_expect_tx(q_full, kConsumers * TL::kQBytes);
      for (int w = 0; w < kConsumers; ++w)
        for (int c = 0; c < TL::kChunks; ++c)
          tma_load(q_smem + w * TL::kQBytes + c * TL::kChunkBytes, &q_map,
                   q_full, c * TL::kCW, h, q0 + w * kBQ, bb);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages, k0 = (kb + i) * kBK;
        const int parity = ((i / kStages) & 1) ^ 1;
        mbar_wait(empty_k(s), parity);
        mbar_expect_tx(full_k(s), TL::kKVBytes);
        for (int c = 0; c < TL::kChunks; ++c)
          tma_load(k_smem + s * TL::kKVBytes + c * TL::kChunkBytes, &k_map,
                   full_k(s), c * TL::kCW, kvh, k0, bb);
        mbar_wait(empty_v(s), parity);
        mbar_expect_tx(full_v(s), TL::kKVBytes);
        for (int c = 0; c < TL::kChunks; ++c)
          tma_load(v_smem + s * TL::kKVBytes + c * TL::kChunkBytes, &v_map,
                   full_v(s), c * TL::kCW, kvh, k0, bb);
      }
    }
  } else {
    // ------------------------------------------------------ consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int qw = q0 + wg * kBQ;                // this warpgroup's rows
    int mb, me;                                  // its own key tiles
    key_tiles(qw, S, causal, window, mb, me);
    const int lt = tid % 128, warp = lt / 32, lane = lt % 32;
    const int g = lane / 4, t = lane % 4;        // fragment coordinates
    // this thread's rows r0 and r0 + 8; scores scaled into log2 units
    // (scale folded with log2 e), so a probability is one ex2.  Scaling
    // before the max keeps a fully masked row's max equal to its -1e30
    // scores, so they cancel exactly (exp of 0, erased by the next
    // visible tile's alpha = 0), as in the TPU kernel
    const int r0 = qw + warp * 16 + g;
    const float sl2 = scale * kLog2e;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    float acc[HD / 2], sc[32];
    uint32_t pa[4][4];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
    const uint32_t qa = q_smem + wg * TL::kQBytes;
    auto stage = [](int i) { return i % kStages; };
    auto parity = [](int i) { return (i / kStages) & 1; };
    // a tile of the block's range outside this warpgroup's: wait for it
    // and release it, so every barrier phase sees both consumers
    auto skip = [&](int i) {
      mbar_wait(full_k(stage(i)), parity(i));
      mbar_arrive(empty_k(stage(i)));
      mbar_wait(full_v(stage(i)), parity(i));
      mbar_arrive(empty_v(stage(i)));
    };
    // S = Q K^T into sc, 64 rows x 64 keys, K-major operands: k-step kk
    // reads 16 columns of box kk / (kCW / 16); committed, not waited for
    auto issue_s = [&](int i) {
      const uint32_t ka = k_smem + stage(i) * TL::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int off = kk / (TL::kCW / 16) * TL::kChunkBytes +
                        kk % (TL::kCW / 16) * 32;
        wgmma_ss_n64(sc, smem_desc(qa + off, 16, 8 * kSw, kSw),
                     smem_desc(ka + off, 16, 8 * kSw, kSw), kk > 0);
      }
      wgmma_commit();
    };
    // O += P V: the probabilities of n-tiles 2kk and 2kk+1, rounded to
    // bfloat16 in pa, are the register A operand of keys 16kk..16kk+15;
    // V is MN-major: 8-key groups 8 kSw bytes apart, 64-column boxes
    // kChunkBytes apart; committed, not waited for
    auto issue_pv = [&](int i) {
      const uint32_t va = v_smem + stage(i) * TL::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs(acc, pa[kk],
                 smem_desc(va + kk * 16 * kSw, TL::kChunkBytes, 8 * kSw,
                           kSw));
      wgmma_commit();
    };
    // mask (edge tiles only) and online softmax of tile i's scores:
    // element c of n-tile j sits at row r0 + 8 (c / 2), key k0 + 8 j + 2 t
    // + c % 2; a row's 64 scores are spread over the 4 threads of a quad.
    // Leaves the probabilities in sc and returns whether any row of the
    // warp changed its max (alpha != 1: acc must be rescaled)
    float alpha[2];
    auto softmax = [&](int i) {
      const int k0 = (kb + i) * kBK;
      const bool inside = k0 + kBK <= S && (!causal || k0 + kBK - 1 <= qw) &&
                          (window <= 0 || qw + kBQ - 1 - k0 < window);
      float mx[2] = {kNegInf, kNegInf}, sum[2] = {0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int j = e / 4, c = e % 4;
        sc[e] *= sl2;
        if (!inside && !visible(r0 + 8 * (c / 2), k0 + 8 * j + 2 * t + c % 2,
                                S, causal, window))
          sc[e] = kNegInf;
        mx[c / 2] = fmaxf(mx[c / 2], sc[e]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        sc[e] = ex2(sc[e] - m[e % 4 / 2]);
        sum[e % 4 / 2] += sc[e];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
        l[r] = l[r] * alpha[r] + sum[r];
      }
      return __any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f);
    };
    auto pack = [&] {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    };

    mbar_wait(q_full, 0);
    const int first = max(mb, kb) - kb, last = min(me, ke) - kb;
    int i = 0;
    for (; i < first; ++i) skip(i);
    if (first < last) {
      // software pipeline: S of tile i + 1 and PV of tile i run on the
      // tensor cores while tile i + 1's softmax runs
      mbar_wait(full_k(stage(i)), parity(i));
      wgmma_fence();
      issue_s(i);
      wgmma_wait<0>();
      fence_regs(sc);
      mbar_arrive(empty_k(stage(i)));
      softmax(i);
      pack();
      for (++i; i < last; ++i) {
        mbar_wait(full_k(stage(i)), parity(i));
        wgmma_fence();
        issue_s(i);
        mbar_wait(full_v(stage(i - 1)), parity(i - 1));
        issue_pv(i - 1);
        wgmma_wait<1>();                         // S of tile i is in
        fence_regs(sc);
        mbar_arrive(empty_k(stage(i)));
        const bool rescale = softmax(i);
        wgmma_wait<0>();                         // PV of tile i - 1 is in
        fence_regs(acc);
        fence_regs(pa);
        mbar_arrive(empty_v(stage(i - 1)));
        if (rescale) {       // multiplying by 1 changes nothing
#pragma unroll
          for (int e = 0; e < HD / 2; ++e) acc[e] *= alpha[e % 4 / 2];
        }
        pack();
      }
      mbar_wait(full_v(stage(i - 1)), parity(i - 1));
      wgmma_fence();
      issue_pv(i - 1);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      mbar_arrive(empty_v(stage(i - 1)));
    }
    for (; i < ntiles; ++i) skip(i);

    const long long q_step = (long long)H * HD;
    __nv_bfloat16* ob = o + ((long long)bb * S * H + h) * HD;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pos = r0 + 8 * r;
      if (pos >= S) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
      for (int j = 0; j < HD / 8; ++j)
        *reinterpret_cast<__nv_bfloat162*>(ob + pos * q_step + 8 * j +
                                           2 * t) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                  acc[4 * j + 2 * r + 1] * inv);
    }
  }
}

// -------------------------------------------------- float32: CUDA cores
constexpr int kFmaThreads = 256;    // 16 x 16 threads, 4 x 4 scores each
constexpr int kStride = 68;         // row stride of the transposed tiles

template <int HD>
__host__ __device__ constexpr int fma_smem_bytes() {
  return (2 * HD * kStride + kBK * HD + kBK * kStride) * 4;
}

__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off, 16));
  return x;
}

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off, 16);
  return x;
}

// grid (ceil(S / kBQ), H, B), kFmaThreads threads, fma_smem_bytes<HD>()
template <int HD>
__global__ void __launch_bounds__(kFmaThreads)
attention_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     int S, int H, int KV, int causal, int window,
                     float scale) {
  // output columns a thread owns: NG groups of CW adjacent columns
  constexpr int CW = HD >= 64 ? 4 : 2;
  constexpr int NG = HD / (16 * CW);
  extern __shared__ float4 smem_fma[];
  float* Qt = reinterpret_cast<float*>(smem_fma);  // [HD][kStride], scaled
  float* Kt = Qt + HD * kStride;                   // [HD][kStride]
  float* Vs = Kt + HD * kStride;                   // [kBK][HD]
  float* Pt = Vs + kBK * HD;                       // [kBK][kStride]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, bb = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const long long q_step = (long long)H * HD;   // between positions
  const long long kv_step = (long long)KV * HD;
  const float* qb = q + ((long long)bb * S * H + h) * HD;
  const float* kb = k + ((long long)bb * S * KV + kvh) * HD;
  const float* vb = v + ((long long)bb * S * KV + kvh) * HD;
  float* ob = o + ((long long)bb * S * H + h) * HD;

  for (int e = tid; e < kBQ * HD; e += kFmaThreads) {
    const int r = e / HD, d = e % HD, s = q0 + r;
    Qt[d * kStride + r] = s < S ? qb[s * q_step + d] * scale : 0.f;
  }
  int kt_begin, kt_end;
  key_tiles(q0, S, causal, window, kt_begin, kt_end);

  float m[4], l[4], acc[4][NG * CW];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NG * CW; ++c) acc[i][c] = 0.f;
  }

  for (int kt = kt_begin; kt < kt_end; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();     // Qt is written; the last tile's readers are done
    for (int e = tid; e < kBK * HD; e += kFmaThreads) {
      const int r = e / HD, d = e % HD, s = k0 + r;
      const bool live = s < S;
      Kt[d * kStride + r] = live ? kb[s * kv_step + d] : 0.f;
      Vs[r * HD + d] = live ? vb[s * kv_step + d] : 0.f;
    }
    __syncthreads();

    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qv = *reinterpret_cast<const float4*>(
          &Qt[d * kStride + ty * 4]);
      const float4 kv = *reinterpret_cast<const float4*>(
          &Kt[d * kStride + tx * 4]);
      const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
      const float ka[4] = {kv.x, kv.y, kv.z, kv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qa[i], ka[j], sc[i][j]);
    }

    // mask, then the online softmax of each of the thread's 4 rows; the
    // 16 threads of a half-warp (one ty) share those rows
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        sc[i][j] = visible(qpos, kpos, S, causal, window) ? sc[i][j]
                                                           : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        sc[i][j] = expf(sc[i][j] - m_new);
        sum += sc[i][j];
      }
      l[i] = l[i] * alpha + half_warp_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NG * CW; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(&Pt[(tx * 4 + j) * kStride + ty * 4]) =
          make_float4(sc[0][j], sc[1][j], sc[2][j], sc[3][j]);
    __syncthreads();

#pragma unroll 4
    for (int key = 0; key < kBK; ++key) {
      const float4 pv = *reinterpret_cast<const float4*>(
          &Pt[key * kStride + ty * 4]);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
      const float* vrow = &Vs[key * HD + tx * CW];
#pragma unroll
      for (int gi = 0; gi < NG; ++gi) {
        float va[CW];
        if constexpr (CW == 4) {
          const float4 w = *reinterpret_cast<const float4*>(vrow + gi * 64);
          va[0] = w.x; va[1] = w.y; va[2] = w.z; va[3] = w.w;
        } else {
          const float2 w = *reinterpret_cast<const float2*>(vrow + gi * 32);
          va[0] = w.x; va[1] = w.y;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int jj = 0; jj < CW; ++jj)
            acc[i][gi * CW + jj] = fmaf(pa[i], va[jj], acc[i][gi * CW + jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = q0 + ty * 4 + i;
    if (s >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int gi = 0; gi < NG; ++gi)
#pragma unroll
      for (int jj = 0; jj < CW; ++jj)
        ob[s * q_step + gi * 16 * CW + tx * CW + jj] =
            acc[i][gi * CW + jj] / denom;
  }
}

// --------------------------------------------------------------- launch
template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;   // above 48 KB only after this, once
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = err == cudaSuccess;
  return err;
}

// cuTensorMapEncodeTiled is a driver-API function; it is looked up in the
// driver library the runtime has loaded, so the build links no -lcuda
using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled tensor_map_encoder() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(
                     dlsym(lib, "cuTensorMapEncodeTiled"))
               : nullptr;
  }();
  return fn;
}

// the 4-D map (hd, heads, positions, batch) of a (batch, S, heads, HD)
// bfloat16 tensor, in boxes of 64 positions x kCW columns of one head,
// swizzled as the wgmma descriptors read them; out-of-bounds rows are 0
template <int HD>
cudaError_t make_map(CUtensorMap* map, const void* ptr, int batch, int S,
                     int heads) {
  using TL = Tile<HD>;
  const EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)HD, (cuuint64_t)heads,
                              (cuuint64_t)S, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)HD * 2,
                                 (cuuint64_t)heads * HD * 2,
                                 (cuuint64_t)S * heads * HD * 2};
  const cuuint32_t box[4] = {(cuuint32_t)TL::kCW, 1, (cuuint32_t)kBK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult rc = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      TL::kSwizzle == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                          : CU_TENSOR_MAP_SWIZZLE_64B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, void* o,
                      int batch, int S, int H, int KV, int causal, int window,
                      float scale, int dtype, cudaStream_t stream) {
  if (dtype == kFloat32) {
    static bool done = false;
    constexpr int bytes = fma_smem_bytes<HD>();
    const cudaError_t err = opt_in(attention_fma_kernel<HD>, bytes, done);
    if (err != cudaSuccess) return err;
    const dim3 grid((S + kBQ - 1) / kBQ, H, batch);
    attention_fma_kernel<HD><<<grid, kFmaThreads, bytes, stream>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(o), S, H, KV,
        causal, window, scale);
    return cudaGetLastError();
  }
  static bool done = false;
  constexpr int bytes = Tile<HD>::kSmemBytes;
  cudaError_t err = opt_in(attention_wgmma_kernel<HD>, bytes, done);
  if (err != cudaSuccess) return err;
  const long long blocks =
      (long long)((S + kBlockQ - 1) / kBlockQ) * H * batch;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  CUtensorMap qm, km, vm;
  if ((err = make_map<HD>(&qm, q, batch, S, H)) != cudaSuccess ||
      (err = make_map<HD>(&km, k, batch, S, KV)) != cudaSuccess ||
      (err = make_map<HD>(&vm, v, batch, S, KV)) != cudaSuccess)
    return err;
  attention_wgmma_kernel<HD><<<(unsigned)blocks, kWgmmaThreads, bytes,
                               stream>>>(
      qm, km, vm, static_cast<__nv_bfloat16*>(o), S, H, KV, causal, window,
      scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int flash_attention_supports_head_dim(int hd) {
  return hd == 32 || hd == 64 || hd == 128 || hd == 256;
}

// Launches the attention on `stream`; o is (batch, S, H, hd) in q's type.
// Returns the CUDA error of the launch (0 on success); an empty problem
// launches nothing.  bfloat16 pointers must be 16-byte aligned.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* o, int batch, int S, int H, int KV, int hd,
                           int causal, int window, float scale, int dtype,
                           void* stream) {
  if (batch < 0 || batch > 65535 || S < 0 || H < 1 || H > 65535 || KV < 1 ||
      H % KV != 0 || !flash_attention_supports_head_dim(hd) || window < 0 ||
      (dtype != kFloat32 && dtype != kBFloat16))
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || S == 0) return (int)cudaSuccess;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32:
      return (int)launch_hd<32>(q, k, v, o, batch, S, H, KV, causal, window,
                                scale, dtype, s);
    case 64:
      return (int)launch_hd<64>(q, k, v, o, batch, S, H, KV, causal, window,
                                scale, dtype, s);
    case 128:
      return (int)launch_hd<128>(q, k, v, o, batch, S, H, KV, causal, window,
                                 scale, dtype, s);
    default:
      return (int)launch_hd<256>(q, k, v, o, batch, S, H, KV, causal, window,
                                 scale, dtype, s);
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
