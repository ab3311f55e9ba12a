// Hopper pieces shared by the three packed bucket-scores kernels
// (bucket_scores.cu, i8_bucket_scores.cu, i4_bucket_scores.cu), the
// kernel sweeps built on them (sweep.cuh: kernels 4 and 5) and the l2
// exact rung's score step (l2_scores.cu, whose epilogue is its own).
//
// All three have one shape: a persistent grid of one block per SM walks
// 64-row buckets (bucket = blockIdx.x + i * gridDim.x); one producer
// thread keeps a ring of stages per consumer warpgroup full with TMA
// loads (128-byte swizzle, full/empty mbarriers); two consumer warpgroups
// take alternate buckets and issue wgmma with M = 64 = one bucket against
// the queries; the packed bucket max is taken in registers.  This header
// holds the inline PTX (mbarrier, TMA, wgmma), the shared-memory plan,
// the epilogue (kernels 1-3's, and the sweeps' compile-time variants of
// it), and the host side (tensor maps, the shared-memory opt-in).
//
// The epilogue reproduces the reference's bucket_reduce_packed bit for
// bit: rows >= n_valid score NEG_SENTINEL, each score's low 6 mantissa
// bits take its in-bucket row, a float max over the bucket, and the
// denormal rule (|v| < FLT_MIN -> signed zero, what XLA's flush does to a
// zeroed tombstone row's packed 0).  The flush is monotone in the float
// order, so it is applied once to each bucket's max.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums; libcuda is not linked
#include <cuda_runtime.h>

#include <cstdint>
#include <mutex>

namespace hx {

constexpr int BUCKET = 64;
constexpr int SWIZZLE_BYTES = 128;  // one swizzle row: 64 bf16 or 128 int8
constexpr int ROW_TILE_BYTES = BUCKET * SWIZZLE_BYTES;  // 8 KB
constexpr int CONSUMERS = 2;  // warpgroups
constexpr int THREADS = 128 * (CONSUMERS + 1);  // + one producer
constexpr int PRODUCER_REGS = 40;   // setmaxnreg: 128 x 40 + 256 x 232
constexpr int CONSUMER_REGS = 232;  // <= 65,536 registers of the SM
constexpr int MAX_DEPTH = 8;        // ring stages per consumer
constexpr int MIN_RESIDENT_DEPTH = 4;
constexpr int SMEM_LIMIT = 232448;  // the opt-in maximum of one block
constexpr int MAX_DEVICES = 64;
constexpr float NEG_SENTINEL = -3.0e38f;

// Shared memory, from a 1024-byte aligned base (the 128-byte swizzle
// repeats every 8 rows of 128 bytes, and TMA and wgmma both read it from
// the address bits): [resident queries][each consumer's ring of `depth`
// stages][kernel-specific `extra` bytes][reduction buffers][mbarriers].
struct Plan {
  bool resident;
  int depth;        // stages per consumer
  int stage_bytes;
  int query_bytes;  // resident queries, 0 when streamed
  int smem_bytes;   // dynamic shared memory to request
};

inline int red_bytes(int b) { return CONSUMERS * 2 * 4 * b * 4; }
inline int fixed_bytes(int b) {
  return 1024 + red_bytes(b) + (2 * CONSUMERS * MAX_DEPTH + 1) * 8;
}

// The plan follows from the shape alone: the queries take `query_bytes`
// when resident, and one K-chunk of them is B rows of one swizzle row
// (B * 128 bytes) when each stage carries it instead.  A consumer holds
// two stages at once (one chunk's products in flight while the next
// one's are issued), so a ring needs at least two.
inline Plan make_plan(long long query_bytes, int b, int extra) {
  Plan p{};
  const long long room = SMEM_LIMIT - fixed_bytes(b) - extra;
  p.resident =
      query_bytes + CONSUMERS * MIN_RESIDENT_DEPTH * ROW_TILE_BYTES <= room;
  p.query_bytes = p.resident ? static_cast<int>(query_bytes) : 0;
  p.stage_bytes = ROW_TILE_BYTES + (p.resident ? 0 : b * SWIZZLE_BYTES);
  const long long fit = (room - p.query_bytes) / (CONSUMERS * p.stage_bytes);
  p.depth = static_cast<int>(fit < MAX_DEPTH ? fit : MAX_DEPTH);
  p.smem_bytes = fixed_bytes(b) + extra + p.query_bytes +
                 CONSUMERS * p.depth * p.stage_bytes;
  return p;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// The spin loop stays inside one asm block: a C++ loop around try_wait
// would leave the warp divergent where the wgmma instructions that follow
// need it converged.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// One TMA tile of a 2-D tensor map at (column c0, row c1); the box is the
// map's.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory descriptor of a K-major operand in 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (stride byte offset);
// the leading byte offset is unused by this layout.  A K step of 32 bytes
// (16 bf16 or 32 int8) inside the swizzle row advances the start address.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// The accumulators are written by asynchronous products: pin them so the
// compiler neither reads them before wgmma_wait nor moves them.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_acc(int (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// D[64 x 128] (+)= A[64 x 32] * B[128 x 32]^T, s8 in, exact s32 sums.
__device__ __forceinline__ void wgmma_m64n128k32_s8(int (&d)[64], uint64_t a,
                                                    uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 256] (+)= A[64 x 32] * B[256 x 32]^T, s8 in, exact s32 sums.
__device__ __forceinline__ void wgmma_m64n256k32_s8(int (&d)[128], uint64_t a,
                                                    uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

// One s8 product of a bucket's row tile against B = 128 * NT queries:
// n128 at B = 128, n256 at B = 256 (the row tile read once for all).
template <int NT>
__device__ __forceinline__ void wgmma_s8(int (&d)[NT * 64], uint64_t a,
                                         uint64_t b, int accumulate) {
  if constexpr (NT == 2)
    wgmma_m64n256k32_s8(d, a, b, accumulate);
  else
    wgmma_m64n128k32_s8(d, a, b, accumulate);
}

// D[64 x 128] (+)= A[64 x 16] * B[128 x 16]^T, bf16 in, f32 sums.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
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
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 256] (+)= A[64 x 16] * B[256 x 16]^T, bf16 in, f32 sums.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a,
                                                 uint64_t b, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, "
      "%74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "
      "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, "
      "%98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
      "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, "
      "%118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
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
      : "l"(a), "l"(b), "r"(accumulate));
}

// B / 128 query tiles in one product: n128 at B = 128, n256 at B = 256
// (one instruction reads the row tile once for all queries).
template <int NT>
__device__ __forceinline__ void wgmma_rows_queries(float (&d)[NT * 64],
                                                   uint64_t a, uint64_t b,
                                                   int accumulate) {
  if constexpr (NT == 2)
    wgmma_m64n256k16(d, a, b, accumulate);
  else
    wgmma_m64n128k16(d, a, b, accumulate);
}

// One LOP3: the score's bits under `keep`, then the row's `put` bits.
__device__ __forceinline__ float pack(float s, uint32_t keep, uint32_t put) {
  return __uint_as_float((__float_as_uint(s) & keep) | put);
}

__device__ __forceinline__ float flush_denormal(float v) {
  uint32_t bits = __float_as_uint(v);
  if ((bits & 0x7f800000u) == 0u) bits &= 0x80000000u;
  return __uint_as_float(bits);
}

// An accumulator value as the f32 score the reference packs: f32 sums as
// they are, exact int32 sums rounded to nearest (exact below 2^24).
__device__ __forceinline__ float as_score(float v) { return v; }
__device__ __forceinline__ float as_score(int v) { return __int2float_rn(v); }

__device__ __forceinline__ float vmax(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ int vmax(int a, int b) { return max(a, b); }

// One half-exchange of the reduce-scatter: lanes that differ in `bit`
// swap halves of m[0, 2h) and keep the max of the half they own in
// m[0, h).
template <int H, typename V>
__device__ __forceinline__ void exchange(V (&m)[32], bool hi, int bit) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const V send = hi ? m[i] : m[i + H];
    const V keep = hi ? m[i + H] : m[i];
    m[i] = vmax(keep, __shfl_xor_sync(0xffffffffu, send, bit));
  }
}

// Reduce query tile N (128 columns) of the accumulator to the max of each
// column over this warp's 16 rows, written to buf[0, 128).  Value i of
// the accumulator sits at row r0 + 8 * ((i >> 1) & 1) and column
// 8 * (i >> 2) + 2 * c + (i & 1) (c = lane % 4), so tile N is values
// [64 N, 64 N + 64); each is packed as (bits & keep) | put of its row.
template <int N, typename T, int R>
__device__ __forceinline__ void reduce_tile(const T (&acc)[R], float* buf,
                                            uint32_t keep0, uint32_t put0,
                                            uint32_t keep1, uint32_t put1,
                                            int lane) {
  float m[32];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      m[2 * j + e] =
          fmaxf(pack(as_score(acc[64 * N + 4 * j + e]), keep0, put0),
                pack(as_score(acc[64 * N + 4 * j + 2 + e]), keep1, put1));
  // Reduce-scatter over the lane bits 4, 3, 2 (the row groups): lane
  // (g, c) ends with the columns 16 g + {0, 8} + 2 c + {0, 1}.
  exchange<16>(m, lane & 16, 16);
  exchange<8>(m, lane & 8, 8);
  exchange<4>(m, lane & 4, 4);
  float* col = buf + 16 * (lane / 4) + 2 * (lane % 4);
  *reinterpret_cast<float2*>(col) = make_float2(m[0], m[1]);
  *reinterpret_cast<float2*>(col + 8) = make_float2(m[2], m[3]);
}

// The epilogue of consumer warpgroup `wg` (thread t of it) for one bucket,
// after wgmma_wait<0>: pack, bucket max, the merge of the four warps
// through `buf` (4 x B floats, one of two per consumer, alternating by
// iteration), the flush, then `last(winner)` written to the bucket's B
// outputs at `dst` (B consecutive floats).  The row mask folds into the
// pack: a live row keeps its score's high bits (and ~63), a dead row
// keeps none and takes the sentinel's, so masking costs no instruction
// per value and no branch.
template <int NT, typename T, typename Last>
__device__ __forceinline__ void bucket_epilogue(const T (&acc)[NT * 64],
                                                float* buf, float* dst,
                                                int row0, int n_valid, int wg,
                                                int t, Last last) {
  constexpr int B = 128 * NT;
  const int warp = t / 32;
  const int lane = t % 32;
  const uint32_t r0 = warp * 16 + lane / 4;  // this thread's rows
  const uint32_t r1 = r0 + 8;
  const uint32_t neg_hi = __float_as_uint(NEG_SENTINEL) & ~63u;
  const bool dead0 = row0 + static_cast<int>(r0) >= n_valid;
  const bool dead1 = row0 + static_cast<int>(r1) >= n_valid;
  const uint32_t keep0 = dead0 ? 0u : ~63u;
  const uint32_t keep1 = dead1 ? 0u : ~63u;
  const uint32_t put0 = (dead0 ? neg_hi : 0u) | r0;
  const uint32_t put1 = (dead1 ? neg_hi : 0u) | r1;
  reduce_tile<0>(acc, buf + warp * B, keep0, put0, keep1, put1, lane);
  if constexpr (NT == 2)
    reduce_tile<1>(acc, buf + warp * B + 128, keep0, put0, keep1, put1,
                   lane);
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  dst += NT * t;
  if constexpr (NT == 2) {
    float2 v = *reinterpret_cast<const float2*>(buf + 2 * t);
#pragma unroll
    for (int w = 1; w < 4; ++w) {
      const float2 o = *reinterpret_cast<const float2*>(buf + w * B + 2 * t);
      v.x = fmaxf(v.x, o.x);
      v.y = fmaxf(v.y, o.y);
    }
    *reinterpret_cast<float2*>(dst) =
        make_float2(last(flush_denormal(v.x)), last(flush_denormal(v.y)));
  } else {
    float v = buf[t];
#pragma unroll
    for (int w = 1; w < 4; ++w) v = fmaxf(v, buf[w * B + t]);
    *dst = last(flush_denormal(v));
  }
  // buf is written again two buckets later, after the next bar.sync,
  // which every warp reaches only once it has read this one.
}

// The products of one bucket from an int8 ring (kernels 2 and 3): for
// each 128-column K-chunk, wait for its stage, issue four m64nBk32 s8
// products (K steps of +32 bytes in the swizzle row) against the queries
// (resident at q_addr, or carried by the stage after its row tile), and
// release the previous chunk's stage once its products are done.  No
// instruction but the products touches the accumulators from the first
// product to wgmma_wait<0>: anything else would serialize them.
template <int NT, bool RESIDENT>
__device__ __forceinline__ void s8_products(int (&acc)[NT * 64],
                                            uint32_t my_full,
                                            uint32_t my_empty,
                                            uint32_t my_ring,
                                            uint32_t q_addr, uint32_t seq0,
                                            int k_chunks, int depth,
                                            int stage_bytes) {
  constexpr int B = 128 * NT;
  uint32_t prev = 0;
  fence_acc(acc);
  for (int k = 0; k < k_chunks; ++k) {
    const uint32_t seq = seq0 + k;
    const uint32_t s = seq % depth;
    mbar_wait(my_full + 8 * s, (seq / depth) & 1);
    wgmma_fence();
    const uint32_t a = my_ring + s * stage_bytes;
    const uint32_t q =
        RESIDENT ? q_addr + k * B * SWIZZLE_BYTES : a + ROW_TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < SWIZZLE_BYTES / 32; ++kk)
      wgmma_s8<NT>(acc, sw128_desc(a + kk * 32), sw128_desc(q + kk * 32),
                   k | kk);
    wgmma_commit();
    if (k > 0) {
      // every thread arrives, so no branch sits between the products
      wgmma_wait<1>();
      mbar_arrive(my_empty + 8 * prev);
    }
    prev = s;
  }
  wgmma_wait<0>();
  fence_acc(acc);
  mbar_arrive(my_empty + 8 * prev);
}

// The products of one bucket from a bf16 ring (the sweeps, l2_scores):
// kernel 1's loop, which bucket_scores.cu keeps inline so that its
// generated code stays as it was.  Per 64-column K-chunk, four m64nBk16
// bf16 products with f32 sums against the queries (resident at q_addr,
// or carried by the stage after its row tile), the previous chunk's
// stage released once its products are done.
template <int NT, bool RESIDENT>
__device__ __forceinline__ void bf16_products(float (&acc)[NT * 64],
                                              uint32_t my_full,
                                              uint32_t my_empty,
                                              uint32_t my_ring,
                                              uint32_t q_addr, uint32_t seq0,
                                              int k_chunks, int depth,
                                              int stage_bytes) {
  constexpr int B = 128 * NT;
  uint32_t prev = 0;
  fence_acc(acc);
  for (int k = 0; k < k_chunks; ++k) {
    const uint32_t seq = seq0 + k;
    const uint32_t s = seq % depth;
    mbar_wait(my_full + 8 * s, (seq / depth) & 1);
    wgmma_fence();
    const uint32_t a = my_ring + s * stage_bytes;
    const uint32_t q =
        RESIDENT ? q_addr + k * B * SWIZZLE_BYTES : a + ROW_TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < SWIZZLE_BYTES / 32; ++kk)
      wgmma_rows_queries<NT>(acc, sw128_desc(a + kk * 32),
                             sw128_desc(q + kk * 32), k | kk);
    wgmma_commit();
    if (k > 0) {
      wgmma_wait<1>();
      mbar_arrive(my_empty + 8 * prev);
    }
    prev = s;
  }
  wgmma_wait<0>();
  fence_acc(acc);
  mbar_arrive(my_empty + 8 * prev);
}

// The producer thread's loop (kernel 2, the sweeps, l2_scores; kernel 1
// keeps its copy inline): the block's buckets alternate between the
// consumers' rings.  For each K-chunk of a bucket, `cols` columns of the
// maps, it waits until the consumer has released the stage's previous
// round, then loads the bucket's row tile by TMA and, unless RESIDENT,
// the queries' K-chunk after it.
template <bool RESIDENT>
__device__ __forceinline__ void fill_rings(const CUtensorMap* rows_map,
                                           const CUtensorMap* queries_map,
                                           uint32_t ring, uint32_t full,
                                           uint32_t empty, int n_buckets,
                                           int k_chunks, int depth,
                                           int stage_bytes, int cols) {
  int item = 0;
  for (int bucket = blockIdx.x; bucket < n_buckets;
       bucket += gridDim.x, ++item) {
    const int c = item % CONSUMERS;
    uint32_t seq = static_cast<uint32_t>(item / CONSUMERS) * k_chunks;
    for (int k = 0; k < k_chunks; ++k, ++seq) {
      const uint32_t s = seq % depth;
      const uint32_t round = seq / depth;
      const uint32_t bar = 8 * (c * MAX_DEPTH + s);
      if (round) mbar_wait(empty + bar, (round - 1) & 1);
      const uint32_t stage = ring + (c * depth + s) * stage_bytes;
      mbar_expect_tx(full + bar, stage_bytes);
      tma_load(stage, rows_map, full + bar, k * cols, bucket * BUCKET);
      if (!RESIDENT)
        tma_load(stage + ROW_TILE_BYTES, queries_map, full + bar, k * cols,
                 0);
    }
  }
}

// ------------------------------------------------- the sweeps' epilogue
//
// Compile-time choices of the epilogue for the kernel sweeps (sweep.cuh;
// the ports of benchmarks/onepass_sweep.py and benchmarks/i8_sweep.py).
// Kernels 1-3 keep bucket_epilogue above, whose row mask is folded into
// the pack (Mask::Fold); these variants run beside it:
//
// - Mask::Select: rows >= n_valid score NEG_SENTINEL by an explicit
//   select before the pack (the TPU kernels' order of operations);
// - Mask::Tail: that select only in a bucket that holds a row >= n_valid,
//   one branch per bucket, uniform over the warpgroup;
// - Mask::None: no mask (the sweep's probes).
//
// and the reduction:
//
// - Reduce::Packed: each score's low 6 mantissa bits take its row, a
//   float max, the denormal flush on the winner (bucket_reduce_packed);
// - Reduce::Max: a plain float max of the scores, no pack, no flush;
// - Reduce::IntMax: an int max of the raw int32 sums, converted to f32
//   after the reduction;
// - Reduce::I32Pack: the int domain: (sum << 6) | row (INT32_MIN for a
//   masked row), an int max, then the winner's sum >> 6 converted to f32,
//   multiplied by the bucket's scale, re-packed with the winner's row and
//   flushed.  Among equal negative sums the higher row wins (the float
//   pack picks the lower one).
enum class Mask { Fold, Select, Tail, None };
enum class Reduce { Packed, Max, IntMax, I32Pack };

// The value an accumulator entry `a` of in-bucket row r contributes to
// the reduction; `scale` multiplies the f32 score when SCALED.
template <Reduce RED, bool SCALED, typename T>
__device__ __forceinline__ auto sweep_value(T a, uint32_t r, bool dead,
                                            float scale) {
  if constexpr (RED == Reduce::I32Pack) {
    static_assert(sizeof(T) == 4 && T(-1) < T(0), "int32 sums");
    const int p = static_cast<int>((static_cast<uint32_t>(a) << 6) | r);
    return dead ? static_cast<int>(0x80000000u) : p;
  } else if constexpr (RED == Reduce::IntMax) {
    return a;
  } else {
    float v = as_score(a);
    if constexpr (SCALED) v = __fmul_rn(v, scale);
    v = dead ? NEG_SENTINEL : v;
    if constexpr (RED == Reduce::Packed) v = pack(v, ~63u, r);
    return v;
  }
}

// What a bucket's winner becomes in the output.
template <Reduce RED, typename V>
__device__ __forceinline__ float sweep_final(V v, float bucket_scale) {
  if constexpr (RED == Reduce::Packed) {
    return flush_denormal(v);
  } else if constexpr (RED == Reduce::Max) {
    return v;
  } else if constexpr (RED == Reduce::IntMax) {
    return __int2float_rn(v);
  } else {
    const float s = __fmul_rn(__int2float_rn(v >> 6), bucket_scale);
    return flush_denormal(__uint_as_float(
        (__float_as_uint(s) & ~63u) | (static_cast<uint32_t>(v) & 63u)));
  }
}

// reduce_tile's walk for the sweeps: query tile N of the accumulator to
// the max of each column over this warp's 16 rows, into buf[0, 128).
template <int N, Reduce RED, bool SCALED, typename V, typename T, int R>
__device__ __forceinline__ void sweep_reduce_tile(
    const T (&acc)[R], V* buf, uint32_t r0, uint32_t r1, bool dead0,
    bool dead1, float sc0, float sc1, int lane) {
  V m[32];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      m[2 * j + e] = vmax(
          sweep_value<RED, SCALED>(acc[64 * N + 4 * j + e], r0, dead0, sc0),
          sweep_value<RED, SCALED>(acc[64 * N + 4 * j + 2 + e], r1, dead1,
                                   sc1));
  exchange<16>(m, lane & 16, 16);
  exchange<8>(m, lane & 8, 8);
  exchange<4>(m, lane & 4, 4);
  V* col = buf + 16 * (lane / 4) + 2 * (lane % 4);
  col[0] = m[0];
  col[1] = m[1];
  col[8] = m[2];
  col[9] = m[3];
}

// One bucket's reduction, merge and store with the mask applied
// (MASKED) or not: bucket_epilogue's shape (registers, shuffles, a
// 4-warp merge through `buf`), then each winner to out[bucket, col], or
// to out[col, bucket] when TRANSPOSED ([B, buckets]: a bucket's B
// winners land in B rows, n_buckets apart).
template <int NT, bool MASKED, Reduce RED, bool SCALED, bool TRANSPOSED,
          typename T>
__device__ __forceinline__ void sweep_bucket(const T (&acc)[NT * 64],
                                             void* buf_raw, float* out,
                                             int bucket, int n_buckets,
                                             int n_valid, int wg, int t,
                                             float sc0, float sc1,
                                             float bucket_scale) {
  constexpr int B = 128 * NT;
  using V = decltype(sweep_value<RED, SCALED>(acc[0], 0u, false, 0.0f));
  V* buf = static_cast<V*>(buf_raw);
  const int warp = t / 32;
  const int lane = t % 32;
  const uint32_t r0 = warp * 16 + lane / 4;
  const uint32_t r1 = r0 + 8;
  const int row0 = bucket * BUCKET;
  const bool dead0 = MASKED && row0 + static_cast<int>(r0) >= n_valid;
  const bool dead1 = MASKED && row0 + static_cast<int>(r1) >= n_valid;
  sweep_reduce_tile<0, RED, SCALED>(acc, buf + warp * B, r0, r1, dead0,
                                    dead1, sc0, sc1, lane);
  if constexpr (NT == 2)
    sweep_reduce_tile<1, RED, SCALED>(acc, buf + warp * B + 128, r0, r1,
                                      dead0, dead1, sc0, sc1, lane);
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
  float w[NT];
#pragma unroll
  for (int c = 0; c < NT; ++c) {
    V v = buf[NT * t + c];
#pragma unroll
    for (int k = 1; k < 4; ++k) v = vmax(v, buf[k * B + NT * t + c]);
    w[c] = sweep_final<RED>(v, bucket_scale);
  }
  if constexpr (TRANSPOSED) {
#pragma unroll
    for (int c = 0; c < NT; ++c)
      out[static_cast<long long>(NT * t + c) * n_buckets + bucket] = w[c];
  } else if constexpr (NT == 2) {
    *reinterpret_cast<float2*>(out + static_cast<long long>(bucket) * B +
                               2 * t) = make_float2(w[0], w[1]);
  } else {
    out[static_cast<long long>(bucket) * B + t] = w[0];
  }
}

// The sweeps' epilogue of consumer warpgroup `wg` for one bucket, after
// wgmma_wait<0>: `buf` is one of the consumer's two 4 x B buffers (as
// for bucket_epilogue), sc0 / sc1 the row scales of this thread's two
// rows (SCALED), bucket_scale the bucket's (Reduce::I32Pack).
template <int NT, Mask MASK, Reduce RED, bool SCALED, bool TRANSPOSED,
          typename T>
__device__ __forceinline__ void sweep_epilogue(const T (&acc)[NT * 64],
                                               void* buf, float* out,
                                               int bucket, int n_buckets,
                                               int n_valid, int wg, int t,
                                               float sc0, float sc1,
                                               float bucket_scale) {
  static_assert(MASK != Mask::Fold, "the folded mask is bucket_epilogue's");
  static_assert(RED != Reduce::IntMax || MASK == Mask::None,
                "an int max of raw sums takes no mask");
  if constexpr (MASK == Mask::None) {
    sweep_bucket<NT, false, RED, SCALED, TRANSPOSED>(
        acc, buf, out, bucket, n_buckets, n_valid, wg, t, sc0, sc1,
        bucket_scale);
  } else if constexpr (MASK == Mask::Select) {
    sweep_bucket<NT, true, RED, SCALED, TRANSPOSED>(
        acc, buf, out, bucket, n_buckets, n_valid, wg, t, sc0, sc1,
        bucket_scale);
  } else if ((bucket + 1) * BUCKET > n_valid) {
    sweep_bucket<NT, true, RED, SCALED, TRANSPOSED>(
        acc, buf, out, bucket, n_buckets, n_valid, wg, t, sc0, sc1,
        bucket_scale);
  } else {
    sweep_bucket<NT, false, RED, SCALED, TRANSPOSED>(
        acc, buf, out, bucket, n_buckets, n_valid, wg, t, sc0, sc1,
        bucket_scale);
  }
}

// ------------------------------------------------------------------ host

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A row-major [rows, cols] matrix of `type` (elem_bytes each), read in
// boxes of box_cols x box_rows with `swizzle`.
inline bool encode(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                   int elem_bytes, long long rows, int cols, int box_cols,
                   int box_rows, CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * elem_bytes};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(map, type, 2, const_cast<void*>(ptr), dims, strides,
                        box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The shared-memory opt-in of KERNEL and the SM count, once per device;
// returns 0 or a cudaError_t.
template <auto KERNEL>
int ready(int* sms) {
  static std::mutex mu;
  static bool done[MAX_DEVICES];
  static int count[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  std::lock_guard<std::mutex> lock(mu);
  if (!done[dev]) {
    err = cudaFuncSetAttribute(KERNEL,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_LIMIT);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&count[dev],
                                   cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    done[dev] = true;
  }
  *sms = count[dev];
  return 0;
}

// A launch entry's code for a launch into a stream capturing a CUDA graph:
// the kernels became nodes of the graph, which launch at each replay
// (kernels.py: CAPTURED).
constexpr int HX_CAPTURED = 1 << 30;

// What a launch entry returns once it has issued its kernels on `stream`
// with result `err`: `err` where it is not 0, else HX_CAPTURED where
// `stream` is capturing a CUDA graph, else 0.
inline int launched(cudaStream_t stream, int err) {
  if (err != 0) return err;
  cudaStreamCaptureStatus capture = cudaStreamCaptureStatusNone;
  const cudaError_t q = cudaStreamIsCapturing(stream, &capture);
  if (q != cudaSuccess) return static_cast<int>(q);
  return capture == cudaStreamCaptureStatusActive ? HX_CAPTURED : 0;
}

}  // namespace hx
