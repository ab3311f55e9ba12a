// Shared pieces of the int8 and int4 packed bucket-scores kernels
// (i8_bucket_scores.cu, i4_bucket_scores.cu).
//
// Both kernels have the launch shape of bucket_scores.cu: one block of 8
// warps owns a 128-row tile (two 64-row buckets) and walks every 128-query
// tile itself.  Operands are staged through shared memory as int8 tiles of
// KC columns; each warp computes a 32-row x 64-query slab of int32 scores
// with mma.sync m16n8k32 s8 x s8 -> s32 (exact integer sums), the slab goes
// to a shared score tile, and one thread per (bucket, query) runs the
// epilogue over its 64 rows.
//
// The epilogue reproduces the reference's bucket_reduce_packed bit for bit:
// __int2float_rn of the exact int32 dot, NEG_SENTINEL on rows >= n_valid,
// (bits & ~63) | in-bucket row, the denormal rule (|v| < FLT_MIN -> signed
// zero, what XLA's flush does to a zero score), fmaxf over the bucket.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace hx_int8 {

constexpr int BUCKET = 64;
constexpr int BM = 128;  // rows per block: two buckets
constexpr int BN = 128;  // queries per tile
constexpr int KC = 64;   // int8 columns staged per step
constexpr int WARPS_M = 4;
constexpr int WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M;  // 32 rows per warp
constexpr int WN = BN / WARPS_N;  // 64 queries per warp
constexpr int MT = WM / 16;       // m16 tiles per warp
constexpr int NT = WN / 8;        // n8 tiles per warp
// Byte stride of a staged tile.  80 bytes = 20 words: the 32 lanes of a
// fragment load (8 rows x 4 words) hit 32 distinct banks.
constexpr int LDA = KC + 16;
constexpr int LDS = BN + 4;  // int32 stride of the score tile
constexpr int CHUNKS = KC / 16;  // 16-byte loads per staged row
constexpr float NEG_SENTINEL = -3.0e38f;
constexpr size_t SCORE_BYTES = sizeof(int) * BM * LDS;

static_assert(THREADS == 2 * BN, "epilogue maps one thread per (bucket, query)");
static_assert(BM == 2 * BUCKET, "a block owns two buckets");
static_assert(KC % 32 == 0, "mma.sync m16n8k32 steps 32 columns");

// D += A (16 x 32, row-major s8) * B (32 x 8, column-major s8), s32.
__device__ __forceinline__ void mma_s8(int (&c)[4], const unsigned (&a)[4],
                                       const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ unsigned lds32(const int8_t* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// acc += xs_s[warp rows, :KC] . qs_s[warp queries, :KC]^T for one staged
// chunk.  Fragment layouts are PTX's for m16n8k32 .s8: lane = 4 * g + t;
// A rows g and g + 8, columns 4t..4t+3 and 16 + 4t..; B (k, n) = qs[n, k]
// with n = g and k = 4t.. and 16 + 4t..; C rows g and g + 8, columns 2t,
// 2t + 1.
__device__ __forceinline__ void mma_chunk(int (&acc)[MT][NT][4],
                                          const int8_t* xs_s,
                                          const int8_t* qs_s, int wm, int wn,
                                          int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < KC; kk += 32) {
    unsigned a[MT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int8_t* p = xs_s + (wm * WM + i * 16 + g) * LDA + kk + 4 * t;
      a[i][0] = lds32(p);
      a[i][1] = lds32(p + 8 * LDA);
      a[i][2] = lds32(p + 16);
      a[i][3] = lds32(p + 8 * LDA + 16);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int8_t* p = qs_s + (wn * WN + j * 8 + g) * LDA + kk + 4 * t;
      const unsigned b[2] = {lds32(p), lds32(p + 16)};
#pragma unroll
      for (int i = 0; i < MT; ++i) mma_s8(acc[i][j], a[i], b);
    }
  }
}

__device__ __forceinline__ void zero_acc(int (&acc)[MT][NT][4]) {
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
}

// Write the warp's accumulators into the [BM][LDS] int32 score tile.
__device__ __forceinline__ void store_acc(const int (&acc)[MT][NT][4],
                                          int* sc, int wm, int wn, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int r = wm * WM + i * 16 + g;
      const int c = wn * WN + j * 8 + 2 * t;
      *reinterpret_cast<int2*>(sc + r * LDS + c) =
          make_int2(acc[i][j][0], acc[i][j][1]);
      *reinterpret_cast<int2*>(sc + (r + 8) * LDS + c) =
          make_int2(acc[i][j][2], acc[i][j][3]);
    }
}

__device__ __forceinline__ unsigned flush_denormal(unsigned bits) {
  return (bits & 0x7f800000u) == 0u ? (bits & 0x80000000u) : bits;
}

// Packed bucket max of local bucket lb (0 or 1) for query column j of the
// score tile; row0 is the block's first row (a multiple of 64).
__device__ __forceinline__ float bucket_max(const int* sc, int lb, int j,
                                            long long row0, int n_valid) {
  float best = __uint_as_float(0xff800000u);  // -inf
  for (int r = 0; r < BUCKET; ++r) {
    const int lr = lb * BUCKET + r;
    float s = __int2float_rn(sc[lr * LDS + j]);
    if (row0 + lr >= n_valid) s = NEG_SENTINEL;
    const unsigned bits =
        (__float_as_uint(s) & ~63u) | static_cast<unsigned>(r);
    best = fmaxf(best, __uint_as_float(flush_denormal(bits)));
  }
  return best;
}

}  // namespace hx_int8
