// Packed bucket-max scores: the fused coarse phase of exact vector search.
//
// Replaces the Pallas kernel helix_tpu/ops/fused_topk.py:_bucket_scores
// (body _make_kernel, epilogue bucket_reduce_packed).  For every row r of
// the bf16 matrix xs [N, D] and every query j of qs [B, D]:
//
//   s = sum_d xs[r, d] * qs[j, d]          (f32 accumulation)
//   s = NEG_SENTINEL              if r >= n_valid
//   packed = int_as_float((float_as_int(s) & ~63) | (r & 63))
//   packed = +-0                  if |packed| < FLT_MIN (see FTZ below)
//   out[r / 64, j] = fmaxf over the 64 packed values of r's bucket
//
// The winner's in-bucket row index rides in its low mantissa bits, so the
// caller recovers the row id as bucket * 64 + (bits & 63).  The max is a
// float max: negative floats order the other way as integers.
//
// FTZ: a row that scores exactly 0 (a zeroed tombstone row) packs to a
// denormal.  The TPU and XLA flush denormals, so the reference reports
// such a winner as a signed zero with index bits 0.  This kernel applies
// that rule explicitly; it must not be built with --use_fast_math, whose
// flush would apply to every float operation instead.
//
// What bounds it on an H100: at N = 1,007,616 (1M rows padded to 8192),
// D = 128, B = 256 the kernel reads ~258 MB of bf16 rows and does ~66
// GFLOP, ~256 FLOP per byte, near the card's bf16 ridge (~295); with
// B = 128 (single requests padded) it falls below the ridge.  So the row
// read must not repeat per query tile: one block owns a 128-row tile (two
// buckets) and walks every 128-query tile itself, so a row tile comes
// from device memory once and its re-reads for later query tiles hit L2.
// The queries (64 KB at B = 256) stay L2-resident for the whole grid.
//
// Design (simple first): 8 warps, bf16 WMMA 16x16x16 fragments with f32
// accumulators, rows and queries staged through shared memory along D in
// 64-column chunks, the 128 x 128 f32 score tile written to shared memory,
// then one thread per (bucket, query) packs and reduces its 64 rows and
// writes one f32.  Output layout is [N / 64, B] as in the reference, so
// consecutive threads store consecutive queries (coalesced).  wgmma, TMA
// and a pipelined, persistent grid are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int BUCKET = 64;
constexpr int BM = 128;  // rows per block: two buckets
constexpr int BN = 128;  // queries per tile
constexpr int KC = 64;   // depth staged per step
constexpr int WARPS_M = 4;
constexpr int WARPS_N = 2;
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int WM = BM / WARPS_M;  // 32 rows per warp
constexpr int WN = BN / WARPS_N;  // 64 queries per warp
constexpr int FM = WM / 16;
constexpr int FN = WN / 16;
constexpr int LDA = KC + 8;  // bf16 stride of the staged tiles (padding)
constexpr int LDS = BN + 4;  // f32 stride of the score tile
constexpr float NEG_SENTINEL = -3.0e38f;
constexpr size_t SMEM_BYTES =
    sizeof(__nv_bfloat16) * (BM + BN) * LDA + sizeof(float) * BM * LDS;

static_assert(THREADS == 2 * BN, "epilogue maps one thread per (bucket, query)");
static_assert(BM == 2 * BUCKET, "a block owns two buckets");

__global__ void __launch_bounds__(THREADS)
bucket_scores_kernel(const __nv_bfloat16* __restrict__ xs,
                     const __nv_bfloat16* __restrict__ qs,
                     float* __restrict__ out, int d, int b, int n_valid) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* xs_s = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* qs_s = xs_s + BM * LDA;
  float* sc = reinterpret_cast<float*>(qs_s + BN * LDA);

  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  constexpr int VEC = 8;  // bf16 per 16-byte load
  constexpr int CHUNKS = KC / VEC;

  for (int q0 = 0; q0 < b; q0 += BN) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

    for (int k0 = 0; k0 < d; k0 += KC) {
      for (int idx = threadIdx.x; idx < BM * CHUNKS; idx += THREADS) {
        const int r = idx / CHUNKS;
        const int c = (idx % CHUNKS) * VEC;
        *reinterpret_cast<uint4*>(xs_s + r * LDA + c) =
            *reinterpret_cast<const uint4*>(xs + (row0 + r) * d + k0 + c);
      }
      for (int idx = threadIdx.x; idx < BN * CHUNKS; idx += THREADS) {
        const int r = idx / CHUNKS;
        const int c = (idx % CHUNKS) * VEC;
        *reinterpret_cast<uint4*>(qs_s + r * LDA + c) =
            *reinterpret_cast<const uint4*>(
                qs + static_cast<long long>(q0 + r) * d + k0 + c);
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KC; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a[FM];
        // B(k, n) = qs[n, k]: the query tile read as a column-major K x N.
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major> q[FN];
#pragma unroll
        for (int i = 0; i < FM; ++i)
          wmma::load_matrix_sync(a[i], xs_s + (wm * WM + i * 16) * LDA + kk,
                                 LDA);
#pragma unroll
        for (int j = 0; j < FN; ++j)
          wmma::load_matrix_sync(q[j], qs_s + (wn * WN + j * 16) * LDA + kk,
                                 LDA);
#pragma unroll
        for (int i = 0; i < FM; ++i)
#pragma unroll
          for (int j = 0; j < FN; ++j)
            wmma::mma_sync(acc[i][j], a[i], q[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < FM; ++i)
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::store_matrix_sync(sc + (wm * WM + i * 16) * LDS + wn * WN + j * 16,
                                acc[i][j], LDS, wmma::mem_row_major);
    __syncthreads();

    // Epilogue: thread -> (local bucket, query); rows in order, so the
    // shared-memory reads of a warp are 32 consecutive floats.
    const int lb = threadIdx.x / BN;
    const int j = threadIdx.x % BN;
    float best = __uint_as_float(0xff800000u);  // -inf
    for (int r = 0; r < BUCKET; ++r) {
      const int lr = lb * BUCKET + r;
      float s = sc[lr * LDS + j];
      if (row0 + lr >= n_valid) s = NEG_SENTINEL;
      // row0 is a multiple of 64, so r is the row's in-bucket index.
      unsigned bits = (__float_as_uint(s) & ~63u) | static_cast<unsigned>(r);
      if ((bits & 0x7f800000u) == 0u) bits &= 0x80000000u;
      best = fmaxf(best, __uint_as_float(bits));
    }
    out[(static_cast<long long>(blockIdx.x) * 2 + lb) * b + q0 + j] = best;
    __syncthreads();  // the next query tile rewrites the staged tiles
  }
}

}  // namespace

// xs [n, d] bf16 row-major, qs [b, d] bf16 row-major, out [n / 64, b] f32.
// n % 128 == 0, d % 64 == 0, b % 128 == 0, 16-byte aligned pointers: the
// Python wrapper checks all of it.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int hx_bucket_scores(const void* xs, const void* qs, void* out,
                                long long n, int d, int b, int n_valid,
                                void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      bucket_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n / BM));
  bucket_scores_kernel<<<grid, THREADS, SMEM_BYTES,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(xs),
      static_cast<const __nv_bfloat16*>(qs), static_cast<float*>(out), d, b,
      n_valid);
  return static_cast<int>(cudaGetLastError());
}
