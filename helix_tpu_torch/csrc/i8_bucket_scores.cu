// Packed bucket-max scores over int8 codes: the fused coarse phase of the
// int8 rung of the residency ladder.
//
// Replaces the Pallas kernel helix_tpu/ops/quant.py:_i8_bucket_scores (body
// _make_i8_kernel, epilogue fused_topk.bucket_reduce_packed).  For every row
// r of the int8 matrix xs [N, D] (cosine rows quantized with one global
// scale, so raw integer dots rank correctly) and every query j of the int8
// queries q [B, D]:
//
//   s = float(sum_d xs[r, d] * q[j, d])    (exact int32 sum, __int2float_rn)
//   s = NEG_SENTINEL                        if r >= n_valid
//   packed = (bits(s) & ~63) | (r & 63), denormal -> signed zero
//   out[r / 64, j] = fmaxf over the bucket's 64 packed values
//
// The dots are exact integers, so the result equals the plain version
// (ops/quant.py:i8_bucket_scores_reference) bit for bit, index bits
// included.
//
// What bounds it on an H100: at N = 1,007,616, D = 128, B = 256 it reads
// 129 MB of codes and does 66 G integer operations, ~510 operations per
// byte, just under the int8 ridge (~590 at 1,979 TOP/s and 3.35 TB/s): the
// two floors are close (~39 us of reads, ~33 us of tensor-core work), and
// mma.sync reaches well under wgmma's peak, so at this batch it is
// compute-heavy.  The design is the simple one (int8_tile.cuh): mma.sync
// m16n8k32 s8 from shared memory with synchronous 16-byte staging; wgmma
// s8 and TMA are later work.

#include "int8_tile.cuh"

namespace {

using namespace hx_int8;

constexpr size_t SMEM_BYTES = (BM + BN) * LDA + SCORE_BYTES;

__global__ void __launch_bounds__(THREADS)
i8_bucket_scores_kernel(const int8_t* __restrict__ xs,
                        const int8_t* __restrict__ q,
                        float* __restrict__ out, int d, int b, int n_valid) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* xs_s = reinterpret_cast<int8_t*>(smem);
  int8_t* qs_s = xs_s + BM * LDA;
  int* sc = reinterpret_cast<int*>(qs_s + BN * LDA);

  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;

  for (int q0 = 0; q0 < b; q0 += BN) {
    int acc[MT][NT][4];
    zero_acc(acc);
    for (int k0 = 0; k0 < d; k0 += KC) {
      for (int idx = threadIdx.x; idx < BM * CHUNKS; idx += THREADS) {
        const int r = idx / CHUNKS;
        const int c = (idx % CHUNKS) * 16;
        *reinterpret_cast<uint4*>(xs_s + r * LDA + c) =
            *reinterpret_cast<const uint4*>(xs + (row0 + r) * d + k0 + c);
      }
      for (int idx = threadIdx.x; idx < BN * CHUNKS; idx += THREADS) {
        const int r = idx / CHUNKS;
        const int c = (idx % CHUNKS) * 16;
        *reinterpret_cast<uint4*>(qs_s + r * LDA + c) =
            *reinterpret_cast<const uint4*>(
                q + static_cast<long long>(q0 + r) * d + k0 + c);
      }
      __syncthreads();
      mma_chunk(acc, xs_s, qs_s, wm, wn, lane);
      __syncthreads();
    }
    store_acc(acc, sc, wm, wn, lane);
    __syncthreads();

    const int lb = threadIdx.x / BN;
    const int j = threadIdx.x % BN;
    out[(static_cast<long long>(blockIdx.x) * 2 + lb) * b + q0 + j] =
        bucket_max(sc, lb, j, row0, n_valid);
    __syncthreads();  // the next query tile rewrites the score tile
  }
}

}  // namespace

// xs [n, d] int8 row-major, q [b, d] int8 row-major, out [n / 64, b] f32.
// n % 128 == 0, d % 64 == 0, b % 128 == 0, 16-byte aligned pointers: the
// Python wrapper checks all of it.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it does not synchronise.
extern "C" int hx_i8_bucket_scores(const void* xs, const void* q, void* out,
                                   long long n, int d, int b, int n_valid,
                                   void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      i8_bucket_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n / BM));
  i8_bucket_scores_kernel<<<grid, THREADS, SMEM_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xs), static_cast<const int8_t*>(q),
      static_cast<float*>(out), d, b, n_valid);
  return static_cast<int>(cudaGetLastError());
}
