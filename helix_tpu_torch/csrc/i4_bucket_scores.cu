// Packed bucket-max scores over packed int4 codes: the fused coarse phase
// of the int4 rung of the residency ladder.
//
// Replaces the Pallas kernel helix_tpu/ops/quant4.py:_i4_bucket_scores
// (body _make_i4_kernel, epilogue fused_topk.bucket_reduce_packed and
// fused_topk.descale_packed).  Inputs: packed [N, D/2] uint8 (byte c of a
// row holds column c in its low nibble and column D/2 + c in its high
// nibble, each a signed 4-bit value in [-7, 7]; rows scale-sorted so each
// 64-row bucket shares one scale), bucket_scales [N / 64] f32, q [B, D]
// int8.  For every row r and query j:
//
//   s = float(lo(r) . q[j, :D/2] + hi(r) . q[j, D/2:])   (exact int32)
//   s = NEG_SENTINEL                                     if r >= n_valid
//   w = fmaxf over the bucket of (bits(s) & ~63) | (r & 63), denormal -> 0
//   out[r / 64, j] = repack(clean(w) * bucket_scales[r / 64], index(w))
//
// where the re-pack keeps w's 6 index bits and applies the denormal rule
// again.  The scale multiply is one f32 multiply with nothing to contract
// (no fast-math), so the result equals the plain version
// (ops/quant4.py:i4_bucket_scores_reference) bit for bit.
//
// Hopper's tensor cores have no s4 x s8 product and the query side keeps 8
// bits, so the kernel unpacks in shared memory: a staged chunk of packed
// bytes [k0, k0 + KC) holds row columns k0.. in its low nibbles and
// D/2 + k0.. in its high nibbles; each nibble is sign-extended into one of
// two int8 tiles, the two matching query column ranges are staged beside
// them, and two int8 products add into one accumulator.  The full-width row
// is never built.
//
// What bounds it on an H100: at N = 1,007,616, D = 128, B = 256 it reads
// 64 MB of packed codes (~19 us at 3.35 TB/s) and does the same 66 G
// integer operations as the int8 kernel (~33 us at 1,979 TOP/s), so it is
// compute-bound; the unpack adds shared-memory traffic and integer work,
// not device-memory traffic.

#include "int8_tile.cuh"

namespace {

using namespace hx_int8;

constexpr size_t SMEM_BYTES = 2 * (BM + BN) * LDA + SCORE_BYTES;

// Sign-extend the two nibbles of each byte of w: lo gets the low nibbles,
// hi the high ones, byte for byte.
__device__ __forceinline__ void unpack_word(unsigned w, unsigned& lo,
                                            unsigned& hi) {
  lo = 0u;
  hi = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned p = (w >> (8 * i)) & 0xffu;
    const unsigned l = static_cast<unsigned>(static_cast<int>(p << 28) >> 28);
    const unsigned h = static_cast<unsigned>(static_cast<int>(p << 24) >> 28);
    lo |= (l & 0xffu) << (8 * i);
    hi |= (h & 0xffu) << (8 * i);
  }
}

__global__ void __launch_bounds__(THREADS)
i4_bucket_scores_kernel(const uint8_t* __restrict__ packed,
                        const float* __restrict__ bucket_scales,
                        const int8_t* __restrict__ q,
                        float* __restrict__ out, int d, int b, int n_valid) {
  extern __shared__ __align__(128) unsigned char smem[];
  int8_t* xlo_s = reinterpret_cast<int8_t*>(smem);
  int8_t* xhi_s = xlo_s + BM * LDA;
  int8_t* qlo_s = xhi_s + BM * LDA;
  int8_t* qhi_s = qlo_s + BN * LDA;
  int* sc = reinterpret_cast<int*>(qhi_s + BN * LDA);

  const int h = d / 2;  // packed bytes per row
  const long long row0 = static_cast<long long>(blockIdx.x) * BM;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;

  for (int q0 = 0; q0 < b; q0 += BN) {
    int acc[MT][NT][4];
    zero_acc(acc);
    for (int k0 = 0; k0 < h; k0 += KC) {
      for (int idx = threadIdx.x; idx < BM * CHUNKS; idx += THREADS) {
        const int r = idx / CHUNKS;
        const int c = (idx % CHUNKS) * 16;
        const uint4 p = *reinterpret_cast<const uint4*>(
            packed + (row0 + r) * h + k0 + c);
        uint4 lo, hi;
        unpack_word(p.x, lo.x, hi.x);
        unpack_word(p.y, lo.y, hi.y);
        unpack_word(p.z, lo.z, hi.z);
        unpack_word(p.w, lo.w, hi.w);
        *reinterpret_cast<uint4*>(xlo_s + r * LDA + c) = lo;
        *reinterpret_cast<uint4*>(xhi_s + r * LDA + c) = hi;
      }
      for (int idx = threadIdx.x; idx < BN * CHUNKS; idx += THREADS) {
        const int r = idx / CHUNKS;
        const int c = (idx % CHUNKS) * 16;
        const int8_t* row = q + static_cast<long long>(q0 + r) * d;
        *reinterpret_cast<uint4*>(qlo_s + r * LDA + c) =
            *reinterpret_cast<const uint4*>(row + k0 + c);
        *reinterpret_cast<uint4*>(qhi_s + r * LDA + c) =
            *reinterpret_cast<const uint4*>(row + h + k0 + c);
      }
      __syncthreads();
      mma_chunk(acc, xlo_s, qlo_s, wm, wn, lane);
      mma_chunk(acc, xhi_s, qhi_s, wm, wn, lane);
      __syncthreads();
    }
    store_acc(acc, sc, wm, wn, lane);
    __syncthreads();

    const int lb = threadIdx.x / BN;
    const int j = threadIdx.x % BN;
    const long long bucket = static_cast<long long>(blockIdx.x) * 2 + lb;
    const unsigned w = __float_as_uint(bucket_max(sc, lb, j, row0, n_valid));
    // descale_packed: split the index off, one f32 multiply, re-pack.
    const float clean = __uint_as_float(w & ~63u);
    const float scaled = __fmul_rn(clean, bucket_scales[bucket]);
    const unsigned bits = (__float_as_uint(scaled) & ~63u) | (w & 63u);
    out[bucket * b + q0 + j] = __uint_as_float(flush_denormal(bits));
    __syncthreads();  // the next query tile rewrites the score tile
  }
}

}  // namespace

// packed [n, d / 2] uint8 row-major, bucket_scales [n / 64] f32, q [b, d]
// int8 row-major, out [n / 64, b] f32.  n % 128 == 0, d % 128 == 0,
// b % 128 == 0, 16-byte aligned pointers: the Python wrapper checks all of
// it.  Launches on `stream` and returns cudaGetLastError() (0 on success);
// it does not synchronise.
extern "C" int hx_i4_bucket_scores(const void* packed,
                                   const void* bucket_scales, const void* q,
                                   void* out, long long n, int d, int b,
                                   int n_valid, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      i4_bucket_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(SMEM_BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n / BM));
  i4_bucket_scores_kernel<<<grid, THREADS, SMEM_BYTES,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(packed),
      static_cast<const float*>(bucket_scales),
      static_cast<const int8_t*>(q), static_cast<float*>(out), d, b,
      n_valid);
  return static_cast<int>(cudaGetLastError());
}
