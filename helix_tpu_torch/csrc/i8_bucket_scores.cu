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
// The dots are exact integers (|sum| <= 127 * 127 * D), converted with
// __int2float_rn as the plain version converts them (exact up to D = 1040,
// correctly rounded beyond), so the result equals the plain version
// (ops/quant.py:i8_bucket_scores_reference) bit for bit, index bits
// included.
//
// What bounds it on an H100: at N = 1,007,616, D = 128, B = 256 it must
// read 129 MB of codes and write 16 MB of winners (145 MB, 43 us at 3.35
// TB/s) and do 66 G integer operations (33 us at 1,979 TOP/s): the two
// floors are close, so loads, products and the epilogue have to overlap.
// The design is kernel 1's (bucket_scores.cu, pieces in hopper.cuh):
//
// - Persistent grid of min(buckets, SMs) blocks walking 64-row buckets.
// - Queries resident in shared memory (B * D bytes, 32 KB at B = 256,
//   D = 128), loaded once per block; where they do not fit beside rings
//   of at least 4 stages (B = 256 from D = 640), each stage carries its
//   K-chunk of them instead.
// - Rows through a TMA ring per consumer warpgroup: boxes of 128 int8
//   columns (one 128-byte swizzle row) x 64 rows, 8 KB, fed by one
//   producer thread whose warpgroup gives its registers up (setmaxnreg).
// - wgmma m64n256k32 (B = 256) / m64n128k32 (B = 128) s8 x s8 -> s32,
//   both operands K-major from the swizzled stages, four K steps of 32
//   bytes per chunk; int32 sums in registers (B / 2 per thread).
// - Epilogue in registers: __int2float_rn of each sum after the wait,
//   the pack with the row mask folded in, the bucket max by
//   reduce-scatter shuffles and a 4-warp merge, one flush per output.

#include "hopper.cuh"

namespace {

using namespace hx;

constexpr int KCHUNK = SWIZZLE_BYTES;  // int8 columns in one swizzle row

Plan make_i8_plan(int d, int b) { return make_plan(1LL * b * d, b, 0); }

// NT = B / 128 query tiles.  RESIDENT: the queries stay in shared memory
// for the block's life; otherwise each stage carries its K-chunk of them.
template <int NT, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
    i8_bucket_scores_kernel(const __grid_constant__ CUtensorMap rows_map,
                            const __grid_constant__ CUtensorMap queries_map,
                            float* __restrict__ out, int n_buckets,
                            int n_valid, int k_chunks, int depth,
                            int stage_bytes) {
  constexpr int B = 128 * NT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t q_addr = smem_u32(base);
  const uint32_t ring = q_addr + (RESIDENT ? B * KCHUNK * k_chunks : 0);
  float* red = reinterpret_cast<float*>(base + (ring - q_addr) +
                                        CONSUMERS * depth * stage_bytes);
  // Stage s of consumer c: ring + (c * depth + s) * stage_bytes, its
  // barriers full + 8 * (c * MAX_DEPTH + s) and empty + the same.
  const uint32_t full = smem_u32(red + CONSUMERS * 2 * 4 * B);
  const uint32_t empty = full + 8 * CONSUMERS * MAX_DEPTH;
  const uint32_t q_bar = empty + 8 * CONSUMERS * MAX_DEPTH;

  if (threadIdx.x == 0) {
    for (int c = 0; c < CONSUMERS; ++c)
      for (int s = 0; s < depth; ++s) {
        mbar_init(full + 8 * (c * MAX_DEPTH + s), 1);
        mbar_init(empty + 8 * (c * MAX_DEPTH + s), 128);
      }
    mbar_init(q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int grid = gridDim.x;
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  if (wg == CONSUMERS) {
    // Producer warpgroup: one thread keeps both rings full, the block's
    // buckets alternating between them.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (t != 0) return;
    if (RESIDENT) {
      mbar_expect_tx(q_bar, B * KCHUNK * k_chunks);
      for (int k = 0; k < k_chunks; ++k)
        tma_load(q_addr + k * B * KCHUNK, &queries_map, q_bar, k * KCHUNK,
                 0);
    }
    fill_rings<RESIDENT>(&rows_map, &queries_map, ring, full, empty,
                         n_buckets, k_chunks, depth, stage_bytes, KCHUNK);
    return;
  }

  // Consumers: warpgroup wg takes the block's buckets wg, wg + 2, ...
  // from its own ring, so it sees every round of its stages' barriers.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const uint32_t my_full = full + 8 * wg * MAX_DEPTH;
  const uint32_t my_empty = empty + 8 * wg * MAX_DEPTH;
  const uint32_t my_ring = ring + wg * depth * stage_bytes;

  int acc[NT * 64];
#pragma unroll
  for (int i = 0; i < NT * 64; ++i) acc[i] = 0;

  if (RESIDENT) mbar_wait(q_bar, 0);
  int iter = 0;
  for (int bucket = blockIdx.x + wg * grid; bucket < n_buckets;
       bucket += CONSUMERS * grid, ++iter) {
    s8_products<NT, RESIDENT>(acc, my_full, my_empty, my_ring, q_addr,
                              static_cast<uint32_t>(iter) * k_chunks,
                              k_chunks, depth, stage_bytes);
    float* buf = red + (wg * 2 + (iter & 1)) * 4 * B;
    bucket_epilogue<NT>(acc, buf, out + static_cast<long long>(bucket) * B,
                        bucket * BUCKET, n_valid, wg, t,
                        [](float v) { return v; });
  }
}

template <int NT, bool RESIDENT>
int launch(const CUtensorMap& rows_map, const CUtensorMap& queries_map,
           float* out, int n_buckets, int n_valid, int k_chunks,
           const Plan& plan, cudaStream_t stream) {
  int sms = 0;
  const int err = ready<i8_bucket_scores_kernel<NT, RESIDENT>>(&sms);
  if (err != 0) return err;
  const int grid = n_buckets < sms ? n_buckets : sms;
  i8_bucket_scores_kernel<NT, RESIDENT><<<grid, THREADS, plan.smem_bytes,
                                          stream>>>(
      rows_map, queries_map, out, n_buckets, n_valid, k_chunks, plan.depth,
      plan.stage_bytes);
  return launched(stream, static_cast<int>(cudaGetLastError()));
}

}  // namespace

// The plan for d, b: {queries resident (0/1), stages per consumer, stage
// bytes, dynamic shared memory}; returns -3 when the shapes are not taken.
extern "C" int hx_i8_bucket_scores_plan(int d, int b, int* plan) {
  if (d <= 0 || d % KCHUNK || (b != 128 && b != 256)) return -3;
  const Plan p = make_i8_plan(d, b);
  plan[0] = p.resident;
  plan[1] = p.depth;
  plan[2] = p.stage_bytes;
  plan[3] = p.smem_bytes;
  return p.depth < 2 ? -3 : 0;
}

// xs [n, d] int8 row-major, q [b, d] int8 row-major, out [n / 64, b] f32,
// with n % 64 == 0 and n < 2^31, d % 128 == 0, b in {128, 256} and
// 16-byte aligned pointers (the Python wrapper checks all of it).
// Launches on `stream` and returns 0 on success, HX_CAPTURED where the
// stream captures a CUDA graph, a cudaError_t, or -1 when libcuda offers
// no cuTensorMapEncodeTiled, -2 when it refuses a tensor map, -3 when the
// shapes are not taken.  It does not synchronise.
extern "C" int hx_i8_bucket_scores(const void* xs, const void* q, void* out,
                                   long long n, int d, int b, int n_valid,
                                   void* stream) {
  if (n <= 0 || n % BUCKET || n >= (1LL << 31) || d <= 0 || d % KCHUNK ||
      (b != 128 && b != 256))
    return -3;
  const Plan plan = make_i8_plan(d, b);
  if (plan.depth < 2) return -3;
  if (!encode_tiled()) return -1;
  // Bytes are bytes: the maps copy int8 codes as UINT8.
  CUtensorMap rows_map, queries_map;
  if (!encode(&rows_map, xs, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, n, d, KCHUNK,
              BUCKET, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&queries_map, q, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, b, d, KCHUNK,
              b, CU_TENSOR_MAP_SWIZZLE_128B))
    return -2;
  const int n_buckets = static_cast<int>(n / BUCKET);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k_chunks = d / KCHUNK;
  if (b == 256)
    return plan.resident
               ? launch<2, true>(rows_map, queries_map, o, n_buckets, n_valid,
                                 k_chunks, plan, s)
               : launch<2, false>(rows_map, queries_map, o, n_buckets,
                                  n_valid, k_chunks, plan, s);
  return plan.resident
             ? launch<1, true>(rows_map, queries_map, o, n_buckets, n_valid,
                               k_chunks, plan, s)
             : launch<1, false>(rows_map, queries_map, o, n_buckets, n_valid,
                                k_chunks, plan, s);
}
