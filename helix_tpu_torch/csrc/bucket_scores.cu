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
// such a winner as a signed zero with index bits 0.  The flush is monotone
// in the float order, so flushing the bucket's max equals the max of the
// flushed values; the kernel applies it once per output.  It must not be
// built with --use_fast_math, whose flush would apply to every float
// operation instead.
//
// The pipeline's pieces (inline PTX, plan, epilogue, tensor maps) live in
// hopper.cuh, shared with the int8 and int4 kernels.
//
// What bounds it on an H100: at N = 1,007,616 (1M rows padded to 8192),
// D = 128, B = 256 the kernel must read 258 MB of bf16 rows and write
// 16 MB of winners (82 us at 3.35 TB/s) and do 66 GFLOP (67 us at 989
// TFLOP/s).  Both limits are close, so loads, tensor-core products and
// the epilogue all have to overlap.  The design:
//
// - Persistent grid: one block per SM walks 64-row buckets (bucket =
//   blockIdx.x + i * gridDim.x), so the ragged tail is at most one bucket
//   per block.
// - Queries resident in shared memory: a block loads all B queries once
//   (64 KB at B = 256, D = 128).  Where B * D * 2 does not fit beside
//   rings of at least MIN_RESIDENT_DEPTH stages (wide D), each stage
//   carries its K-chunk of the queries beside the rows instead.
// - Row tiles through rings of stages: one producer thread issues TMA
//   loads (cp.async.bulk.tensor, 128-byte swizzle) of 64 rows x 64
//   columns (8 KB); full/empty mbarriers hand stages over.  Each consumer
//   has its own ring: a parity wait on an mbarrier cannot tell round r
//   from round r - 2, so a stage must not be shared by consumers that
//   skip each other's rounds.
// - wgmma with M = 64 = one bucket: two consumer warpgroups take alternate
//   buckets, so one's epilogue overlaps the other's products.  Each
//   issues one m64nBk16 bf16 product per K step of 16 (n256 at B = 256:
//   the row tile is read from shared memory once for all queries) from
//   the swizzled ring stage and the swizzled queries; f32 sums stay in
//   registers (B / 2 per thread).  The producer warpgroup gives its
//   registers up (setmaxnreg) so the consumers hold 232 each.
// - Epilogue in registers: in the m64nNk16 accumulator layout a value's
//   row within the warpgroup is its in-bucket row, so each thread packs
//   its values with their row index, takes the max of its two rows,
//   reduce-scatters over the three lane bits that select rows (28
//   shuffles per 128 queries instead of 96), and the four warps merge
//   through a small shared buffer (4 x B floats) before B consecutive
//   floats per bucket are written.  No f32 score tile goes to shared
//   memory.

#include "hopper.cuh"

namespace {

using namespace hx;

constexpr int KCHUNK = 64;  // bf16 columns in one 128-byte swizzle row

Plan make_bf16_plan(int d, int b) { return make_plan(2LL * b * d, b, 0); }

// NT = B / 128 query tiles.  RESIDENT: the queries stay in shared memory
// for the block's life; otherwise each stage carries its K-chunk of them.
template <int NT, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
    bucket_scores_kernel(const __grid_constant__ CUtensorMap rows_map,
                         const __grid_constant__ CUtensorMap queries_map,
                         float* __restrict__ out, int n_buckets, int n_valid,
                         int k_chunks, int depth, int stage_bytes) {
  constexpr int B = 128 * NT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t q_addr = smem_u32(base);
  const uint32_t ring = q_addr + (RESIDENT ? B * KCHUNK * 2 * k_chunks : 0);
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
    // Producer warpgroup: hands its registers to the consumers, and one
    // thread keeps both rings full, the block's buckets alternating
    // between them.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (t != 0) return;
    if (RESIDENT) {
      mbar_expect_tx(q_bar, B * KCHUNK * 2 * k_chunks);
      for (int k = 0; k < k_chunks; ++k)
        tma_load(q_addr + k * B * KCHUNK * 2, &queries_map, q_bar,
                 k * KCHUNK, 0);
    }
    int item = 0;
    for (int bucket = blockIdx.x; bucket < n_buckets; bucket += grid, ++item) {
      const int c = item % CONSUMERS;
      uint32_t seq = static_cast<uint32_t>(item / CONSUMERS) * k_chunks;
      for (int k = 0; k < k_chunks; ++k, ++seq) {
        const uint32_t s = seq % depth;
        const uint32_t round = seq / depth;
        const uint32_t bar = 8 * (c * MAX_DEPTH + s);
        if (round) mbar_wait(empty + bar, (round - 1) & 1);
        const uint32_t stage = ring + (c * depth + s) * stage_bytes;
        mbar_expect_tx(full + bar, stage_bytes);
        tma_load(stage, &rows_map, full + bar, k * KCHUNK, bucket * BUCKET);
        if (!RESIDENT)
          tma_load(stage + ROW_TILE_BYTES, &queries_map, full + bar,
                   k * KCHUNK, 0);
      }
    }
    return;
  }

  // Consumers: warpgroup wg takes the block's buckets wg, wg + 2, ...
  // from its own ring, so it sees every round of its stages' barriers.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const uint32_t my_full = full + 8 * wg * MAX_DEPTH;
  const uint32_t my_empty = empty + 8 * wg * MAX_DEPTH;
  const uint32_t my_ring = ring + wg * depth * stage_bytes;

  float acc[NT * 64];
#pragma unroll
  for (int i = 0; i < NT * 64; ++i) acc[i] = 0.0f;

  if (RESIDENT) mbar_wait(q_bar, 0);
  int iter = 0;
  for (int bucket = blockIdx.x + wg * grid; bucket < n_buckets;
       bucket += CONSUMERS * grid, ++iter) {
    const uint32_t seq0 = static_cast<uint32_t>(iter) * k_chunks;
    uint32_t prev = 0;
    // No instruction but the products touches the accumulators from here
    // to wgmma_wait<0>: anything else would serialize the products.
    fence_acc(acc);
    for (int k = 0; k < k_chunks; ++k) {
      const uint32_t seq = seq0 + k;
      const uint32_t s = seq % depth;
      mbar_wait(my_full + 8 * s, (seq / depth) & 1);
      wgmma_fence();
      const uint32_t a = my_ring + s * stage_bytes;
      const uint32_t q = RESIDENT ? q_addr + k * B * KCHUNK * 2
                                  : a + ROW_TILE_BYTES;
#pragma unroll
      for (int kk = 0; kk < KCHUNK / 16; ++kk)
        wgmma_rows_queries<NT>(acc, sw128_desc(a + kk * 32),
                               sw128_desc(q + kk * 32), k | kk);
      wgmma_commit();
      if (k > 0) {
        // The previous chunk's products are done: release its stage (every
        // thread arrives, so no branch sits between the products).
        wgmma_wait<1>();
        mbar_arrive(my_empty + 8 * prev);
      }
      prev = s;
    }
    wgmma_wait<0>();
    fence_acc(acc);
    mbar_arrive(my_empty + 8 * prev);

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
  const int err = ready<bucket_scores_kernel<NT, RESIDENT>>(&sms);
  if (err != 0) return err;
  const int grid = n_buckets < sms ? n_buckets : sms;
  bucket_scores_kernel<NT, RESIDENT><<<grid, THREADS, plan.smem_bytes,
                                       stream>>>(
      rows_map, queries_map, out, n_buckets, n_valid, k_chunks, plan.depth,
      plan.stage_bytes);
  return launched(stream, static_cast<int>(cudaGetLastError()));
}

}  // namespace

// The plan for d, b: {queries resident (0/1), stages per consumer, stage
// bytes, dynamic shared memory}; returns -3 when the shapes are not taken.
extern "C" int hx_bucket_scores_plan(int d, int b, int* plan) {
  if (d <= 0 || d % KCHUNK || (b != 128 && b != 256)) return -3;
  const Plan p = make_bf16_plan(d, b);
  plan[0] = p.resident;
  plan[1] = p.depth;
  plan[2] = p.stage_bytes;
  plan[3] = p.smem_bytes;
  return p.depth < 2 ? -3 : 0;
}

// xs [n, d] bf16 row-major, qs [b, d] bf16 row-major, out [n / 64, b] f32,
// with n % 64 == 0 and n < 2^31, d % 64 == 0, b in {128, 256} and
// 16-byte aligned pointers (the Python wrapper checks all of it).
// Launches on `stream` and returns 0 on success, HX_CAPTURED where the
// stream captures a CUDA graph, a cudaError_t, or -1 when libcuda offers
// no cuTensorMapEncodeTiled, -2 when it refuses a tensor map, -3 when the
// shapes are not taken.  It does not synchronise.
extern "C" int hx_bucket_scores(const void* xs, const void* qs, void* out,
                                long long n, int d, int b, int n_valid,
                                void* stream) {
  if (n <= 0 || n % BUCKET || n >= (1LL << 31) || d <= 0 || d % KCHUNK ||
      (b != 128 && b != 256))
    return -3;
  const Plan plan = make_bf16_plan(d, b);
  if (plan.depth < 2) return -3;
  if (!encode_tiled()) return -1;
  CUtensorMap rows_map, queries_map;
  if (!encode(&rows_map, xs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, n, d,
              KCHUNK, BUCKET, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&queries_map, qs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, d,
              KCHUNK, b, CU_TENSOR_MAP_SWIZZLE_128B))
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
