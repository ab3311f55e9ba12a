// Packed bucket-max scores over packed int4 codes: the fused coarse phase
// of the int4 rung of the residency ladder.
//
// Replaces the Pallas kernel helix_tpu/ops/quant4.py:_i4_bucket_scores
// (body _make_i4_kernel, epilogue fused_topk.bucket_reduce_packed and
// fused_topk.descale_packed).  Inputs: packed [N, D/2] uint8 (byte c of a
// row holds column c in its low nibble and column D/2 + c in its high
// nibble, each a signed 4-bit value in [-7, 7]; rows scale-sorted so each
// 64-row bucket shares one scale), bucket_scales [N / 64] f32, and the
// int8 queries q [B, D] in chunk order (q_perm below).  For every row r
// and query j:
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
// Hopper's tensor cores have no s4 x s8 product, so the nibbles are
// unpacked to int8 in shared memory.  Packed chunk k (bytes [64k, 64k +
// 64) of a row) sign-extends to 128 int8 values, [lo | hi]: row columns
// [64k, 64k + 64) ++ [D/2 + 64k, D/2 + 64k + 64).  The wrapper hands the
// kernel q_perm, whose 128-column chunk k is those two query column ranges
// side by side (one gather of B x D bytes; the identity at D = 128), so
// an unpacked stage is exactly kernel 2's operand and the products are
// kernel 2's: one m64nBk32 sequence per chunk.
//
// What bounds it on an H100: at N = 1,007,616, D = 128, B = 256 it must
// read 64 MB of packed codes and write 16 MB of winners (80 MB, 24 us at
// 3.35 TB/s) and do the same 66 G integer operations as kernel 2 (33 us
// at 1,979 TOP/s), so it is bound by operations.  The unpack writes 128 MB
// into shared memory that wgmma reads back: on-chip traffic, not
// device-memory traffic.  The design is kernel 2's (hopper.cuh) plus an
// unpack stage:
//
// - The producer thread brings packed boxes of 64 bytes x 64 rows (4 KB)
//   by TMA into a staging ring (PACKED_DEPTH stages, no swizzle) and, when
//   the queries stream, each chunk of q_perm into the consumer's stage.
// - The producer warpgroup's other three warps (UNPACKERS threads) wait
//   for a staged box, sign-extend it four nibbles per 32-bit operation
//   into the consumer's 8 KB int8 stage in the 128-byte swizzle TMA would
//   have written (16-byte chunk index XOR row % 8), execute
//   fence.proxy.async.shared::cta (the stores are generic-proxy writes
//   that wgmma reads through the async proxy), and arrive on the stage's
//   full barrier, which counts them (and the producer when queries
//   stream), then release the staging slot.
// - The consumers are kernel 2's; their epilogue ends in the de-scale.

#include "hopper.cuh"

namespace {

using namespace hx;

constexpr int KCHUNK = SWIZZLE_BYTES;      // unpacked int8 columns per chunk
constexpr int PACKED_CHUNK = KCHUNK / 2;   // packed bytes per chunk
constexpr int PACKED_TILE_BYTES = BUCKET * PACKED_CHUNK;  // 4 KB
constexpr int PACKED_DEPTH = 8;            // staging ring stages
constexpr int UNPACKERS = 96;              // warps 1-3 of the producer group
constexpr int STAGING_BYTES = PACKED_DEPTH * PACKED_TILE_BYTES;
constexpr int EXTRA_BYTES = STAGING_BYTES + 2 * PACKED_DEPTH * 8;

Plan make_i4_plan(int d, int b) {
  return make_plan(1LL * b * d, b, EXTRA_BYTES);
}

// Sign-extend the low nibble of each byte of `nibbles`, byte by byte: a
// 4-bit value v in [-8, 7] held as t = v ^ 8 = v + 8 becomes the byte
// t - 8 with no borrow between bytes, since each byte is first lifted by
// 0x80 and dropped after.
__device__ __forceinline__ uint32_t sign_extend_nibbles(uint32_t nibbles) {
  return (((nibbles & 0x0F0F0F0Fu) ^ 0x88888888u) - 0x08080808u) ^
         0x80808080u;
}

// Unpack staged packed box `src` (64 rows x 64 bytes) into the 128-byte
// swizzled int8 stage `dst` (64 rows x 128 bytes): input 16-byte chunk j
// of row r gives the low nibbles at chunk j and the high nibbles at chunk
// 4 + j of the row, each at chunk index XOR (r % 8).  The loop is
// unrolled so that each thread's loads are in flight together.
__device__ __forceinline__ void unpack_box(const unsigned char* src,
                                           unsigned char* dst, int u) {
  constexpr int CHUNKS = BUCKET * PACKED_CHUNK / 16;
#pragma unroll
  for (int step = 0; step < (CHUNKS + UNPACKERS - 1) / UNPACKERS; ++step) {
    const int i = u + step * UNPACKERS;
    if (i >= CHUNKS) break;
    const int r = i >> 2;
    const int j = i & 3;
    const uint4 p = *reinterpret_cast<const uint4*>(src + 16 * i);
    unsigned char* row = dst + r * SWIZZLE_BYTES;
    *reinterpret_cast<uint4*>(row + ((j ^ (r & 7)) << 4)) =
        make_uint4(sign_extend_nibbles(p.x), sign_extend_nibbles(p.y),
                   sign_extend_nibbles(p.z), sign_extend_nibbles(p.w));
    *reinterpret_cast<uint4*>(row + (((4 + j) ^ (r & 7)) << 4)) =
        make_uint4(sign_extend_nibbles(p.x >> 4),
                   sign_extend_nibbles(p.y >> 4),
                   sign_extend_nibbles(p.z >> 4),
                   sign_extend_nibbles(p.w >> 4));
  }
}

// NT = B / 128 query tiles.  RESIDENT: q_perm stays in shared memory for
// the block's life; otherwise each stage carries its K-chunk of it.
template <int NT, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
    i4_bucket_scores_kernel(const __grid_constant__ CUtensorMap packed_map,
                            const __grid_constant__ CUtensorMap queries_map,
                            const float* __restrict__ bucket_scales,
                            float* __restrict__ out, int n_buckets,
                            int n_valid, int k_chunks, int depth,
                            int stage_bytes) {
  constexpr int B = 128 * NT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t q_addr = smem_u32(base);
  const uint32_t ring = q_addr + (RESIDENT ? B * KCHUNK * k_chunks : 0);
  const uint32_t staging = ring + CONSUMERS * depth * stage_bytes;
  float* red =
      reinterpret_cast<float*>(base + (staging - q_addr) + STAGING_BYTES);
  // Stage s of consumer c: ring + (c * depth + s) * stage_bytes, its
  // barriers full + 8 * (c * MAX_DEPTH + s) and empty + the same; staging
  // slot p: staging + p * PACKED_TILE_BYTES, barriers pfull + 8 p and
  // pempty + 8 p.
  const uint32_t full = smem_u32(red + CONSUMERS * 2 * 4 * B);
  const uint32_t empty = full + 8 * CONSUMERS * MAX_DEPTH;
  const uint32_t q_bar = empty + 8 * CONSUMERS * MAX_DEPTH;
  const uint32_t pfull = q_bar + 8;
  const uint32_t pempty = pfull + 8 * PACKED_DEPTH;

  if (threadIdx.x == 0) {
    for (int c = 0; c < CONSUMERS; ++c)
      for (int s = 0; s < depth; ++s) {
        mbar_init(full + 8 * (c * MAX_DEPTH + s),
                  UNPACKERS + (RESIDENT ? 0 : 1));
        mbar_init(empty + 8 * (c * MAX_DEPTH + s), 128);
      }
    mbar_init(q_bar, 1);
    for (int p = 0; p < PACKED_DEPTH; ++p) {
      mbar_init(pfull + 8 * p, 1);
      mbar_init(pempty + 8 * p, UNPACKERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int grid = gridDim.x;
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  if (wg == CONSUMERS) {
    // Producer warpgroup: thread 0 issues the TMA loads, warps 1-3
    // unpack; both walk the block's buckets in the same order, the
    // buckets alternating between the consumers' rings.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (t == 0) {
      if (RESIDENT) {
        mbar_expect_tx(q_bar, B * KCHUNK * k_chunks);
        for (int k = 0; k < k_chunks; ++k)
          tma_load(q_addr + k * B * KCHUNK, &queries_map, q_bar, k * KCHUNK,
                   0);
      }
      int item = 0;
      uint32_t pseq = 0;
      for (int bucket = blockIdx.x; bucket < n_buckets;
           bucket += grid, ++item) {
        const int c = item % CONSUMERS;
        uint32_t seq = static_cast<uint32_t>(item / CONSUMERS) * k_chunks;
        for (int k = 0; k < k_chunks; ++k, ++seq, ++pseq) {
          const uint32_t p = pseq % PACKED_DEPTH;
          const uint32_t pround = pseq / PACKED_DEPTH;
          if (pround) mbar_wait(pempty + 8 * p, (pround - 1) & 1);
          mbar_expect_tx(pfull + 8 * p, PACKED_TILE_BYTES);
          tma_load(staging + p * PACKED_TILE_BYTES, &packed_map, pfull + 8 * p,
                   k * PACKED_CHUNK, bucket * BUCKET);
          if (!RESIDENT) {
            const uint32_t s = seq % depth;
            const uint32_t round = seq / depth;
            const uint32_t bar = 8 * (c * MAX_DEPTH + s);
            if (round) mbar_wait(empty + bar, (round - 1) & 1);
            mbar_expect_tx(full + bar, B * KCHUNK);
            tma_load(ring + (c * depth + s) * stage_bytes + ROW_TILE_BYTES,
                     &queries_map, full + bar, k * KCHUNK, 0);
          }
        }
      }
    } else if (t >= 32) {
      const int u = t - 32;
      const unsigned char* staged = base + (staging - q_addr);
      unsigned char* rings = base + (ring - q_addr);
      int item = 0;
      uint32_t pseq = 0;
      for (int bucket = blockIdx.x; bucket < n_buckets;
           bucket += grid, ++item) {
        const int c = item % CONSUMERS;
        uint32_t seq = static_cast<uint32_t>(item / CONSUMERS) * k_chunks;
        for (int k = 0; k < k_chunks; ++k, ++seq, ++pseq) {
          const uint32_t p = pseq % PACKED_DEPTH;
          const uint32_t s = seq % depth;
          const uint32_t round = seq / depth;
          const uint32_t bar = 8 * (c * MAX_DEPTH + s);
          mbar_wait(pfull + 8 * p, (pseq / PACKED_DEPTH) & 1);
          if (round) mbar_wait(empty + bar, (round - 1) & 1);
          unpack_box(staged + p * PACKED_TILE_BYTES,
                     rings + (c * depth + s) * stage_bytes, u);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          mbar_arrive(full + bar);
          mbar_arrive(pempty + 8 * p);
        }
      }
    }
    return;
  }

  // Consumers: kernel 2's, with the de-scale at the end of the epilogue.
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
    const float scale = bucket_scales[bucket];
    float* buf = red + (wg * 2 + (iter & 1)) * 4 * B;
    // descale_packed: split the index off, one f32 multiply, re-pack,
    // flush again.
    bucket_epilogue<NT>(
        acc, buf, out + static_cast<long long>(bucket) * B, bucket * BUCKET,
        n_valid, wg, t, [scale](float w) {
          const uint32_t bits = __float_as_uint(w);
          const float scaled = __fmul_rn(__uint_as_float(bits & ~63u), scale);
          return flush_denormal(
              __uint_as_float((__float_as_uint(scaled) & ~63u) | (bits & 63u)));
        });
  }
}

template <int NT, bool RESIDENT>
int launch(const CUtensorMap& packed_map, const CUtensorMap& queries_map,
           const float* bucket_scales, float* out, int n_buckets, int n_valid,
           int k_chunks, const Plan& plan, cudaStream_t stream) {
  int sms = 0;
  const int err = ready<i4_bucket_scores_kernel<NT, RESIDENT>>(&sms);
  if (err != 0) return err;
  const int grid = n_buckets < sms ? n_buckets : sms;
  i4_bucket_scores_kernel<NT, RESIDENT><<<grid, THREADS, plan.smem_bytes,
                                          stream>>>(
      packed_map, queries_map, bucket_scales, out, n_buckets, n_valid,
      k_chunks, plan.depth, plan.stage_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The plan for d, b: {queries resident (0/1), stages per consumer, stage
// bytes, dynamic shared memory}; returns -3 when the shapes are not taken.
extern "C" int hx_i4_bucket_scores_plan(int d, int b, int* plan) {
  if (d <= 0 || d % KCHUNK || (b != 128 && b != 256)) return -3;
  const Plan p = make_i4_plan(d, b);
  plan[0] = p.resident;
  plan[1] = p.depth;
  plan[2] = p.stage_bytes;
  plan[3] = p.smem_bytes;
  return p.depth < 2 ? -3 : 0;
}

// packed [n, d / 2] uint8 row-major, bucket_scales [n / 64] f32, q_perm
// [b, d] int8 row-major (the queries in chunk order), out [n / 64, b] f32,
// with n % 64 == 0 and n < 2^31, d % 128 == 0, b in {128, 256} and
// 16-byte aligned pointers (the Python wrapper checks all of it).
// Launches on `stream` and returns 0 on success, a cudaError_t, or -1 when
// libcuda offers no cuTensorMapEncodeTiled, -2 when it refuses a tensor
// map, -3 when the shapes are not taken.  It does not synchronise.
extern "C" int hx_i4_bucket_scores(const void* packed,
                                   const void* bucket_scales,
                                   const void* q_perm, void* out, long long n,
                                   int d, int b, int n_valid, void* stream) {
  if (n <= 0 || n % BUCKET || n >= (1LL << 31) || d <= 0 || d % KCHUNK ||
      (b != 128 && b != 256))
    return -3;
  const Plan plan = make_i4_plan(d, b);
  if (plan.depth < 2) return -3;
  if (!encode_tiled()) return -1;
  CUtensorMap packed_map, queries_map;
  if (!encode(&packed_map, packed, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, n, d / 2,
              PACKED_CHUNK, BUCKET, CU_TENSOR_MAP_SWIZZLE_NONE) ||
      !encode(&queries_map, q_perm, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, b, d,
              KCHUNK, b, CU_TENSOR_MAP_SWIZZLE_128B))
    return -2;
  const int n_buckets = static_cast<int>(n / BUCKET);
  const float* sc = static_cast<const float*>(bucket_scales);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k_chunks = d / KCHUNK;
  if (b == 256)
    return plan.resident
               ? launch<2, true>(packed_map, queries_map, sc, o, n_buckets,
                                 n_valid, k_chunks, plan, s)
               : launch<2, false>(packed_map, queries_map, sc, o, n_buckets,
                                  n_valid, k_chunks, plan, s);
  return plan.resident
             ? launch<1, true>(packed_map, queries_map, sc, o, n_buckets,
                               n_valid, k_chunks, plan, s)
             : launch<1, false>(packed_map, queries_map, sc, o, n_buckets,
                                n_valid, k_chunks, plan, s);
}
