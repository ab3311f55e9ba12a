// Packed bucket-max scores over int8 codes: the fused coarse phase of the
// int8 rung of the residency ladder.
//
// Replaces the Pallas kernel helix_tpu/ops/quant.py:_i8_bucket_scores (body
// _make_i8_kernel, epilogue fused_topk.bucket_reduce_packed).  For every row
// r of the int8 matrix xs [N, D] (cosine rows quantized with one global
// scale, so raw integer dots rank correctly) and every query j of the int8
// queries q [B, D]:
//
//   s = float(sum_d xs[r, d] * q[j, d])    (exact int32 sum, rounded)
//   s = NEG_SENTINEL                        if r >= n_valid
//   packed = (bits(s) & ~63) | (r & 63), denormal -> signed zero
//   out[r / 64, j] = fmaxf over the bucket's 64 packed values
//
// The dots are exact integers (|sum| <= 128 * 128 * D).  Up to D =
// EXACT_ADD_MAX_D (256) |sum| <= 2^22, and the sum becomes its f32 by an
// exact add: bits(1.5 * 2^23) + sum is the f32 1.5 * 2^23 + sum, and
// subtracting 1.5 * 2^23 leaves sum itself (an integer add and a float
// subtract; measured below against __int2float_rn).  Wider D converts
// with __int2float_rn, as the plain version does (exact up to D = 1040,
// correctly rounded beyond).  Either way the result equals the plain
// version (ops/quant.py:i8_bucket_scores_reference) bit for bit, index
// bits included.
//
// What bounds it on an H100 (SXM, 700 W), at the int8 cell's shape
// (34,004,992 x 128 codes, B = 256): the bytes, 4.9 GB, take 1.46 ms at
// 3.35 TB/s, and the products, 2.2 T integer operations, 1.13 ms at 1,979
// TOP/s; the epilogue packs and reduces 8.7 G sums.  With the bucket's
// rows on wgmma's M side and the queries on N (the bf16 kernel's layout)
// each thread holds 2 rows x 128 queries, so the bucket max is a
// reduce-scatter over the lane bits 4, 3, 2, a bar.sync and a merge of
// four warps through shared memory: that kernel took 3.7 ms.  Here the
// queries are on M and the bucket's rows on N:
//
// - Persistent grid of min(buckets, SMs) blocks walking 64-row buckets;
//   two consumer warpgroups take alternate buckets, each from its own TMA
//   ring, fed by one producer thread (hopper.cuh: fill_rings) whose
//   warpgroup gives its registers up (setmaxnreg).
// - Queries resident in shared memory (B * D bytes, 32 KB at B = 256,
//   D = 128), loaded once per block; where they do not fit beside rings
//   of at least 4 stages (B = 256 from D = 640), each stage carries its
//   K-chunk of them instead.  Row tiles: boxes of 128 int8 columns (one
//   128-byte swizzle row) x 64 rows, 8 KB.
// - wgmma m64n64k32 s8 x s8 -> s32: A = 64 queries, B = the bucket's 64
//   rows (K-major from the swizzled stage); B / 64 query tiles, four K
//   steps of 32 bytes per chunk.  At D = 128 (one K-chunk) each thread
//   keeps its A fragments of every query tile in registers (64 at B =
//   256), loaded once per block, so the products read only the rows from
//   shared memory, and a last K step in which every query is zero (a
//   D = 96 index padded to 128) is skipped; wider D reads A from the
//   resident or carried queries.  Each thread holds 16 of the bucket's
//   rows (8 g + 2 (lane % 4) + {0, 1}) for each of its two queries of
//   every tile: 32 sums a tile.
// - Epilogue in registers, nothing through shared memory.  At D <= 256
//   each sum v first becomes the integer key v * 64 + row (one LEA, and
//   one three-way max per two sums); where a winner's v lies in
//   [0, 2^18), which unit-norm codes keep it in, the largest key is the
//   packed max.  Otherwise, and at wider D, each sum takes the float way:
//   the conversion (the exact add at D <= 256), one LOP3 for the pack
//   (the row's low bits 8 g + e an immediate, the mask in a register; the
//   lane's 2 (lane % 4) go in after the max, which commutes with it) and
//   one fmaxf.  Three shuffles per two tiles over the lane bits 0 and 1
//   leave each lane one winner to flush and store.  A bucket with rows
//   past n_valid (one per launch) takes the float way with each row's
//   mask applied.
//
// Measured at the cell's shape (CUDA events, unit rows of width 96 padded
// to 128): 2.3 ms against the rows-on-M kernel's 3.7.  Loads alone take
// 1.50 ms and the products alone 1.22 ms at four K steps (92% of the int8
// peak), but the products and the epilogue hardly overlap: one
// warpgroup's float epilogue beside the other's products slowed those
// products by two thirds.  So the sum of the tensor and the ALU work per
// bucket, not the bytes, bounds the kernel, and each step cut one of the
// two: A from registers (3.39 -> 2.89 ms with the float epilogue), the
// integer keys (2.89 -> 2.40), the skipped zero K step (2.40 -> 2.3).  In
// the float way the exact add beats the one instruction __int2float_rn
// compiles to here (2.89 against 3.18 ms).

#include "hopper.cuh"

namespace {

using namespace hx;

constexpr int KCHUNK = SWIZZLE_BYTES;  // int8 columns in one swizzle row
constexpr int QTILE = 64;              // queries per wgmma (its M)
// The widest D whose dots stay within the exact add's +-2^22.
constexpr int EXACT_ADD_MAX_D = 256;
static_assert(128LL * 128 * EXACT_ADD_MAX_D <= (1LL << 22),
              "the exact add needs |sum| <= 2^22");

// The plan of kernel 1's shape (hopper.cuh: make_plan).  Its reduction
// buffers go unused here; keeping them keeps each shape's plan, and the
// width from which the queries stream, as they were.
Plan make_i8_plan(int d, int b) { return make_plan(1LL * b * d, b, 0); }

// The A fragments of the resident queries (one K-chunk, 128-byte swizzled
// at q_addr) for this thread: af[m][kk] of query tile m, K step kk, laid
// out as wgmma_m64n64k32_s8_rs takes them.
template <int MT>
__device__ __forceinline__ void load_fragments(int (&af)[MT][4][4],
                                               uint32_t q_addr, int t) {
  const int warp = t / 32;
  const int lane = t % 32;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t row = QTILE * m + 16 * warp + lane / 4 + 8 * (i & 1);
        const uint32_t col = 32 * kk + 4 * (lane % 4) + 16 * (i >> 1);
        const uint32_t off = row * SWIZZLE_BYTES + col;
        asm volatile("ld.shared.b32 %0, [%1];"
                     : "=r"(af[m][kk][i])
                     : "r"(q_addr + (off ^ (((off >> 7) & 7) << 4))));
      }
}

// A sum as the f32 score the reference packs: the exact add where
// |v| <= 2^22 (EXACT), else the conversion rounded to nearest.
template <bool EXACT>
__device__ __forceinline__ float score_of(int v) {
  if constexpr (EXACT)
    return __fsub_rn(__int_as_float(v + 0x4B400000), 12582912.0f);
  else
    return __int2float_rn(v);
}

// The products of one bucket against MT query tiles: for each 128-column
// K-chunk, wait for its stage, issue MT x 4 m64n64k32 products (K steps
// of +32 bytes in the swizzle row) of the queries (resident at q_addr, or
// carried by the stage after its row tile) against the stage's rows, and
// release the previous chunk's stage once its products are done.  No
// instruction but the products touches the accumulators from the first
// product to wgmma_wait<0>.
template <int MT, bool RESIDENT>
__device__ __forceinline__ void query_products(int (&acc)[MT][32],
                                               uint32_t my_full,
                                               uint32_t my_empty,
                                               uint32_t my_ring,
                                               uint32_t q_addr,
                                               uint32_t seq0, int k_chunks,
                                               int depth, int stage_bytes) {
  constexpr int B = QTILE * MT;
  uint32_t prev = 0;
#pragma unroll
  for (int m = 0; m < MT; ++m) fence_acc(acc[m]);
  for (int k = 0; k < k_chunks; ++k) {
    const uint32_t seq = seq0 + k;
    const uint32_t s = seq % depth;
    mbar_wait(my_full + 8 * s, (seq / depth) & 1);
    wgmma_fence();
    const uint32_t rows = my_ring + s * stage_bytes;
    const uint32_t q =
        RESIDENT ? q_addr + k * B * SWIZZLE_BYTES : rows + ROW_TILE_BYTES;
#pragma unroll
    for (int kk = 0; kk < SWIZZLE_BYTES / 32; ++kk)
#pragma unroll
      for (int m = 0; m < MT; ++m)
        wgmma_m64n64k32_s8(
            acc[m], sw128_desc(q + m * QTILE * SWIZZLE_BYTES + kk * 32),
            sw128_desc(rows + kk * 32), k | kk);
    wgmma_commit();
    if (k > 0) {
      // every thread arrives, so no branch sits between the products
      wgmma_wait<1>();
      mbar_arrive(my_empty + 8 * prev);
    }
    prev = s;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < MT; ++m) fence_acc(acc[m]);
  mbar_arrive(my_empty + 8 * prev);
}

// The products of one bucket in its one K-chunk against MT query tiles
// held in registers (af): wait for the stage, issue the MT x 4
// m64n64k32 products, release the stage once they are done.
template <int MT, int KS>
__device__ __forceinline__ void fragment_products(int (&acc)[MT][32],
                                                  const int (&af)[MT][4][4],
                                                  uint32_t my_full,
                                                  uint32_t my_empty,
                                                  uint32_t my_ring,
                                                  uint32_t seq, int depth,
                                                  int stage_bytes) {
  const uint32_t s = seq % depth;
#pragma unroll
  for (int m = 0; m < MT; ++m) fence_acc(acc[m]);
  mbar_wait(my_full + 8 * s, (seq / depth) & 1);
  wgmma_fence();
  const uint32_t rows = my_ring + s * stage_bytes;
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int m = 0; m < MT; ++m)
      wgmma_m64n64k32_s8_rs(acc[m], af[m][kk], sw128_desc(rows + kk * 32),
                            kk);
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < MT; ++m) fence_acc(acc[m]);
  mbar_arrive(my_empty + 8 * s);
}

// This lane's packed max over its 16 rows of the bucket for its query
// row H of one tile (sums a[4 g + 2 H + e], in-bucket rows 8 g + c2 + e,
// c2 = 2 (lane % 4)).  `keep` is ~63 in a register, so the pack of a
// live row is one LOP3 with the immediate 8 g + e; c2 goes in after the
// max, which it does not reorder (bits disjoint from every packed value's).
// TAIL: rows at or past `live` (n_valid less the bucket's first row) take
// the sentinel's high bits instead of their score's.
template <bool EXACT, bool TAIL, int H>
__device__ __forceinline__ float lane_winner(const int (&a)[32], uint32_t keep,
                                             uint32_t c2, int live) {
  const uint32_t neg_hi = __float_as_uint(NEG_SENTINEL) & ~63u;
  float m = 0.0f;
#pragma unroll
  for (int g = 0; g < 8; ++g)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const uint32_t k = 8 * g + e;
      const uint32_t bits =
          __float_as_uint(score_of<EXACT>(a[4 * g + 2 * H + e]));
      uint32_t p = (bits & keep) | k;
      if constexpr (TAIL)
        p = static_cast<int>(k | c2) >= live ? (neg_hi | k) : p;
      const float v = __uint_as_float(p);
      m = (g | e) ? fmaxf(m, v) : v;
    }
  return __uint_as_float(__float_as_uint(m) | c2);
}

// This lane's largest key v * 64 + (in-bucket row less c2) over its 16
// sums v for query row H of one tile (rows as in lane_winner).  Where the
// bucket's largest sum is in [0, 2^18) its f32 has the 6 low bits zero
// and every sum at or above 0 is below 2^18, so the packed max is the row
// of the largest key, higher rows winning ties as the pack makes them;
// sums below 0 pack below every one at or above it.  |v| * 64 <= 2^28
// where EXACT.
template <int H>
__device__ __forceinline__ int lane_key(const int (&a)[32]) {
  int m = a[2 * H] * 64;
#pragma unroll
  for (int g = 0; g < 8; ++g)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (g | e) m = max(m, a[4 * g + 2 * H + e] * 64 + (8 * g + e));
  return m;
}

// The epilogue of thread t of a consumer for one bucket, after its
// products: each pair of query tiles gives 4 lane winners (2 query rows x
// 2 tiles); lanes that differ in bit 0 trade query rows and those that
// differ in bit 1 trade tiles, so each lane ends with the bucket's winner
// of one query, flushed and written to dst (the bucket's B outputs).
// Where EXACT, a live bucket first takes the integer keys (lane_key: two
// instructions a sum); a pair of tiles in which any of the warp's winners
// lies outside [0, 2^18) is done again the float way (lane_winner: the
// conversion, the pack, the max).
template <int MT, bool EXACT, bool TAIL>
__device__ __forceinline__ void bucket_winners(const int (&acc)[MT][32],
                                               float* dst, int live, int t,
                                               uint32_t keep) {
  const int warp = t / 32;
  const int lane = t % 32;
  const uint32_t c2 = 2 * (lane % 4);
  const bool odd = lane & 1;
  const bool upper = lane & 2;
#pragma unroll
  for (int m = 0; m < MT; m += 2) {
    if constexpr (EXACT && !TAIL) {
      const int ka0 = lane_key<0>(acc[m]) | c2;
      const int ka1 = lane_key<1>(acc[m]) | c2;
      const int kb0 = lane_key<0>(acc[m + 1]) | c2;
      const int kb1 = lane_key<1>(acc[m + 1]) | c2;
      const int xa = max(odd ? ka1 : ka0,
                         __shfl_xor_sync(0xffffffffu, odd ? ka0 : ka1, 1));
      const int xb = max(odd ? kb1 : kb0,
                         __shfl_xor_sync(0xffffffffu, odd ? kb0 : kb1, 1));
      const int w = max(upper ? xb : xa,
                        __shfl_xor_sync(0xffffffffu, upper ? xa : xb, 2));
      if (__all_sync(0xffffffffu, static_cast<uint32_t>(w) < (1u << 24))) {
        const float f = score_of<EXACT>(w >> 6);
        dst[QTILE * (m + upper) + 16 * warp + lane / 4 + 8 * odd] =
            flush_denormal(__uint_as_float(__float_as_uint(f) | (w & 63)));
        continue;
      }
    }
    const float a0 = lane_winner<EXACT, TAIL, 0>(acc[m], keep, c2, live);
    const float a1 = lane_winner<EXACT, TAIL, 1>(acc[m], keep, c2, live);
    const float b0 = lane_winner<EXACT, TAIL, 0>(acc[m + 1], keep, c2, live);
    const float b1 = lane_winner<EXACT, TAIL, 1>(acc[m + 1], keep, c2, live);
    const float xa =
        fmaxf(odd ? a1 : a0, __shfl_xor_sync(0xffffffffu, odd ? a0 : a1, 1));
    const float xb =
        fmaxf(odd ? b1 : b0, __shfl_xor_sync(0xffffffffu, odd ? b0 : b1, 1));
    const float w = fmaxf(upper ? xb : xa,
                          __shfl_xor_sync(0xffffffffu, upper ? xa : xb, 2));
    dst[QTILE * (m + upper) + 16 * warp + lane / 4 + 8 * odd] =
        flush_denormal(w);
  }
}

template <int MT, bool EXACT>
__device__ __forceinline__ void write_winners(const int (&acc)[MT][32],
                                              float* out, int bucket,
                                              int n_valid, int t,
                                              uint32_t keep) {
  float* dst = out + static_cast<long long>(bucket) * (QTILE * MT);
  const int live = n_valid - bucket * BUCKET;
  if (live >= BUCKET)
    bucket_winners<MT, EXACT, false>(acc, dst, live, t, keep);
  else
    bucket_winners<MT, EXACT, true>(acc, dst, live, t, keep);
}

// A consumer's buckets first, first + stride, ... with the queries' A
// fragments in registers and KS of the chunk's four K steps.
template <int MT, int KS>
__device__ __forceinline__ void consume_fragments(
    int (&acc)[MT][32], const int (&af)[MT][4][4], uint32_t my_full,
    uint32_t my_empty, uint32_t my_ring, int first, int stride,
    int n_buckets, int depth, int stage_bytes, float* out, int n_valid,
    int t, uint32_t keep) {
  uint32_t iter = 0;
  for (int bucket = first; bucket < n_buckets; bucket += stride, ++iter) {
    fragment_products<MT, KS>(acc, af, my_full, my_empty, my_ring, iter,
                              depth, stage_bytes);
    write_winners<MT, true>(acc, out, bucket, n_valid, t, keep);
  }
}

// Whether any of the B resident queries has a code other than 0 in the
// last K step (columns 96 to 127) of the one K-chunk, the same answer on
// every thread of consumer `wg` (an OR over its 128 threads at named
// barrier 1 + wg).  Where none has, that step's products add nothing and
// are skipped: a D = 96 index stores its codes, and its queries,
// zero-padded to 128 (PackedMatrix.DIM_PAD).
template <int B>
__device__ __forceinline__ bool last_step_live(uint32_t q_addr, int wg,
                                               int t) {
  uint32_t any = 0;
  for (int row = t; row < B; row += 128) {
#pragma unroll
    for (int chunk = 6; chunk < 8; ++chunk) {
      uint32_t a, b, c, d;
      asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
                   : "=r"(a), "=r"(b), "=r"(c), "=r"(d)
                   : "r"(q_addr + row * SWIZZLE_BYTES +
                         16 * (chunk ^ (row & 7))));
      any |= a | b | c | d;
    }
  }
  uint32_t all;
  asm volatile(
      "{\n"
      ".reg .pred q, p;\n"
      "setp.ne.u32 q, %1, 0;\n"
      "bar.red.or.pred p, %2, 128, q;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(all)
      : "r"(any), "r"(1 + wg)
      : "memory");
  return __reduce_or_sync(0xffffffffu, all) != 0;
}

// MT = B / 64 query tiles.  RESIDENT: the queries stay in shared memory
// for the block's life; otherwise each stage carries its K-chunk of them.
// EXACT: the sums convert by the exact add (D <= EXACT_ADD_MAX_D).
// FRAGMENTS (D = 128: one K-chunk, resident, exact): the queries' A
// fragments sit in registers.  `keep` is ~63, passed at run time so that
// the pack's mask stays in a register (one LOP3 per sum, its other
// operand the row's immediate).
template <int MT, bool RESIDENT, bool EXACT, bool FRAGMENTS>
__global__ void __launch_bounds__(THREADS, 1)
    i8_bucket_scores_kernel(const __grid_constant__ CUtensorMap rows_map,
                            const __grid_constant__ CUtensorMap queries_map,
                            float* __restrict__ out, int n_buckets,
                            int n_valid, int k_chunks, int depth,
                            int stage_bytes, uint32_t keep) {
  static_assert(!FRAGMENTS || (RESIDENT && EXACT), "D = 128 only");
  constexpr int B = QTILE * MT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t q_addr = raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t ring = q_addr + (RESIDENT ? B * KCHUNK * k_chunks : 0);
  // Stage s of consumer c: ring + (c * depth + s) * stage_bytes, its
  // barriers full + 8 * (c * MAX_DEPTH + s) and empty + the same.
  const uint32_t full = ring + CONSUMERS * depth * stage_bytes;
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

  int acc[MT][32];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[m][i] = 0;

  const int first = blockIdx.x + wg * grid;
  const int stride = CONSUMERS * grid;
  if (RESIDENT) mbar_wait(q_bar, 0);
  if constexpr (FRAGMENTS) {
    int af[MT][4][4];
    load_fragments<MT>(af, q_addr, t);
    if (last_step_live<B>(q_addr, wg, t))
      consume_fragments<MT, 4>(acc, af, my_full, my_empty, my_ring, first,
                                  stride, n_buckets, depth, stage_bytes, out,
                                  n_valid, t, keep);
    else
      consume_fragments<MT, 3>(acc, af, my_full, my_empty, my_ring, first,
                                  stride, n_buckets, depth, stage_bytes, out,
                                  n_valid, t, keep);
  } else {
    int iter = 0;
    for (int bucket = first; bucket < n_buckets; bucket += stride, ++iter) {
      query_products<MT, RESIDENT>(acc, my_full, my_empty, my_ring, q_addr,
                                   static_cast<uint32_t>(iter) * k_chunks,
                                   k_chunks, depth, stage_bytes);
      write_winners<MT, EXACT>(acc, out, bucket, n_valid, t, keep);
    }
  }
}

template <int MT, bool RESIDENT, bool EXACT, bool FRAGMENTS>
int launch(const CUtensorMap& rows_map, const CUtensorMap& queries_map,
           float* out, int n_buckets, int n_valid, int k_chunks,
           const Plan& plan, cudaStream_t stream) {
  int sms = 0;
  const int err =
      ready<i8_bucket_scores_kernel<MT, RESIDENT, EXACT, FRAGMENTS>>(&sms);
  if (err != 0) return err;
  const int grid = n_buckets < sms ? n_buckets : sms;
  i8_bucket_scores_kernel<MT, RESIDENT, EXACT, FRAGMENTS>
      <<<grid, THREADS, plan.smem_bytes, stream>>>(
          rows_map, queries_map, out, n_buckets, n_valid, k_chunks,
          plan.depth, plan.stage_bytes, ~63u);
  return launched(stream, static_cast<int>(cudaGetLastError()));
}

// The instantiation for the plan and D: the exact add needs the queries
// resident (D <= 256 always is).
template <int MT>
int launch_for(const CUtensorMap& rows_map, const CUtensorMap& queries_map,
               float* out, int n_buckets, int n_valid, int d,
               const Plan& plan, cudaStream_t stream) {
  const int k_chunks = d / KCHUNK;
  if (!plan.resident)
    return launch<MT, false, false, false>(rows_map, queries_map, out,
                                           n_buckets, n_valid, k_chunks, plan,
                                           stream);
  if (k_chunks == 1)
    return launch<MT, true, true, true>(rows_map, queries_map, out, n_buckets,
                                        n_valid, k_chunks, plan, stream);
  return d <= EXACT_ADD_MAX_D
             ? launch<MT, true, true, false>(rows_map, queries_map, out,
                                             n_buckets, n_valid, k_chunks,
                                             plan, stream)
             : launch<MT, true, false, false>(rows_map, queries_map, out,
                                              n_buckets, n_valid, k_chunks,
                                              plan, stream);
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
  return b == 256 ? launch_for<4>(rows_map, queries_map, o, n_buckets,
                                  n_valid, d, plan, s)
                  : launch_for<2>(rows_map, queries_map, o, n_buckets,
                                  n_valid, d, plan, s);
}

