// l2 scores of the exact rung's single-shot scan, written once as f32.
//
// Replaces no Pallas kernel: the reference leaves this step to XLA
// (helix_tpu/ops/distance.py:topk_resident, the l2 single shot: a bf16
// dot with f32 sums, `2.0 * sims - sq_norms`, the row mask).  It takes
// the place of the port's plain PyTorch expression of the same step
// (ops/distance.py:l2_scores_reference), which casts the whole bf16
// matrix to f32, runs an f32 product without tensor cores and then makes
// three more passes over the [B, N] scores.  For every row r of the bf16
// matrix xs [N, D] and query j of qs [B, D]:
//
//   s         = sum_d xs[r, d] * qs[j, d]     (f32 accumulation)
//   out[j, r] = 2 s - sq[r]                   if r <  n_valid
//   out[j, r] = -inf                          if r >= n_valid
//
// A bf16 x bf16 product is exact in f32, so only the order of the sums
// differs from the plain version; 2 s is exact, so the epilogue's one
// rounding (an fma of 2, s and -sq) is the plain version's subtraction.
// It must not be built with --use_fast_math.
//
// What bounds it on an H100: at N = 1,000,448, D = 128, B = 256 it reads
// 256 MB of bf16 rows, 4 MB of norms and 64 KB of queries and writes
// 1.02 GB of scores: 1.284 GB, 0.383 ms at 3.35 TB/s, against 65.5 GFLOP
// (0.066 ms at 989 TFLOP/s).  The write decides, so the design keeps the
// stores in flight while the products and the loads run:
//
// - Kernel 1's pipeline (hopper.cuh): a persistent grid of one block per
//   SM over 64-row tiles, one producer thread filling a TMA ring of 64-row
//   x 64-column swizzled bf16 stages per consumer, all the queries
//   resident in shared memory where they fit (else each stage carries its
//   K-chunk of them), and two consumer warpgroups on alternate tiles, each
//   issuing m64nWk16 bf16 products (W = 128 or 256 queries) with f32 sums
//   in registers.
// - The epilogue: each consumer writes its tile's 64 x W scores, as
//   2 s - sq or -inf, into a staging buffer in shared memory laid out as
//   the TMA store's boxes (32 rows of f32 = one 128-byte swizzle row per
//   query, the 128-byte swizzle keeping the writes free of bank
//   conflicts), and one thread hands the buffer to the TMA unit, which
//   writes each query's 64 scores of the tile as 256 contiguous bytes.
//   The consumer goes on to its next tile's products while the store
//   drains; it waits only before it writes the same buffer again.  Up to
//   two buffers of 128 queries per consumer (all W queries of a tile at
//   once where they fit), so two to four tiles' stores are in flight per
//   SM.
// - The store map has the caller's row count, so query rows past it (the
//   compute width's padding) are never written, and the query map's rows
//   past it load as zeros.

#include "hopper.cuh"

namespace {

using namespace hx;

constexpr int KCHUNK = 64;                              // bf16 columns a stage
constexpr int PART = 128;                               // queries a store part
constexpr int BOX_ROWS = 32;                            // tile rows a store box
constexpr int BOX_BYTES = PART * SWIZZLE_BYTES;         // 16 KB
constexpr int PART_BYTES = 2 * BOX_BYTES;               // a part's 64 rows
constexpr int BAR_BYTES = (2 * CONSUMERS * MAX_DEPTH + 1) * 8;

// Shared memory, from a 1024-byte aligned base: [resident queries]
// [each consumer's `parts` staging buffers][each consumer's ring of
// `depth` stages][mbarriers].
struct L2Plan {
  bool resident;
  int parts;  // staging buffers per consumer: 1, or W / 128
  int depth;  // ring stages per consumer
  int stage_bytes;
  int smem_bytes;
};

// The plan follows from D and the compute width alone: queries resident
// and a staging buffer for every part of a tile where that leaves two
// ring stages per consumer, else one staging buffer, else queries carried
// by the stages.
L2Plan make_l2_plan(int d, int width) {
  const long long room = SMEM_LIMIT - 1024 - BAR_BYTES;
  for (int resident = 1; resident >= 0; --resident)
    for (int parts = width / PART; parts >= 1; --parts) {
      const long long q = resident ? 2LL * width * d : 0;
      const int stage = ROW_TILE_BYTES + (resident ? 0 : width * SWIZZLE_BYTES);
      const long long fit =
          (room - q - static_cast<long long>(CONSUMERS) * parts * PART_BYTES) /
          (CONSUMERS * stage);
      if (fit >= 2) {
        L2Plan p{};
        p.resident = resident;
        p.parts = parts;
        p.depth = static_cast<int>(fit < MAX_DEPTH ? fit : MAX_DEPTH);
        p.stage_bytes = stage;
        p.smem_bytes = static_cast<int>(1024 + BAR_BYTES + q +
                                        CONSUMERS * parts * PART_BYTES +
                                        CONSUMERS * p.depth * stage);
        return p;
      }
    }
  return L2Plan{false, 0, 0, 0, 0};
}

// One TMA store of a box of the map at (column c0, row c1) from shared
// memory, in the issuing thread's bulk group.
__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src,
                                          int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}

// Until at most N of this thread's bulk groups still read shared memory.
template <int N>
__device__ __forceinline__ void store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
}

// NT = W / 128 query tiles.  RESIDENT: the queries stay in shared memory
// for the block's life; otherwise each stage carries its K-chunk of them.
template <int NT, bool RESIDENT>
__global__ void __launch_bounds__(THREADS, 1)
    l2_scores_kernel(const __grid_constant__ CUtensorMap rows_map,
                     const __grid_constant__ CUtensorMap queries_map,
                     const __grid_constant__ CUtensorMap out_map,
                     const float* __restrict__ sq, int n_buckets, int n_valid,
                     int k_chunks, int parts, int depth, int stage_bytes) {
  constexpr int B = PART * NT;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t q_addr = smem_u32(base);
  const uint32_t staging = q_addr + (RESIDENT ? B * KCHUNK * 2 * k_chunks : 0);
  const uint32_t ring = staging + CONSUMERS * parts * PART_BYTES;
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
    // Producer warpgroup: kernel 1's (hopper.cuh's fill_rings).
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (t != 0) return;
    if (RESIDENT) {
      mbar_expect_tx(q_bar, B * KCHUNK * 2 * k_chunks);
      for (int k = 0; k < k_chunks; ++k)
        tma_load(q_addr + k * B * KCHUNK * 2, &queries_map, q_bar,
                 k * KCHUNK, 0);
    }
    fill_rings<RESIDENT>(&rows_map, &queries_map, ring, full, empty,
                         n_buckets, k_chunks, depth, stage_bytes, KCHUNK);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const uint32_t my_full = full + 8 * wg * MAX_DEPTH;
  const uint32_t my_empty = empty + 8 * wg * MAX_DEPTH;
  const uint32_t my_ring = ring + wg * depth * stage_bytes;
  const uint32_t my_staging = staging + wg * parts * PART_BYTES;

  // Value i of a 128-query part of the accumulator sits at tile row
  // r0 + 8 * ((i >> 1) & 1) and query 8 * (i >> 2) + 2 * (lane % 4) +
  // (i & 1).  Rows 0-31 go to the part's first store box, 32-63 to its
  // second (warps 0-1 and 2-3); within a box, query q's 32 rows are one
  // 128-byte row whose 16-byte chunk c sits at chunk c ^ (q % 8).
  const int warp = t / 32;
  const int lane = t % 32;
  const int r0 = warp * 16 + lane / 4;
  const uint32_t box_row0 = (warp & 1) * 4 + lane / 16;  // (r0 % 32) / 4
  const uint32_t in_chunk = (lane / 4) % 4;              // r0 % 4
  const uint32_t q_lane = 2 * (lane % 4);
  const uint32_t my_box = (warp >> 1) * BOX_BYTES;
  const float NEG_INF = __uint_as_float(0xff800000u);

  float acc[NT * 64];
#pragma unroll
  for (int i = 0; i < NT * 64; ++i) acc[i] = 0.0f;

  if (RESIDENT) mbar_wait(q_bar, 0);
  int iter = 0;
  for (int tile = blockIdx.x + wg * grid; tile < n_buckets;
       tile += CONSUMERS * grid, ++iter) {
    const int row0 = tile * BUCKET;
    const float neg_sq0 = -__ldg(sq + row0 + r0);
    const float neg_sq1 = -__ldg(sq + row0 + r0 + 8);
    const bool dead0 = row0 + r0 >= n_valid;
    const bool dead1 = row0 + r0 + 8 >= n_valid;

    bf16_products<NT, RESIDENT>(acc, my_full, my_empty, my_ring, q_addr,
                                static_cast<uint32_t>(iter) * k_chunks,
                                k_chunks, depth, stage_bytes);

#pragma unroll
    for (int h = 0; h < NT; ++h) {
      // The buffer is free once the store that last read it has: with
      // one buffer a consumer that store, with NT buffers the one NT - 1
      // stores back.
      const int buf = parts == 1 ? 0 : h;
      if (t == 0) {
        if (parts == 1)
          store_wait_read<0>();
        else
          store_wait_read<NT - 1>();
      }
      wg_sync(wg);
      const uint32_t part_addr = my_staging + buf * PART_BYTES;
      float* dst = reinterpret_cast<float*>(base + (part_addr - q_addr) +
                                            my_box);
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int second = (i >> 1) & 1;
        const float v = __fmaf_rn(2.0f, acc[64 * h + i],
                                  second ? neg_sq1 : neg_sq0);
        const bool dead = second ? dead1 : dead0;
        const uint32_t qq = 8 * (i >> 2) + q_lane + (i & 1);
        const uint32_t chunk = (box_row0 + 2 * second) ^ (qq & 7);
        dst[qq * 32 + chunk * 4 + in_chunk] = dead ? NEG_INF : v;
      }
      // The generic-proxy writes, then the TMA unit's reads of them.
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      wg_sync(wg);
      if (t == 0) {
        tma_store(&out_map, part_addr, row0, h * PART);
        tma_store(&out_map, part_addr + BOX_BYTES, row0 + BOX_ROWS, h * PART);
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
      }
    }
  }
  // The block's shared memory must outlive the stores that read it.
  if (t == 0) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}

template <int NT, bool RESIDENT>
int launch(const CUtensorMap& rows_map, const CUtensorMap& queries_map,
           const CUtensorMap& out_map, const float* sq, int n_buckets,
           int n_valid, int k_chunks, const L2Plan& plan,
           cudaStream_t stream) {
  int sms = 0;
  const int err = ready<l2_scores_kernel<NT, RESIDENT>>(&sms);
  if (err != 0) return err;
  const int grid = n_buckets < sms ? n_buckets : sms;
  l2_scores_kernel<NT, RESIDENT><<<grid, THREADS, plan.smem_bytes, stream>>>(
      rows_map, queries_map, out_map, sq, n_buckets, n_valid, k_chunks,
      plan.parts, plan.depth, plan.stage_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// xs [n, d] bf16 row-major, qs [rows, d] bf16 row-major, sq [n] f32, out
// [rows, n] f32 row-major, with n % 64 == 0 and n < 2^31, d % 64 == 0,
// 1 <= rows <= width, width in {128, 256} and 16-byte aligned pointers
// (the Python wrapper checks all of it).  The products run over `width`
// queries, the missing rows of qs as zeros; only the `rows` rows of out
// are written.  Launches on `stream` and returns 0 on success, a
// cudaError_t, or -1 when libcuda offers no cuTensorMapEncodeTiled, -2
// when it refuses a tensor map, -3 when the shapes are not taken.  It
// does not synchronise.
extern "C" int hx_l2_scores(const void* xs, const void* qs, const void* sq,
                            void* out, long long n, int d, int rows,
                            int width, int n_valid, void* stream) {
  if (n <= 0 || n % BUCKET || n >= (1LL << 31) || d <= 0 || d % KCHUNK ||
      (width != 128 && width != 256) || rows < 1 || rows > width)
    return -3;
  const L2Plan plan = make_l2_plan(d, width);
  if (plan.depth < 2) return -3;
  if (!encode_tiled()) return -1;
  CUtensorMap rows_map, queries_map, out_map;
  if (!encode(&rows_map, xs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, n, d,
              KCHUNK, BUCKET, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&queries_map, qs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, rows, d,
              KCHUNK, width, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&out_map, out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, rows,
              static_cast<int>(n), BOX_ROWS, rows < PART ? rows : PART,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return -2;
  const int n_buckets = static_cast<int>(n / BUCKET);
  const float* s = static_cast<const float*>(sq);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int k_chunks = d / KCHUNK;
  if (width == 256)
    return plan.resident
               ? launch<2, true>(rows_map, queries_map, out_map, s, n_buckets,
                                 n_valid, k_chunks, plan, st)
               : launch<2, false>(rows_map, queries_map, out_map, s,
                                  n_buckets, n_valid, k_chunks, plan, st);
  return plan.resident
             ? launch<1, true>(rows_map, queries_map, out_map, s, n_buckets,
                               n_valid, k_chunks, plan, st)
             : launch<1, false>(rows_map, queries_map, out_map, s, n_buckets,
                                n_valid, k_chunks, plan, st);
}
