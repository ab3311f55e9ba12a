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
// the epilogue all have to overlap.  At D = 1536 (N = 4,005,888, B = 256)
// the rows are 12.3 GB (3.69 ms) and the queries, 786 KB, no longer fit
// in shared memory.  The shape picks one of two plans, each its own
// kernel (hx_bucket_scores_plan: queries resident where they fit beside
// rings of MIN_RESIDENT_DEPTH stages, hopper.cuh's make_plan).
//
// Resident plan, bucket_scores_kernel<NT, true> (narrow D):
//
// - Persistent grid: one block per SM walks 64-row buckets (bucket =
//   blockIdx.x + i * gridDim.x), so the ragged tail is at most one bucket
//   per block.
// - Queries resident in shared memory: a block loads all B queries once
//   (64 KB at B = 256, D = 128).
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
//
// Streamed plan, bucket_scores_kernel_streamed<NT> (wide D): each stage
// carries a 64-column K-chunk of the queries beside the rows, so what
// the plan costs is how often a query chunk is read from L2 (one per 64
// rows would be 5x the rows' bytes at B = 256).  It spreads each chunk
// over 256 rows:
//
// - Cooperative 128-row tile: a block's stage is 128 rows (two buckets,
//   16 KB) and the K-chunk of all B queries (B x 128 bytes).  Both
//   consumer warpgroups read the same stage, each its own 64-row half
//   against the same query chunk, so one ring serves both (each sees
//   every round of every stage) and its `empty` barriers count both.
//   48 KB stages at B = 256 give a ring of 4.
// - Cluster of 2 blocks along the rows: a cluster walks 256-row tiles,
//   block r of it the tile's rows [128 r, 128 r + 128).  Each block loads
//   its own rows and half of the query chunk (B / 2 rows), the half by
//   TMA multicast (.multicast::cluster) into the same stage of both
//   blocks, so both full barriers count both halves.  A slot is refilled
//   only once all four consumers of the cluster have released it: each
//   consumer warpgroup arrives on the `empty` barrier of either block
//   (one thread each, mapa + a remote mbarrier.arrive), so a producer's
//   wait on its own `empty` barrier covers the peer's stage as well.  A
//   query chunk is read from L2 once per 256 rows: 1 + B / 256 times the
//   rows' bytes in all.
// - Persistent grid of clusters (as many as the card runs at once)
//   walking cluster tiles (tile = cluster + i * clusters).  Past N, TMA
//   fills zeros, a block with no rows left in its tile skips its rows'
//   load but still sends its query half, and no winner is written for a
//   bucket past N.  The producer fills the next tile's stages while the
//   consumers run their epilogue.  The blocks meet at a cluster barrier
//   after the barriers' init (no multicast or remote arrival finds one
//   uninitialised) and before they exit (none lands in a block gone).
// - Products and epilogue as in the resident plan: a bucket's sums come
//   from the same m64nBk16 products in the same K order in either plan,
//   so its packed winner does not depend on the plan.

#include "hopper.cuh"

namespace {

using namespace hx;

constexpr int KCHUNK = 64;  // bf16 columns in one 128-byte swizzle row

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

// ------------------------------------------------------- streamed plan

constexpr int CLUSTER = 2;                       // blocks, along the rows
constexpr int TILE_BYTES = CONSUMERS * ROW_TILE_BYTES;  // 128 rows, 16 KB
constexpr int CLUSTER_BUCKETS = CLUSTER * CONSUMERS;    // 256 rows

// One ring shared by both consumers, of stages of 128 rows and the
// K-chunk of all b queries; the reduction buffers and barriers as in
// make_plan (fixed_bytes).
Plan make_streamed_plan(int b) {
  Plan p{};
  p.stage_bytes = TILE_BYTES + b * SWIZZLE_BYTES;
  const int fit = (SMEM_LIMIT - fixed_bytes(b)) / p.stage_bytes;
  p.depth = fit < MAX_DEPTH ? fit : MAX_DEPTH;
  p.smem_bytes = fixed_bytes(b) + p.depth * p.stage_bytes;
  return p;
}

// The plan the shape makes: queries resident where make_plan fits them
// beside its rings, else the streamed plan.
Plan make_bf16_plan(int d, int b) {
  const Plan p = make_plan(2LL * b * d, b, 0);
  return p.resident ? p : make_streamed_plan(b);
}

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(r));
  return r;
}

// Every thread of both blocks: release what came before, acquire what
// the other block did before it arrived.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive;\n"
      "barrier.cluster.wait;\n" ::
          : "memory");
}

// One TMA tile of a 2-D tensor map at (c0, c1) into the same offset of
// the shared memory of every block in `mask`, each block's barrier at
// `bar`'s offset counting the bytes that land there.
__device__ __forceinline__ void tma_load_multicast(uint32_t dst,
                                                   const CUtensorMap* map,
                                                   uint32_t bar, int c0,
                                                   int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%3, %4}], [%2], %5;" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "h"(mask)
      : "memory");
}

// An arrival on the barrier at `bar`'s offset in block `cta` of the
// cluster, by the threads where `pred` is set: predicated inside the asm,
// so no branch sits between a consumer's products.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t cta,
                                                    uint32_t pred) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b32 remote;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "@p mapa.shared::cluster.u32 remote, %0, %1;\n"
      "@p mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" ::"r"(bar),
      "r"(cta), "r"(pred)
      : "memory");
}

template <int NT>
__global__ void __cluster_dims__(CLUSTER, 1, 1) __launch_bounds__(THREADS, 1)
    bucket_scores_kernel_streamed(const __grid_constant__ CUtensorMap rows_map,
                                  const __grid_constant__ CUtensorMap
                                      queries_map,
                                  float* __restrict__ out, int n_buckets,
                                  int n_valid, int k_chunks, int depth) {
  constexpr int B = 128 * NT;
  constexpr int HALF = B / CLUSTER;  // query rows each block multicasts
  constexpr int STAGE_BYTES = TILE_BYTES + B * SWIZZLE_BYTES;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  // [ring of `depth` stages][reduction buffers][full x depth][empty x depth]
  // at the same offsets in both blocks, which multicast and mapa rely on.
  const uint32_t ring = smem_u32(base);
  float* red = reinterpret_cast<float*>(base + depth * STAGE_BYTES);
  const uint32_t full = smem_u32(red + CONSUMERS * 2 * 4 * B);
  const uint32_t empty = full + 8 * MAX_DEPTH;

  if (threadIdx.x == 0) {
    for (int s = 0; s < depth; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * CLUSTER);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  cluster_sync();

  const uint32_t rank = cluster_rank();
  const int cluster = static_cast<int>(cluster_id());
  const int clusters = static_cast<int>(cluster_count());
  const int tiles = (n_buckets + CLUSTER_BUCKETS - 1) / CLUSTER_BUCKETS;
  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  if (wg == CONSUMERS) {
    // Producer warpgroup: one thread keeps the shared ring full.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (t == 0) {
      uint32_t seq = 0;
      for (int tile = cluster; tile < tiles; tile += clusters) {
        const int bucket0 = tile * CLUSTER_BUCKETS + rank * CONSUMERS;
        const bool rows = bucket0 < n_buckets;
        for (int k = 0; k < k_chunks; ++k, ++seq) {
          const uint32_t s = seq % depth;
          const uint32_t round = seq / depth;
          if (round) mbar_wait(empty + 8 * s, (round - 1) & 1);
          const uint32_t stage = ring + s * STAGE_BYTES;
          mbar_expect_tx(full + 8 * s,
                         rows ? STAGE_BYTES : STAGE_BYTES - TILE_BYTES);
          if (rows)
            tma_load(stage, &rows_map, full + 8 * s, k * KCHUNK,
                     bucket0 * BUCKET);
          tma_load_multicast(stage + TILE_BYTES + rank * HALF * SWIZZLE_BYTES,
                             &queries_map, full + 8 * s, k * KCHUNK,
                             rank * HALF, (1 << CLUSTER) - 1);
        }
      }
    }
  } else {
    // Consumers: warpgroup wg takes rows [64 wg, 64 wg + 64) of every
    // stage, bucket tile * 4 + 2 * rank + wg.  Its release of a stage
    // goes to the `empty` barrier of both blocks: thread 0 to block 0's,
    // thread 64 to block 1's.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
    const uint32_t signal = t % (128 / CLUSTER) == 0;
    const uint32_t to = t / (128 / CLUSTER);

    float acc[NT * 64];
#pragma unroll
    for (int i = 0; i < NT * 64; ++i) acc[i] = 0.0f;

    uint32_t seq = 0;
    int iter = 0;
    for (int tile = cluster; tile < tiles; tile += clusters, ++iter) {
      uint32_t prev = 0;
      // No instruction but the products touches the accumulators from
      // here to wgmma_wait<0>: anything else would serialize the products.
      fence_acc(acc);
      for (int k = 0; k < k_chunks; ++k, ++seq) {
        const uint32_t s = seq % depth;
        mbar_wait(full + 8 * s, (seq / depth) & 1);
        wgmma_fence();
        const uint32_t stage = ring + s * STAGE_BYTES;
        const uint32_t a = stage + wg * ROW_TILE_BYTES;
        const uint32_t q = stage + TILE_BYTES;
#pragma unroll
        for (int kk = 0; kk < KCHUNK / 16; ++kk)
          wgmma_rows_queries<NT>(acc, sw128_desc(a + kk * 32),
                                 sw128_desc(q + kk * 32), k | kk);
        wgmma_commit();
        if (k > 0) {
          wgmma_wait<1>();
          mbar_arrive_cluster(empty + 8 * prev, to, signal);
        }
        prev = s;
      }
      wgmma_wait<0>();
      fence_acc(acc);
      mbar_arrive_cluster(empty + 8 * prev, to, signal);

      const int bucket = tile * CLUSTER_BUCKETS + rank * CONSUMERS + wg;
      if (bucket < n_buckets) {
        float* buf = red + (wg * 2 + (iter & 1)) * 4 * B;
        bucket_epilogue<NT>(acc, buf,
                            out + static_cast<long long>(bucket) * B,
                            bucket * BUCKET, n_valid, wg, t,
                            [](float v) { return v; });
      }
    }
  }
  cluster_sync();
}

// The clusters of KERNEL the card runs at once with `smem` bytes of
// dynamic shared memory each block, once per device (after ready<KERNEL>'s
// opt-in); returns 0 or a cudaError_t.
template <auto KERNEL>
int active_clusters(int smem, int* clusters) {
  static std::mutex mu;
  static int count[MAX_DEVICES];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  std::lock_guard<std::mutex> lock(mu);
  if (count[dev] == 0) {
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(CLUSTER, 1, 1);
    config.blockDim = dim3(THREADS, 1, 1);
    config.dynamicSmemBytes = smem;
    err = cudaOccupancyMaxActiveClusters(&count[dev], KERNEL, &config);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (count[dev] == 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  *clusters = count[dev];
  return 0;
}

template <int NT>
int launch_streamed(const CUtensorMap& rows_map,
                    const CUtensorMap& queries_map, float* out, int n_buckets,
                    int n_valid, int k_chunks, const Plan& plan,
                    cudaStream_t stream) {
  int sms = 0, clusters = 0;
  int err = ready<bucket_scores_kernel_streamed<NT>>(&sms);
  if (err == 0)
    err = active_clusters<bucket_scores_kernel_streamed<NT>>(
        plan.smem_bytes, &clusters);
  if (err != 0) return err;
  const int tiles = (n_buckets + CLUSTER_BUCKETS - 1) / CLUSTER_BUCKETS;
  const int grid = CLUSTER * (tiles < clusters ? tiles : clusters);
  bucket_scores_kernel_streamed<NT><<<grid, THREADS, plan.smem_bytes,
                                      stream>>>(
      rows_map, queries_map, out, n_buckets, n_valid, k_chunks, plan.depth);
  return launched(stream, static_cast<int>(cudaGetLastError()));
}

}  // namespace

// The plan for d, b: {queries resident (0/1), ring stages (per consumer
// where resident; one ring both consumers share where streamed), stage
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
  // A TMA box is a bucket's rows and all queries where they are resident,
  // a block's 128 rows and its half of the queries where they stream.
  const int row_box = plan.resident ? BUCKET : CONSUMERS * BUCKET;
  const int query_box = plan.resident ? b : b / CLUSTER;
  CUtensorMap rows_map, queries_map;
  if (!encode(&rows_map, xs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, n, d,
              KCHUNK, row_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&queries_map, qs, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, b, d,
              KCHUNK, query_box, CU_TENSOR_MAP_SWIZZLE_128B))
    return -2;
  const int n_buckets = static_cast<int>(n / BUCKET);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k_chunks = d / KCHUNK;
  if (b == 256)
    return plan.resident
               ? launch<2, true>(rows_map, queries_map, o, n_buckets, n_valid,
                                 k_chunks, plan, s)
               : launch_streamed<2>(rows_map, queries_map, o, n_buckets,
                                    n_valid, k_chunks, plan, s);
  return plan.resident
             ? launch<1, true>(rows_map, queries_map, o, n_buckets, n_valid,
                               k_chunks, plan, s)
             : launch_streamed<1>(rows_map, queries_map, o, n_buckets,
                                  n_valid, k_chunks, plan, s);
}
