// The kernel sweeps' pipeline: ports of the Pallas kernels that
// benchmarks/onepass_sweep.py (kernel 4) and benchmarks/i8_sweep.py
// (kernel 5) swap into the fused coarse phase, as compile-time variants of
// kernels 1 and 2 (hopper.cuh's pipeline: persistent grid, TMA rings,
// wgmma, the bucket max in registers).  Each variant is one
// instantiation of sweep_kernel<NT, Variant>; each source
// (sweep_bucket_scores.cu, i8_sweep_*.cu) defines a few with
// HX_SWEEP_ENTRY, one extern "C" entry each, and they build into their own
// library (kernels.py: load_sweep), apart from the serving kernels.
//
// A variant is five choices:
//
// - Dot: Bf16 (kernel 1's rows and queries, f32 sums), S8 (kernel 2's:
//   int8 rows and queries, exact int32 sums), or S8AsBf16 (int8 rows
//   through kernel 2's ring, converted by the consumer warpgroup into a
//   bf16 staging tile in the 128-byte swizzle, then kernel 1's bf16
//   products against bf16 queries, f32 sums: exact, since |v| <= 127 is
//   a bf16 and |sum| <= 127 * 127 * 128 < 2^24 at D = 128);
// - Scale: None; Row (scales [N] f32: each thread multiplies its two
//   rows' scores, after the products, by scales it loads before them);
//   RowUnused (those loads, with no multiply: the reference's epilogue
//   probes bring the scale operand in and do not apply it); Bucket
//   (scales [N / 64] f32, applied to the winner, Reduce::I32Pack);
// - Mask, Reduce: hopper.cuh's epilogue choices (Mask::Fold is kernel 1's
//   bucket_epilogue itself);
// - Transposed: the output [B, buckets] instead of [buckets, B].
//
// The sweeps take resident queries only (B * D * bytes beside rings of
// at least four stages: every D <= 256 at B = 256); the ring depth is the
// caller's (2 up to the most that fit; 0 for the most), the knob that
// plays the TPU's VMEM tile's part.  The entry returns -3 for a shape it
// does not take.

#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "hopper.cuh"

namespace hx {

enum class Dot { Bf16, S8, S8AsBf16 };
enum class Scale { None, Row, RowUnused, Bucket };

template <Dot DOT_, Scale SCALE_, Mask MASK_, Reduce RED_,
          bool TRANSPOSED_ = false>
struct Variant {
  static constexpr Dot DOT = DOT_;
  static constexpr Scale SCALE = SCALE_;
  static constexpr Mask MASK = MASK_;
  static constexpr Reduce RED = RED_;
  static constexpr bool TRANSPOSED = TRANSPOSED_;
  static_assert(MASK != Mask::Fold ||
                    (RED == Reduce::Packed && SCALE == Scale::None),
                "the folded mask is kernel 1's epilogue as it stands");
  static_assert(DOT == Dot::S8 ||
                    (RED != Reduce::I32Pack && RED != Reduce::IntMax),
                "int-domain reductions need int32 sums");
};

__host__ __device__ constexpr int row_elem(Dot dot) {
  return dot == Dot::Bf16 ? 2 : 1;
}
__host__ __device__ constexpr int query_elem(Dot dot) {
  return dot == Dot::S8 ? 1 : 2;
}
// Per consumer: one int8 K-chunk (64 rows x 128 columns) as bf16.
constexpr int STAGING_BYTES = 2 * ROW_TILE_BYTES;
__host__ __device__ constexpr int staging_bytes(Dot dot) {
  return dot == Dot::S8AsBf16 ? CONSUMERS * STAGING_BYTES : 0;
}

// The plan of a sweep kernel: hopper.cuh's plan for its operands, then
// `depth` stages per consumer in place of the most that fit (0: the
// most).  False when the queries are not resident or the depth is not
// 2..the most.
inline bool sweep_plan(Dot dot, int d, int b, int depth, Plan* p) {
  const int extra = staging_bytes(dot);
  *p = make_plan(1LL * b * d * query_elem(dot), b, extra);
  if (!p->resident || p->depth < 2) return false;
  if (depth != 0) {
    if (depth < 2 || depth > p->depth) return false;
    p->depth = depth;
    p->smem_bytes = fixed_bytes(b) + extra + p->query_bytes +
                    CONSUMERS * depth * p->stage_bytes;
  }
  return true;
}

__device__ __forceinline__ uint32_t bf16x2(int lo, int hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(static_cast<float>(lo),
                                                 static_cast<float>(hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Four int8 values (one 32-bit word) as four bf16 values (two words).
__device__ __forceinline__ uint2 bytes_to_bf16(uint32_t w) {
  const int b0 = static_cast<int8_t>(w & 0xff);
  const int b1 = static_cast<int8_t>((w >> 8) & 0xff);
  const int b2 = static_cast<int8_t>((w >> 16) & 0xff);
  const int b3 = static_cast<int8_t>(w >> 24);
  return make_uint2(bf16x2(b0, b1), bf16x2(b2, b3));
}

// Convert the swizzled int8 stage `src` (64 rows x 128 bytes) into the
// bf16 staging tile `dst`: two 8 KB halves (columns 0-63, 64-127), each
// 64 rows x 128 bytes in the 128-byte swizzle.  Int8 16-byte chunk g of
// row r sits at chunk g ^ (r % 8); its 16 columns are bf16 chunks
// 2 (g % 4) and 2 (g % 4) + 1 of half g / 4, each at its index ^ (r % 8).
// The 128 threads of a consumer warpgroup take 4 chunks each.
__device__ __forceinline__ void convert_stage(const unsigned char* src,
                                              unsigned char* dst, int t) {
#pragma unroll
  for (int step = 0; step < 4; ++step) {
    const int i = t + 128 * step;
    const int r = i >> 3;
    const int g = i & 7;
    const uint4 v = *reinterpret_cast<const uint4*>(
        src + r * SWIZZLE_BYTES + ((g ^ (r & 7)) << 4));
    const uint2 a = bytes_to_bf16(v.x), b = bytes_to_bf16(v.y);
    const uint2 c = bytes_to_bf16(v.z), e = bytes_to_bf16(v.w);
    unsigned char* row = dst + (g >> 2) * ROW_TILE_BYTES + r * SWIZZLE_BYTES;
    const int lo = 2 * (g & 3);
    *reinterpret_cast<uint4*>(row + ((lo ^ (r & 7)) << 4)) =
        make_uint4(a.x, a.y, b.x, b.y);
    *reinterpret_cast<uint4*>(row + (((lo + 1) ^ (r & 7)) << 4)) =
        make_uint4(c.x, c.y, e.x, e.y);
  }
}

// The products of one bucket for Dot::S8AsBf16: per int8 K-chunk, wait for
// its stage, convert it into this consumer's staging tile, release the
// stage, make the generic-proxy stores visible to wgmma
// (fence.proxy.async) and wait for the warpgroup's other converters, then
// eight m64nBk16 bf16 products (two 64-column halves) against the bf16
// queries' boxes 2k and 2k + 1.  Before a later chunk overwrites the
// staging tile, every warp's products of the previous one must be done.
template <int NT>
__device__ __forceinline__ void converted_products(
    float (&acc)[NT * 64], uint32_t my_full, uint32_t my_empty,
    const unsigned char* my_ring, unsigned char* staging, uint32_t q_addr,
    uint32_t seq0, int k_chunks, int depth, int wg, int t) {
  constexpr int B = 128 * NT;
  const uint32_t st = smem_u32(staging);
  fence_acc(acc);
  for (int k = 0; k < k_chunks; ++k) {
    const uint32_t seq = seq0 + k;
    const uint32_t s = seq % depth;
    mbar_wait(my_full + 8 * s, (seq / depth) & 1);
    if (k > 0) {
      wgmma_wait<0>();
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    }
    convert_stage(my_ring + s * ROW_TILE_BYTES, staging, t);
    mbar_arrive(my_empty + 8 * s);
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
    wgmma_fence();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int kk = 0; kk < SWIZZLE_BYTES / 32; ++kk)
        wgmma_rows_queries<NT>(
            acc, sw128_desc(st + h * ROW_TILE_BYTES + kk * 32),
            sw128_desc(q_addr + (2 * k + h) * B * SWIZZLE_BYTES + kk * 32),
            k | h | kk);
    wgmma_commit();
  }
  wgmma_wait<0>();
  fence_acc(acc);
}

template <Dot DOT>
using Acc = std::conditional_t<DOT == Dot::S8, int, float>;

// NT = B / 128 query tiles; queries resident (sweep_plan).  Shared
// memory: [queries: q_bytes][each consumer's ring of `depth` 8 KB
// stages][S8AsBf16: each consumer's 16 KB staging tile][reduction
// buffers][mbarriers].
template <int NT, class V>
__global__ void __launch_bounds__(THREADS, 1)
    sweep_kernel(const __grid_constant__ CUtensorMap rows_map,
                 const __grid_constant__ CUtensorMap queries_map,
                 const float* __restrict__ scales, float* __restrict__ out,
                 int n_buckets, int n_valid, int k_chunks, int q_bytes,
                 int depth) {
  constexpr int B = 128 * NT;
  constexpr int ROW_COLS = SWIZZLE_BYTES / row_elem(V::DOT);
  constexpr int QUERY_COLS = SWIZZLE_BYTES / query_elem(V::DOT);
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  unsigned char* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t q_addr = smem_u32(base);
  const uint32_t ring = q_addr + q_bytes;
  const uint32_t staging = ring + CONSUMERS * depth * ROW_TILE_BYTES;
  float* red = reinterpret_cast<float*>(base + (staging - q_addr) +
                                        staging_bytes(V::DOT));
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
    // Producer: kernel 1's, with resident queries.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(PRODUCER_REGS));
    if (t != 0) return;
    mbar_expect_tx(q_bar, q_bytes);
    for (int box = 0; box < q_bytes / (B * SWIZZLE_BYTES); ++box)
      tma_load(q_addr + box * B * SWIZZLE_BYTES, &queries_map, q_bar,
               box * QUERY_COLS, 0);
    fill_rings<true>(&rows_map, &queries_map, ring, full, empty, n_buckets,
                     k_chunks, depth, ROW_TILE_BYTES, ROW_COLS);
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(CONSUMER_REGS));
  const uint32_t my_full = full + 8 * wg * MAX_DEPTH;
  const uint32_t my_empty = empty + 8 * wg * MAX_DEPTH;
  const uint32_t my_ring = ring + wg * depth * ROW_TILE_BYTES;
  const uint32_t r0 = (t / 32) * 16 + (t % 32) / 4;  // this thread's rows

  Acc<V::DOT> acc[NT * 64];
#pragma unroll
  for (int i = 0; i < NT * 64; ++i) acc[i] = 0;

  mbar_wait(q_bar, 0);
  int iter = 0;
  for (int bucket = blockIdx.x + wg * grid; bucket < n_buckets;
       bucket += CONSUMERS * grid, ++iter) {
    // Scales are loaded before the products, which hide their latency.
    float sc0 = 0.0f, sc1 = 0.0f, bucket_scale = 0.0f;
    if constexpr (V::SCALE == Scale::Row || V::SCALE == Scale::RowUnused) {
      sc0 = scales[bucket * BUCKET + r0];
      sc1 = scales[bucket * BUCKET + r0 + 8];
    }
    if constexpr (V::SCALE == Scale::Bucket) bucket_scale = scales[bucket];
    const uint32_t seq0 = static_cast<uint32_t>(iter) * k_chunks;
    if constexpr (V::DOT == Dot::Bf16) {
      bf16_products<NT, true>(acc, my_full, my_empty, my_ring, q_addr, seq0,
                              k_chunks, depth, ROW_TILE_BYTES);
    } else if constexpr (V::DOT == Dot::S8) {
      s8_products<NT, true>(acc, my_full, my_empty, my_ring, q_addr, seq0,
                            k_chunks, depth, ROW_TILE_BYTES);
    } else {
      converted_products<NT>(
          acc, my_full, my_empty, base + (my_ring - q_addr),
          base + (staging - q_addr) + wg * STAGING_BYTES, q_addr, seq0,
          k_chunks, depth, wg, t);
    }
    if constexpr (V::SCALE == Scale::RowUnused)
      asm volatile("" ::"f"(sc0), "f"(sc1));
    float* buf = red + (wg * 2 + (iter & 1)) * 4 * B;
    if constexpr (V::MASK == Mask::Fold) {
      bucket_epilogue<NT>(acc, buf, out + static_cast<long long>(bucket) * B,
                          bucket * BUCKET, n_valid, wg, t,
                          [](float v) { return v; });
    } else {
      sweep_epilogue<NT, V::MASK, V::RED, V::SCALE == Scale::Row,
                     V::TRANSPOSED>(acc, buf, out, bucket, n_buckets,
                                    n_valid, wg, t, sc0, sc1, bucket_scale);
    }
  }
}

template <int NT, class V>
int sweep_launch(const CUtensorMap& rows_map, const CUtensorMap& queries_map,
                 const float* scales, float* out, int n_buckets, int n_valid,
                 int k_chunks, const Plan& plan, cudaStream_t stream) {
  int sms = 0;
  const int err = ready<sweep_kernel<NT, V>>(&sms);
  if (err != 0) return err;
  const int grid = n_buckets < sms ? n_buckets : sms;
  sweep_kernel<NT, V><<<grid, THREADS, plan.smem_bytes, stream>>>(
      rows_map, queries_map, scales, out, n_buckets, n_valid, k_chunks,
      plan.query_bytes, plan.depth);
  return static_cast<int>(cudaGetLastError());
}

// xs [n, d] (bf16 for Dot::Bf16, else int8) row-major, qs [b, d] (int8
// for Dot::S8, else bf16) row-major, scales as the variant's Scale (or
// null), out [n / 64, b] f32 ([b, n / 64] when transposed), with n % 64
// == 0 and n < 2^31, d a multiple of 128 bytes of a row, b in {128, 256},
// and 16-byte aligned pointers (the Python wrappers check it).  Launches
// on `stream`; returns 0, a cudaError_t, -1 (no cuTensorMapEncodeTiled),
// -2 (a tensor map refused) or -3 (a shape not taken).
template <class V>
int sweep_entry(const void* xs, const void* qs, const void* scales,
                void* out, long long n, int d, int b, int n_valid, int depth,
                void* stream) {
  constexpr int ROW_COLS = SWIZZLE_BYTES / row_elem(V::DOT);
  if (n <= 0 || n % BUCKET || n >= (1LL << 31) || d <= 0 || d % ROW_COLS ||
      (b != 128 && b != 256) || (V::SCALE != Scale::None && !scales))
    return -3;
  Plan plan;
  if (!sweep_plan(V::DOT, d, b, depth, &plan)) return -3;
  if (!encode_tiled()) return -1;
  const auto type = [](int elem) {
    return elem == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_UINT8;
  };
  constexpr int RE = row_elem(V::DOT), QE = query_elem(V::DOT);
  CUtensorMap rows_map, queries_map;
  if (!encode(&rows_map, xs, type(RE), RE, n, d, SWIZZLE_BYTES / RE, BUCKET,
              CU_TENSOR_MAP_SWIZZLE_128B) ||
      !encode(&queries_map, qs, type(QE), QE, b, d, SWIZZLE_BYTES / QE, b,
              CU_TENSOR_MAP_SWIZZLE_128B))
    return -2;
  const int n_buckets = static_cast<int>(n / BUCKET);
  const float* sc = static_cast<const float*>(scales);
  float* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int k_chunks = d / ROW_COLS;
  return b == 256 ? sweep_launch<2, V>(rows_map, queries_map, sc, o,
                                       n_buckets, n_valid, k_chunks, plan, s)
                  : sweep_launch<1, V>(rows_map, queries_map, sc, o,
                                       n_buckets, n_valid, k_chunks, plan, s);
}

}  // namespace hx

// One extern "C" entry per variant: NAME(xs, qs, scales, out, n, d, b,
// n_valid, depth, stream), as hx::sweep_entry.
#define HX_SWEEP_ENTRY(NAME, ...)                                             \
  extern "C" int NAME(const void* xs, const void* qs, const void* scales,   \
                      void* out, long long n, int d, int b, int n_valid,    \
                      int depth, void* stream) {                            \
    return hx::sweep_entry<__VA_ARGS__>(xs, qs, scales, out, n, d, b,       \
                                        n_valid, depth, stream);            \
  }
