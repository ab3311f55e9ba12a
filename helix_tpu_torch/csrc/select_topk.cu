// Row-wise top-k selection: the k largest values of each row of a 2-D
// strided view, in descending order, ties to the lower column.
//
// Replaces the reference's device selections, which on the TPU are XLA
// ops, not Pallas kernels: jax.lax.approx_max_k (the TPU's partial-reduce
// top-k) and jax.lax.top_k, at helix_tpu/ops/fused_topk.py:244 and :262,
// helix_tpu/ops/quant.py:111, :165 and :654, helix_tpu/ops/quant4.py:172
// and :332, helix_tpu/ops/distance.py:88-135 and :179-227, the IVF and
// BM25 selections and helix_tpu/parallel/sharded.py:66-201.
//
// Order: lax.top_k's total order, which the reference's approx_max_k
// follows on the CPU too (ops/topk.py says where).  Each value maps to a
// 32-bit key whose unsigned order is that order (ops/topk.py:order_keys
// is the same map, signed, in PyTorch):
//
//   f32 bits b (bf16: b = bits << 16, exact):
//     key = b has the sign bit ? ~b : b | 0x80000000
//   so +NaN > +inf > ... > +0.0 > -0.0 > ... > -inf > -NaN;
//   int32 v: key = v ^ 0x80000000.
//
// Among equal keys the lower column wins, so the result is one order,
// bit for bit what ops/topk.py:select_topk_reference (a stable sort of
// the keys) returns: values in the input's dtype and bits, int64 columns.
// Any 1 <= k <= width < 2^31 is taken.
//
// What bounds it on an H100: bytes.  The row is read once and k values
// and ids are written once; the work per key is a few integer operations.
// At the main path's shapes: [256, 15,744] f32 (the fused step's winners)
// 16.1 MB, 4.9 us at 3.35 TB/s; [256, 1,000,448] f32 (the l2 exact rung's
// scores) 1.02 GB, 0.306 ms; [256, 156,288] (10M rows' buckets) 160 MB,
// 48 us.
//
// The design (simple first; helix_tpu_torch/ops/topk.py drives it).
// k <= MAX_K = 2048, every shape the fused, quantized and l2 paths give:
//
// - Pass 1: one block per (row, slice of at most SLICE = 16,384 columns).
//   The block loads the slice's keys into shared memory (64 KB, dynamic),
//   so the row is read from device memory once whatever follows.
// - An MSB radix select over those keys: four passes of 8 bits, each a
//   256-bin shared-memory histogram (a warp's equal digits merged with
//   __match_any_sync into one atomic) and one warp's scan from the top
//   bin, find the slice's kk-th key T (kk = min(k, slice width)) and how
//   many keys lie above it.  Keys whose higher digits left the running
//   prefix drop out of later passes.
// - An ordered compaction: each warp owns a contiguous run of columns,
//   counts its keys above T and equal to T with ballots, and a scan over
//   the warps gives each key its rank in column order.  Every key above T
//   is kept and, of the keys equal to T, the first kk - above by column:
//   this is where "ties to the lower column" is decided.
// - A bitonic sort of those kk (key, column) pairs, packed as one 64-bit
//   word (key << 32 | ~column, so a larger word is a larger key, then a
//   lower column), descending in shared memory, and the first kk written.
// - A row wider than one slice leaves kk candidates per slice in scratch
//   (keys and carried columns, slice-major, so equal keys stay in column
//   order); the same kernel runs again over those [rows, candidates]
//   until one slice is left, and the last pass writes values (read from
//   the input at the winning columns) and int64 ids.
// - The input may be any strided view: the fused step hands over the
//   transposed [buckets, B] output of kernels 1-3 as [B, buckets], which
//   a block reads one row at a time, one 4-byte value per 32-byte sector.
//   Those winners (16 MB at 1M rows) stay in the 50 MB L2 between the two
//   kernels; a layout that takes 8 adjacent queries per block (one sector
//   per bucket) is later work.
//
// k > MAX_K (the int4 pool past 2M rows, a traversal's frontier
// compaction) is the same select over the whole row, with its state in
// device memory instead of one block's shared memory:
//
// - Four radix passes, each a histogram kernel (one block per (row, chunk
//   of SLICE columns), shared bins added to the row's 256 global bins) and
//   a one-warp kernel per row that picks the digit, give the row's k-th
//   key T and how many keys equal to T belong to the top k.
// - Each chunk counts its keys above T and equal to T, a scan per row
//   over the chunks gives each chunk its bases, and the chunk's ordered
//   compaction (the block's, from those bases) writes exactly k packed
//   pairs in column order.
// - Blocks sort runs of RUN = 8,192 pairs bitonically in shared memory;
//   merge passes then double the sorted runs, each pair moving to its
//   rank in its own run plus the count of larger pairs in the partner run
//   (a binary search; pairs are distinct, so the rank is exact); a last
//   kernel writes values and ids.
// - The row is read six times (four histograms, the count, the
//   compaction): a single-read design is later work.

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SLICE = 16384;   // keys per block: 64 KB of shared memory
constexpr int MAX_K = 2048;    // the largest k of the one-block select
constexpr int RUN = 8192;      // pairs a block sorts for k > MAX_K: 64 KB
constexpr unsigned FULL = 0xffffffffu;

// The dtype codes of ops/topk.py:_DTYPE_CODES.
enum Dtype : int { F32 = 0, BF16 = 1, I32 = 2 };

struct Shared {
  uint32_t keys[SLICE];
  unsigned long long pairs[MAX_K];
  unsigned int hist[256];
  int warp_above[WARPS];
  int warp_equal[WARPS];
  uint32_t prefix;
  int rank;
};

__device__ __forceinline__ uint32_t float_key(uint32_t b) {
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// The input's element at offset `off` (in elements), as f32 or int32 bits.
__device__ __forceinline__ uint32_t load_bits(const void* x, int dtype,
                                              long long off) {
  if (dtype == BF16)
    return static_cast<uint32_t>(static_cast<const uint16_t*>(x)[off]) << 16;
  return static_cast<const uint32_t*>(x)[off];
}

__device__ __forceinline__ uint32_t load_key(const void* x, int dtype,
                                             long long off) {
  const uint32_t b = load_bits(x, dtype, off);
  return dtype == I32 ? (b ^ 0x80000000u) : float_key(b);
}

// A (key, column) pair as one word: a larger word is a larger key, then a
// lower column.  A real pair's low word is ~column > 0 (column < 2^31), so
// a zero word lies below every real pair.
__device__ __forceinline__ unsigned long long pack(uint32_t key,
                                                   long long col) {
  return (static_cast<unsigned long long>(key) << 32) |
         static_cast<uint32_t>(~static_cast<uint32_t>(col));
}

__device__ __forceinline__ long long column_of(unsigned long long pair) {
  return static_cast<int>(~static_cast<uint32_t>(pair));
}

// vals[o] and ids[o] from the input's element (row, col).
__device__ __forceinline__ void write_out(const void* x, int dtype,
                                          long long s0, long long s1,
                                          long long row, long long col,
                                          long long o, void* vals,
                                          long long* ids) {
  const long long src = row * s0 + col * s1;
  if (dtype == BF16)
    static_cast<uint16_t*>(vals)[o] = static_cast<const uint16_t*>(x)[src];
  else
    static_cast<uint32_t*>(vals)[o] = static_cast<const uint32_t*>(x)[src];
  ids[o] = col;
}

// Adds the digit at `shift` of each live key to the 256 bins `hist`
// (shared memory); every lane of the warp calls it.
__device__ __forceinline__ void add_digit(unsigned* hist, uint32_t key,
                                          bool live, int shift) {
  const unsigned live_mask = __ballot_sync(FULL, live);
  if (live) {
    const uint32_t digit = (key >> shift) & 255u;
    const unsigned peers = __match_any_sync(live_mask, digit);
    if ((threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(&hist[digit], static_cast<unsigned>(__popc(peers)));
  }
}

// One warp: the bin of `hist` (digit counts at `shift`) that holds the
// rank-th largest live key.  Adds the digit to *prefix and leaves in
// *rank the rank within that bin, on every lane.  Reads the bins before
// any lane returns.
__device__ __forceinline__ void pick_digit(const unsigned* hist, int shift,
                                           uint32_t* prefix, int* rank) {
  const int lane = threadIdx.x & 31;
  // Lane l holds bins 255 - 8l down to 248 - 8l: lanes in order are bins
  // from the top.
  int c[8];
  int sum = 0;
  for (int j = 0; j < 8; ++j) {
    c[j] = static_cast<int>(hist[255 - 8 * lane - j]);
    sum += c[j];
  }
  int incl = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += up;
  }
  int before = incl - sum;
  const int want = *rank;
  const bool mine = before < want && want <= incl;
  uint32_t digit = 0;
  int left = 0;
  if (mine) {
    for (int j = 0; j < 8; ++j) {
      if (before + c[j] >= want) {
        digit = static_cast<uint32_t>(255 - 8 * lane - j);
        left = want - before;
        break;
      }
      before += c[j];
    }
  }
  const int src = __ffs(__ballot_sync(FULL, mine)) - 1;
  *prefix |= __shfl_sync(FULL, digit, src) << shift;
  *rank = __shfl_sync(FULL, left, src);
}

// The block's ordered compaction of keys[0, n) (shared memory) around the
// k-th key T: every key above T to slot above_base + its rank among them
// in column order, and a key equal to T whose rank r among those (from
// equal_base) is below need_equal to slot above_total + r, through
// emit(i, slot).  take_all keeps every key, in order.  above_total < 0
// means the block holds every key of the selection: its own count above.
template <typename Emit>
__device__ __forceinline__ void compact(const uint32_t* keys, int n,
                                        bool take_all, uint32_t T,
                                        long long need_equal,
                                        long long above_base,
                                        long long equal_base,
                                        long long above_total,
                                        int* warp_above, int* warp_equal,
                                        Emit emit) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // warp w owns columns [lo, hi)
  const int run = ((n + WARPS - 1) / WARPS + 31) & ~31;
  const int lo = min(n, warp * run);
  const int hi = min(n, lo + run);
  int above = 0, equal = 0;
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    const uint32_t key = i < hi ? keys[i] : 0u;
    above += __popc(__ballot_sync(FULL, i < hi && (take_all || key > T)));
    equal += __popc(__ballot_sync(FULL, i < hi && !take_all && key == T));
  }
  if (lane == 0) {
    warp_above[warp] = above;
    warp_equal[warp] = equal;
  }
  __syncthreads();
  long long block_above = 0;
  for (int w = 0; w < WARPS; ++w) {
    block_above += warp_above[w];
    if (w < warp) {
      above_base += warp_above[w];
      equal_base += warp_equal[w];
    }
  }
  if (above_total < 0) above_total = block_above;
  const unsigned lower = (1u << lane) - 1u;
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    const uint32_t key = i < hi ? keys[i] : 0u;
    const bool is_above = i < hi && (take_all || key > T);
    const bool is_equal = i < hi && !take_all && key == T;
    const unsigned a = __ballot_sync(FULL, is_above);
    const unsigned e = __ballot_sync(FULL, is_equal);
    if (is_above) {
      emit(i, above_base + __popc(a & lower));
    } else if (is_equal) {
      const long long r = equal_base + __popc(e & lower);
      if (r < need_equal) emit(i, above_total + r);
    }
    above_base += __popc(a);
    equal_base += __popc(e);
  }
}

// Sorts a[0, p) descending (p a power of two) with the block's threads.
__device__ __forceinline__ void bitonic_desc(unsigned long long* a, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (p >> 1); i += THREADS) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool descending = (lo & size) == 0;
        const unsigned long long va = a[lo], vb = a[hi];
        if ((va < vb) == descending) {
          a[lo] = vb;
          a[hi] = va;
        }
      }
      __syncthreads();
    }
  }
}

// One pass over `width` columns of each row.  The first pass reads the
// input x (in_keys == nullptr: keys computed, the column is the index);
// a later one reads the keys and carried columns an earlier pass left.
// A pass of more than one slice writes kk candidates per slice to
// out_keys / out_cols (out_width per row); the last (one slice) writes
// vals and ids, [rows, k] contiguous.
__global__ void __launch_bounds__(THREADS, 2)
select_pass(const void* x, int dtype, long long s0, long long s1,
            const uint32_t* in_keys, const int* in_cols, long long width,
            int k, int slices, uint32_t* out_keys, int* out_cols,
            long long out_width, void* vals, long long* ids) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Shared& sh = *reinterpret_cast<Shared*>(smem_raw);
  const int t = threadIdx.x;
  const long long row = blockIdx.x / slices;
  const int slice = static_cast<int>(blockIdx.x % slices);
  const long long c0 = static_cast<long long>(slice) * SLICE;
  const int n = static_cast<int>(min(static_cast<long long>(SLICE),
                                     width - c0));
  const int kk = min(k, n);
  const bool take_all = n <= k;

  // Load the slice's keys.
  if (in_keys == nullptr) {
    const long long base = row * s0;
    for (int i = t; i < n; i += THREADS)
      sh.keys[i] = load_key(x, dtype, base + (c0 + i) * s1);
  } else {
    const uint32_t* src = in_keys + row * width + c0;
    for (int i = t; i < n; i += THREADS) sh.keys[i] = src[i];
  }

  // Radix select: the kk-th largest key T, four digits of 8 bits from the
  // top.  Afterwards sh.prefix = T and sh.rank = how many keys equal to T
  // belong to the top kk.
  if (t == 0) {
    sh.prefix = 0;
    sh.rank = kk;
  }
  __syncthreads();
  if (!take_all) {
    for (int shift = 24; shift >= 0; shift -= 8) {
      if (t < 256) sh.hist[t] = 0;
      __syncthreads();
      const uint32_t prefix = sh.prefix;
      const uint32_t high = shift == 24 ? 0u : (FULL << (shift + 8));
      for (int i0 = 0; i0 < n; i0 += THREADS) {
        const int i = i0 + t;
        const uint32_t key = i < n ? sh.keys[i] : 0u;
        add_digit(sh.hist, key, i < n && (key & high) == prefix, shift);
      }
      __syncthreads();
      if (t < 32) {
        uint32_t p = prefix;
        int rank = sh.rank;
        pick_digit(sh.hist, shift, &p, &rank);
        if (t == 0) {
          sh.prefix = p;
          sh.rank = rank;
        }
      }
      __syncthreads();
    }
  }
  compact(sh.keys, n, take_all, sh.prefix, sh.rank, 0, 0, -1,
          sh.warp_above, sh.warp_equal, [&](int i, long long slot) {
            const long long col = in_cols == nullptr
                                      ? c0 + i
                                      : in_cols[row * width + c0 + i];
            sh.pairs[slot] = pack(sh.keys[i], col);
          });

  // Bitonic sort of the kk pairs, padded with zeros to a power of two.
  int p = 1;
  while (p < kk) p <<= 1;
  for (int i = kk + t; i < p; i += THREADS) sh.pairs[i] = 0ull;
  __syncthreads();
  bitonic_desc(sh.pairs, p);

  // Write the slice's kk, in order.
  for (int j = t; j < kk; j += THREADS) {
    const unsigned long long pair = sh.pairs[j];
    if (vals == nullptr) {
      const long long o =
          row * out_width + static_cast<long long>(slice) * k + j;
      out_keys[o] = static_cast<uint32_t>(pair >> 32);
      out_cols[o] = static_cast<int>(column_of(pair));
    } else {
      write_out(x, dtype, s0, s1, row, column_of(pair), row * k + j, vals,
                ids);
    }
  }
}

// ---- k > MAX_K: the select over the whole row, its state in device
// memory.  state holds 4 ints per row: the running prefix (T at the end),
// the rank left within it (the keys equal to T that belong to the top k),
// the count of keys above T, and one unused.

// Block b of the chunked kernels below takes row b % rows and chunk
// b / rows: blocks that run together read the same columns of adjacent
// rows, so a transposed view's 32-byte sectors are shared in L2.

// One radix pass's histogram: block (row, chunk) adds the digits at
// `shift` of its chunk's live keys to the row's 256 bins.
__global__ void __launch_bounds__(THREADS)
wide_hist(const void* x, int dtype, long long s0, long long s1,
          long long rows, long long width, int shift, const int* state,
          unsigned* hist) {
  __shared__ unsigned bins[256];
  const int t = threadIdx.x;
  const long long row = blockIdx.x % rows;
  const long long chunk = blockIdx.x / rows;
  const long long c0 = chunk * SLICE;
  const int n = static_cast<int>(min(static_cast<long long>(SLICE),
                                     width - c0));
  if (t < 256) bins[t] = 0;
  __syncthreads();
  // the state is zero before the first pass, whose `high` is 0
  const uint32_t prefix = static_cast<uint32_t>(state[row * 4]);
  const uint32_t high = shift == 24 ? 0u : (FULL << (shift + 8));
  const long long base = row * s0;
  for (int i0 = 0; i0 < n; i0 += THREADS) {
    const int i = i0 + t;
    const uint32_t key = i < n ? load_key(x, dtype, base + (c0 + i) * s1)
                               : 0u;
    add_digit(bins, key, i < n && (key & high) == prefix, shift);
  }
  __syncthreads();
  if (t < 256 && bins[t] != 0) atomicAdd(&hist[row * 256 + t], bins[t]);
}

// One warp per row: pick the digit at `shift`, then zero the row's bins
// for the next pass.
__global__ void __launch_bounds__(32)
wide_pick(int k, int shift, int* state, unsigned* hist) {
  const long long row = blockIdx.x;
  unsigned* bins = hist + row * 256;
  uint32_t prefix = shift == 24 ? 0u : static_cast<uint32_t>(state[row * 4]);
  int rank = shift == 24 ? k : state[row * 4 + 1];
  pick_digit(bins, shift, &prefix, &rank);
  for (int j = threadIdx.x; j < 256; j += 32) bins[j] = 0;
  if (threadIdx.x == 0) {
    state[row * 4] = static_cast<int>(prefix);
    state[row * 4 + 1] = rank;
  }
}

// Block (row, chunk) counts its keys above T and equal to T, packed as
// above << 32 | equal.
__global__ void __launch_bounds__(THREADS)
wide_count(const void* x, int dtype, long long s0, long long s1,
           long long rows, long long width, int chunks, const int* state,
           unsigned long long* counts) {
  __shared__ unsigned long long total;
  const int t = threadIdx.x;
  const long long row = blockIdx.x % rows;
  const long long chunk = blockIdx.x / rows;
  const long long c0 = chunk * SLICE;
  const int n = static_cast<int>(min(static_cast<long long>(SLICE),
                                     width - c0));
  if (t == 0) total = 0;
  __syncthreads();
  const uint32_t T = static_cast<uint32_t>(state[row * 4]);
  const long long base = row * s0;
  unsigned long long mine = 0;
  for (int i = t; i < n; i += THREADS) {
    const uint32_t key = load_key(x, dtype, base + (c0 + i) * s1);
    mine += key > T ? (1ull << 32) : (key == T ? 1ull : 0ull);
  }
  for (int d = 16; d > 0; d >>= 1) mine += __shfl_down_sync(FULL, mine, d);
  if ((t & 31) == 0) atomicAdd(&total, mine);
  __syncthreads();
  if (t == 0) counts[row * chunks + chunk] = total;
}

// One block per row: the chunks' counts become exclusive bases (in
// place, in column order), and the row's count above T goes to state.
__global__ void __launch_bounds__(THREADS)
wide_bases(int chunks, int* state, unsigned long long* counts) {
  __shared__ unsigned long long warp_sums[WARPS];
  __shared__ unsigned long long carry;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const long long row = blockIdx.x;
  unsigned long long* c = counts + row * chunks;
  if (t == 0) carry = 0;
  __syncthreads();
  for (int j0 = 0; j0 < chunks; j0 += THREADS) {
    const int j = j0 + t;
    const unsigned long long v = j < chunks ? c[j] : 0ull;
    unsigned long long incl = v;
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned long long up = __shfl_up_sync(FULL, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    unsigned long long before = carry;
    for (int w = 0; w < warp; ++w) before += warp_sums[w];
    if (j < chunks) c[j] = before + incl - v;
    __syncthreads();
    if (t == THREADS - 1) carry = before + incl;
    __syncthreads();
  }
  if (t == 0) state[row * 4 + 2] = static_cast<int>(carry >> 32);
}

// Block (row, chunk): the chunk's ordered compaction from its bases,
// packed pairs to pairs[row * k + slot].
__global__ void __launch_bounds__(THREADS, 2)
wide_compact(const void* x, int dtype, long long s0, long long s1,
             long long rows, long long width, int chunks, int k,
             const int* state, const unsigned long long* counts,
             unsigned long long* pairs) {
  // all dynamic (hx::ready opts in the whole limit): the keys, then the
  // warps' counts
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* keys = reinterpret_cast<uint32_t*>(smem_raw);
  int* warp_above = reinterpret_cast<int*>(keys + SLICE);
  int* warp_equal = warp_above + WARPS;
  const int t = threadIdx.x;
  const long long row = blockIdx.x % rows;
  const long long chunk = blockIdx.x / rows;
  const long long c0 = chunk * SLICE;
  const int n = static_cast<int>(min(static_cast<long long>(SLICE),
                                     width - c0));
  const long long base = row * s0;
  for (int i = t; i < n; i += THREADS)
    keys[i] = load_key(x, dtype, base + (c0 + i) * s1);
  __syncthreads();
  const unsigned long long bases = counts[row * chunks + chunk];
  unsigned long long* out = pairs + row * k;
  compact(keys, n, false, static_cast<uint32_t>(state[row * 4]),
          state[row * 4 + 1], static_cast<long long>(bases >> 32),
          static_cast<long long>(bases & FULL), state[row * 4 + 2],
          warp_above, warp_equal, [&](int i, long long slot) {
            out[slot] = pack(keys[i], c0 + i);
          });
}

// Block (row, run): sorts its run of at most RUN pairs, descending.
__global__ void __launch_bounds__(THREADS, 2)
wide_sort_runs(int k, int runs, unsigned long long* pairs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned long long* a = reinterpret_cast<unsigned long long*>(smem_raw);
  const long long row = blockIdx.x / runs;
  const long long r0 = static_cast<long long>(blockIdx.x % runs) * RUN;
  const int n = static_cast<int>(min(static_cast<long long>(RUN), k - r0));
  unsigned long long* src = pairs + row * k + r0;
  int p = 1;
  while (p < n) p <<= 1;
  for (int i = threadIdx.x; i < p; i += THREADS) a[i] = i < n ? src[i] : 0ull;
  __syncthreads();
  bitonic_desc(a, p);
  for (int i = threadIdx.x; i < n; i += THREADS) src[i] = a[i];
}

// One merge pass: sorted runs of `len` pairs, merged two by two.  A pair
// moves to its place in its own run plus the count of larger pairs in
// the partner run.
__global__ void __launch_bounds__(THREADS)
wide_merge(int k, int blocks_per_row, long long len,
           const unsigned long long* in, unsigned long long* out) {
  const long long row = blockIdx.x / blocks_per_row;
  const long long i =
      static_cast<long long>(blockIdx.x % blocks_per_row) * THREADS +
      threadIdx.x;
  if (i >= k) return;
  const unsigned long long* src = in + row * k;
  const unsigned long long v = src[i];
  const long long run = i / len;
  const long long lo = (run ^ 1) * len;
  long long dest = i;
  if (lo < k) {
    long long a = lo, b = min(lo + len, static_cast<long long>(k));
    while (a < b) {
      const long long mid = (a + b) >> 1;
      if (src[mid] > v) a = mid + 1;
      else b = mid;
    }
    dest = min(run, run ^ 1) * len + (i - run * len) + (a - lo);
  }
  out[row * k + dest] = v;
}

__global__ void __launch_bounds__(THREADS)
wide_write(const void* x, int dtype, long long s0, long long s1, int k,
           int blocks_per_row, const unsigned long long* pairs, void* vals,
           long long* ids) {
  const long long row = blockIdx.x / blocks_per_row;
  const long long j =
      static_cast<long long>(blockIdx.x % blocks_per_row) * THREADS +
      threadIdx.x;
  if (j >= k) return;
  write_out(x, dtype, s0, s1, row, column_of(pairs[row * k + j]),
            row * k + j, vals, ids);
}

long long ceil_div(long long a, long long b) { return (a + b - 1) / b; }

// Candidates per row after a pass over `width` columns: k per slice, the
// last slice's min(k, its width).
long long candidates(long long width, int k) {
  const long long s = ceil_div(width, SLICE);
  return (s - 1) * k + std::min<long long>(k, width - (s - 1) * SLICE);
}

// The scratch (bytes) a selection of k of `width` columns over `rows`
// rows needs; -3 when the shape is not taken.  ops/topk.py:scratch_bytes
// is the same count.
//   k <= MAX_K: the keys, then the columns, of the candidates of the
//     first two passes (later passes alternate between those regions);
//   k > MAX_K: two regions of rows * k pairs, the chunks' packed counts
//     (8 bytes each), 256 bins and 4 ints of state per row.
long long scratch_of(long long rows, long long width, int k) {
  if (rows < 1 || k < 1 || width < k || width >= (1LL << 31)) return -3;
  if (k > MAX_K)
    return rows * (16LL * k + 8LL * ceil_div(width, SLICE) + 4LL * 260);
  long long need = 0, w = width;
  for (int pass = 0; ceil_div(w, SLICE) > 1; ++pass) {
    w = candidates(w, k);
    if (pass < 2) need += w;
  }
  return 8 * rows * need;
}

int select_narrow(const void* x, int dtype, long long rows, long long width,
                  long long s0, long long s1, int k, void* vals,
                  long long* ids, void* scratch, long long scratch_bytes,
                  cudaStream_t s) {
  const size_t smem = sizeof(Shared);
  uint32_t* keys[2] = {static_cast<uint32_t*>(scratch), nullptr};
  const long long first = scratch_bytes > 0 ? candidates(width, k) : 0;
  keys[1] = keys[0] + rows * first;
  int* cols[2] = {reinterpret_cast<int*>(keys[0]) + scratch_bytes / 8,
                  nullptr};
  cols[1] = cols[0] + rows * first;
  const uint32_t* in_keys = nullptr;
  const int* in_cols = nullptr;
  long long w = width;
  for (int pass = 0;; ++pass) {
    const long long slices = ceil_div(w, SLICE);
    if (rows * slices >= (1LL << 31)) return -3;
    const dim3 grid(static_cast<unsigned>(rows * slices));
    if (slices == 1) {
      select_pass<<<grid, THREADS, smem, s>>>(
          x, dtype, s0, s1, in_keys, in_cols, w, k, 1, nullptr,
          nullptr, 0, vals, ids);
      return static_cast<int>(cudaGetLastError());
    }
    const long long out_w = candidates(w, k);
    uint32_t* ok = keys[pass & 1];
    int* oc = cols[pass & 1];
    select_pass<<<grid, THREADS, smem, s>>>(
        x, dtype, s0, s1, in_keys, in_cols, w, k,
        static_cast<int>(slices), ok, oc, out_w, nullptr, nullptr);
    const cudaError_t launched = cudaGetLastError();
    if (launched != cudaSuccess) return static_cast<int>(launched);
    in_keys = ok;
    in_cols = oc;
    w = out_w;
  }
}

int select_wide(const void* x, int dtype, long long rows, long long width,
                long long s0, long long s1, int k, void* vals,
                long long* ids, void* scratch, cudaStream_t s) {
  const long long chunks = ceil_div(width, SLICE);
  const long long runs = ceil_div(k, RUN);
  const long long per_row = ceil_div(k, THREADS);
  if (rows * chunks >= (1LL << 31) || rows * per_row >= (1LL << 31))
    return -3;
  unsigned long long* pairs[2] = {
      static_cast<unsigned long long*>(scratch),
      static_cast<unsigned long long*>(scratch) + rows * k};
  unsigned long long* counts = pairs[1] + rows * k;
  unsigned* hist = reinterpret_cast<unsigned*>(counts + rows * chunks);
  int* state = reinterpret_cast<int*>(hist + rows * 256);
  // the bins and the state, adjacent, start at zero
  cudaError_t err = cudaMemsetAsync(hist, 0, rows * 260 * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned by_chunk = static_cast<unsigned>(rows * chunks);
  const unsigned by_k = static_cast<unsigned>(rows * per_row);
  const int c = static_cast<int>(chunks);
  for (int shift = 24; shift >= 0; shift -= 8) {
    wide_hist<<<by_chunk, THREADS, 0, s>>>(x, dtype, s0, s1, rows, width,
                                           shift, state, hist);
    wide_pick<<<static_cast<unsigned>(rows), 32, 0, s>>>(k, shift, state,
                                                         hist);
  }
  wide_count<<<by_chunk, THREADS, 0, s>>>(x, dtype, s0, s1, rows, width,
                                          c, state, counts);
  wide_bases<<<static_cast<unsigned>(rows), THREADS, 0, s>>>(c, state,
                                                             counts);
  wide_compact<<<by_chunk, THREADS, (SLICE + 2 * WARPS) * sizeof(int), s>>>(
      x, dtype, s0, s1, rows, width, c, k, state, counts, pairs[0]);
  wide_sort_runs<<<static_cast<unsigned>(rows * runs), THREADS,
                   RUN * sizeof(unsigned long long), s>>>(
      k, static_cast<int>(runs), pairs[0]);
  int cur = 0;
  for (long long len = RUN; len < k; len <<= 1) {
    wide_merge<<<by_k, THREADS, 0, s>>>(k, static_cast<int>(per_row), len,
                                        pairs[cur], pairs[cur ^ 1]);
    cur ^= 1;
  }
  wide_write<<<by_k, THREADS, 0, s>>>(x, dtype, s0, s1, k,
                                      static_cast<int>(per_row), pairs[cur],
                                      vals, ids);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: a [rows, width] view with element strides s0, s1 of dtype F32, BF16
// or I32; vals [rows, k] (x's dtype) and ids [rows, k] int64 contiguous;
// scratch holds scratch_of(rows, width, k) bytes (null when that is 0).
// Launches on `stream`; returns 0, a cudaError_t, or -3 when the shape is
// not taken.
extern "C" int hx_select_topk(const void* x, int dtype, long long rows,
                              long long width, long long s0,
                              long long s1, int k, void* vals, long long* ids,
                              void* scratch, long long scratch_bytes,
                              void* stream) {
  if (dtype != F32 && dtype != BF16 && dtype != I32) return -3;
  if (scratch_of(rows, width, k) != scratch_bytes) return -3;
  if (scratch_bytes > 0 && scratch == nullptr) return -3;
  // every kernel's shared-memory opt-in, on the first call of either path
  int sms = 0;
  int err = hx::ready<select_pass>(&sms);
  if (err == 0) err = hx::ready<wide_compact>(&sms);
  if (err == 0) err = hx::ready<wide_sort_runs>(&sms);
  if (err != 0) return err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k > MAX_K)
    return select_wide(x, dtype, rows, width, s0, s1, k, vals, ids, scratch,
                       s);
  return select_narrow(x, dtype, rows, width, s0, s1, k, vals, ids, scratch,
                       scratch_bytes, s);
}
