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
// Each (key, column) becomes one 64-bit word, key << 32 | ~column: a
// larger word is a larger key, then a lower column, and no two words of a
// row are equal.  So the top k of a row are its k largest words, one
// order with no ties left, bit for bit what ops/topk.py:
// select_topk_reference (a stable sort of the keys) returns: values in the
// input's dtype and bits (the key maps back to them), int64 columns.  Any
// 1 <= k <= width < 2^31 is taken.
//
// What bounds it on an H100: bytes.  The row is read once and k values
// and ids are written once; the work per key is a few integer operations.
// At the main path's shapes: [256, 15,744] f32 (the fused step's winners)
// 16.1 MB, 4.9 us at 3.35 TB/s; [256, 1,000,448] f32 (the l2 exact rung's
// scores) 1.02 GB, 0.306 ms; [256, 1,007,616] bf16 (the cosine single
// shot) 0.52 GB, 0.154 ms; [256, 156,288] (10M rows' buckets) 160 MB,
// 57 us at k = 9,765.
//
// The design.  plan_of picks one of three paths from the shape alone
// (ops/topk.py:plan is the same planner, pinned by the CPU tests and held
// to this one on the card):
//
// - Warp path, width <= WARP_MAX = 512 (the re-rank's [256, 128] -> 16,
//   the mesh's merges, IVF probes): one warp per row, four rows a block.
//   Each lane holds R <= 16 words in registers and the warp sorts all 32R
//   with a bitonic network (exchanges inside a lane below R, shuffles
//   above; every index a template constant, so nothing spills), then
//   writes the first k.  No shared memory and no barrier: a 128-column
//   row no longer holds a 512-thread block through radix passes.
// - Block path, k <= BLOCK_K_MAX = 14,336 (the fused tail, the l2 and bf16
//   scores, the 10M int4 pool): a filter with a running threshold tau,
//   the row read once.  A block of 512 threads takes a chunk of one row
//   in tiles of BV = 4 keys a thread.
//   - The loads: cp.async copies into a ring of 6 tiles in shared memory,
//     5 tiles ahead, so the loads hold no register (a register prefetch
//     capped the bytes in flight and spilled); a contiguous aligned row
//     copies a thread's 4 keys in one 16-byte copy (8 for bf16), fewer and
//     larger requests.  Each thread reads back only what it copied, so
//     the ring needs no barrier.
//   - The filter: each word at or above tau (0 at first) is appended to
//     the row's buffer in shared memory (a ballot and one shared atomic
//     per warp); past the first compaction most keys fail one compare and
//     cost no atomic.  One barrier a tile: __syncthreads_or tells every
//     thread whether the next tile might overflow the buffer, from the
//     count the appending lanes saw.  Ties need no ordered compaction:
//     the column is in the word.
//   - The first tile seeds tau: each thread's largest word (or two) go in
//     first and their need-th largest, a subset's and so at or below the
//     chunk's, becomes tau before the rest of the tile is filtered, so
//     the first compaction sorts 512 words, not a full buffer.
//   - A compaction keeps the buffer's need largest words (need = min(k,
//     the chunk's width)).  Up to 256: 256-word chunks sorted in
//     registers, one warp each, and merged two by two keeping the larger
//     256 (compact_top; it also leaves them sorted for the output).  Past
//     256: an MSB radix select of 8 bits a pass over the buffer, stopping
//     when the picked bin is taken whole, then the words >= the need-th
//     (compact_rows); there each tile's survivors are counted first, so
//     the buffer is compacted only when they would not fit.
//   - At the end a chunk that is a whole row sorts its k words (past 256
//     a bitonic sort whose strides below 256 run in registers) and writes
//     values and ids; otherwise each chunk writes its need words to
//     scratch, padded with zeros to k, and the same kernel runs again over
//     those [rows, chunks * k] words (chunks of at least 16k columns, so
//     each pass shrinks the row sixteen-fold) until one chunk per row is
//     left.  Chunks are sized so that about 4 x 132 blocks run: two
//     launches at the l2 and bf16 shapes, one at the fused tail.
//   - Transposed views (kernels 1-3's [buckets, B] winners read as [B,
//     buckets]) take the same path: blocks that run together read the
//     same chunk of adjacent rows, so their 32-byte sectors meet in L2.
//     A block of 8 adjacent rows (one sector per column) was tried on the
//     card: its 8 buffers' compactions and the second launch it needed
//     cost more than the sectors saved at the fused tail.
// - Wide path, k > BLOCK_K_MAX (a traversal's frontier compaction: one
//   block's buffer cannot hold k words): the same select over the whole
//   row, with its state in device memory instead of one block's shared
//   memory:
//   - Four radix passes, each a histogram kernel (one block per (row,
//     chunk of SLICE columns), shared bins added to the row's 256 global
//     bins) and a one-warp kernel per row that picks the digit, give the
//     row's k-th key T and how many keys equal to T belong to the top k.
//   - Each chunk counts its keys above T and equal to T, a scan per row
//     over the chunks gives each chunk its bases, and the chunk's ordered
//     compaction (the block's, from those bases) writes exactly k packed
//     pairs in column order.
//   - Blocks sort runs of RUN = 8,192 pairs bitonically in shared memory;
//     merge passes then double the sorted runs, each pair moving to its
//     rank in its own run plus the count of larger pairs in the partner
//     run (a binary search; pairs are distinct, so the rank is exact); a
//     last kernel writes values and ids.  It reads the row six times.

#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int SLICE = 16384;   // the wide path's columns per block
constexpr int RUN = 8192;      // pairs a block sorts on the wide path: 64 KB
constexpr unsigned FULL = 0xffffffffu;

constexpr int WARP_MAX = 512;       // the warp path's widest row
constexpr int WARP_ROWS = 4;        // rows (warps) per block of the warp path
constexpr int BV = 4;               // keys a thread loads per tile
constexpr int MAX_CAP = 16384;      // words of one block's buffers: 128 KB
constexpr int BLOCK_K_MAX = MAX_CAP - THREADS * BV;  // 14,336
constexpr int SMS = 132;            // an H100 SXM's SMs: the planner's target
constexpr int MAX_STAGES = 12;

// The dtype codes of ops/topk.py:_DTYPE_CODES.
enum Dtype : int { F32 = 0, BF16 = 1, I32 = 2 };
// The paths of plan_of (ops/topk.py:PATHS).
enum Path : int { WARP = 0, BLOCK = 1, WIDE = 2 };

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

// Adds one to bin `bin` of `hist` (shared memory) for each live lane, a
// warp's equal bins merged into one atomic; every lane of the warp calls
// it.
__device__ __forceinline__ void add_bin(unsigned* hist, int bin, bool live) {
  const unsigned live_mask = __ballot_sync(FULL, live);
  if (live) {
    const unsigned peers = __match_any_sync(live_mask, bin);
    if ((threadIdx.x & 31) == __ffs(peers) - 1)
      atomicAdd(&hist[bin], static_cast<unsigned>(__popc(peers)));
  }
}

// Adds the digit at `shift` of each live key to the 256 bins `hist`
// (shared memory); every lane of the warp calls it.
__device__ __forceinline__ void add_digit(unsigned* hist, uint32_t key,
                                          bool live, int shift) {
  add_bin(hist, static_cast<int>((key >> shift) & 255u), live);
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

// The input's bits of a key: the key map turned back.
__device__ __forceinline__ uint32_t key_bits(uint32_t key, int dtype) {
  if (dtype == I32) return key ^ 0x80000000u;
  return (key & 0x80000000u) ? (key & 0x7fffffffu) : ~key;
}

// vals[o] and ids[o] from a word: the value from its key, bit for bit.
__device__ __forceinline__ void write_word(int dtype, long long o,
                                           unsigned long long word,
                                           void* vals, long long* ids) {
  const uint32_t b = key_bits(static_cast<uint32_t>(word >> 32), dtype);
  if (dtype == BF16)
    static_cast<uint16_t*>(vals)[o] = static_cast<uint16_t>(b >> 16);
  else
    static_cast<uint32_t*>(vals)[o] = b;
  ids[o] = column_of(word);
}

// ---- the warp path: one warp per row, the row's words in registers.

// One bitonic step over a warp's 32R words in registers, slot s = lane * R
// + i standing for element gbase + s of a larger sequence: the pair (s,
// s ^ STRIDE) is put in order, descending where (gbase + s) & size is 0.
// Every index is a constant once unrolled, so v stays in registers.
template <int R, int STRIDE>
__device__ __forceinline__ void warp_step(unsigned long long (&v)[R],
                                          int gbase, int size) {
  const int lane = threadIdx.x & 31;
  if constexpr (STRIDE < R) {  // the partner is in this lane's registers
#pragma unroll
    for (int i = 0; i < R; ++i) {
      if ((i ^ STRIDE) > i) {
        const bool descending = ((gbase + lane * R + i) & size) == 0;
        const unsigned long long a = v[i], b = v[i ^ STRIDE];
        if ((a < b) == descending) {
          v[i] = b;
          v[i ^ STRIDE] = a;
        }
      }
    }
  } else {  // in lane ^ (STRIDE / R), at the same register
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int s = lane * R + i;
      const unsigned long long other =
          __shfl_xor_sync(FULL, v[i], STRIDE / R);
      const bool keep_larger =
          ((s & STRIDE) == 0) == (((gbase + s) & size) == 0);
      const bool larger = v[i] > other;
      v[i] = keep_larger == larger ? v[i] : other;
    }
  }
}

// The steps of strides STRIDE, STRIDE / 2, ..., 1 at one merge size.
template <int R, int STRIDE>
__device__ __forceinline__ void warp_merge(unsigned long long (&v)[R],
                                           int gbase, int size) {
  warp_step<R, STRIDE>(v, gbase, size);
  if constexpr (STRIDE > 1) warp_merge<R, STRIDE / 2>(v, gbase, size);
}

// Sorts the warp's 32R words (elements gbase .. gbase + 32R of a bitonic
// sort, gbase a multiple of 32R): descending where gbase & 32R is 0.
template <int R, int SIZE = 2>
__device__ __forceinline__ void warp_sort(unsigned long long (&v)[R],
                                          int gbase = 0) {
  warp_merge<R, SIZE / 2>(v, gbase, SIZE);
  if constexpr (SIZE < 32 * R) warp_sort<R, SIZE * 2>(v, gbase);
}

template <int R>
__global__ void __launch_bounds__(WARP_ROWS * 32)
select_warp(const void* x, int dtype, long long rows, long long width,
            long long s0, long long s1, int k, void* vals, long long* ids) {
  const long long row =
      static_cast<long long>(blockIdx.x) * WARP_ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  unsigned long long v[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const long long col = i * 32 + lane;  // coalesced; the sort re-places
    v[i] = col < width ? pack(load_key(x, dtype, row * s0 + col * s1), col)
                       : 0ull;            // below every real word
  }
  warp_sort<R>(v);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int s = lane * R + i;
    if (s < k) write_word(dtype, row * k + s, v[i], vals, ids);
  }
}

// ---- the block path: a threshold filter into one row's buffer.

// What a block path launch reads: x of one dtype (F32, BF16, I32), or
// the words an earlier stage left.
enum Mode : int { READ_F32 = F32, READ_BF16 = BF16, READ_I32 = I32,
                  READ_WORDS = 3 };

// One launch of the block path.  The first stage reads x with strides
// s0, s1; a later one reads the words [rows, width] an earlier stage left
// (in).  An intermediate stage writes [rows, chunks * k] words to out;
// the last (chunks == 1) writes vals and ids.
struct Stage {
  const void* x;
  int dtype;
  long long s0, s1;
  const unsigned long long* in;
  long long rows, width;
  int k;
  long long chunk;
  int chunks;
  int log_cap;   // the buffer holds 1 << log_cap words
  unsigned long long* out;
  void* vals;
  long long* ids;
};

// The block's state, ahead of its buffer in dynamic shared memory (all
// dynamic: hx::ready opts in the whole limit).
struct alignas(16) Head {  // the buffer after it starts 16-byte aligned
  unsigned long long tau;     // the threshold
  unsigned long long prefix;  // the radix select's running word
  int cnt;                    // words in the buffer
  int rank;                   // rank left within the prefix
  int state;                  // 0 idle, 1 selecting, 2 bin taken whole
  int outc;                   // the compaction's count
  int pend;                   // words the current tile would append
  unsigned hist[256];
};

// What one copy brings: the aligned 4 bytes holding the input's element
// (a bf16 element is one half of them), or a word of an earlier stage.
template <int MODE>
struct Raw {
  using T = uint32_t;
  static constexpr int STAGES = 6;  // tiles in a block's ring
};
template <>
struct Raw<READ_WORDS> {
  using T = unsigned long long;
  static constexpr int STAGES = 3;
};

// An asynchronous copy of N bytes (cp.async: into shared memory, through
// no register).
template <int N>
__device__ __forceinline__ void copy_async(void* dst, const char* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(N));
}

__device__ __forceinline__ void copy_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The word of a copied element in column col: raw as copied (a bf16
// element in the upper half where odd).
template <int MODE>
__device__ __forceinline__ unsigned long long word_of(
    typename Raw<MODE>::T raw, bool odd, int col) {
  if constexpr (MODE == READ_WORDS)
    return raw;
  else if constexpr (MODE == READ_I32)
    return pack(raw ^ 0x80000000u, col);
  else if constexpr (MODE == READ_BF16)
    return pack(float_key(odd ? raw & 0xffff0000u : raw << 16), col);
  else
    return pack(float_key(raw), col);
}

// Keeps, where the buffer holds more than `above` words (need, or need -
// 1 to set tau from exactly need words), its need largest: an MSB radix
// select of 8 bits a pass finds the need-th largest word T, stopping when
// the bin it picks is taken whole (T is then the bin's prefix with zero
// low bits); the words >= T stay, tau = T.
__device__ __forceinline__ void compact_rows(Head& h,
                                             unsigned long long* buf,
                                             int need, int above) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int n = h.cnt;  // still until the end
  if (n <= above) return;
  if (t == 0) {
    h.prefix = 0;
    h.rank = need;
    h.state = 1;
  }
  __syncthreads();
  for (int shift = 56; h.state == 1 && shift >= 0; shift -= 8) {
    const unsigned long long prefix = h.prefix;
    if (t < 256) h.hist[t] = 0;
    __syncthreads();
    for (int e0 = 0; e0 < n; e0 += THREADS) {
      const int e = e0 + t;
      bool live = false;
      unsigned long long v = 0;
      if (e < n) {
        v = buf[e];
        live = shift == 56 || ((v ^ prefix) >> (shift + 8)) == 0;
      }
      add_bin(h.hist, static_cast<int>((v >> shift) & 255u), live);
    }
    __syncthreads();
    if (t < 32) {
      // lane l holds bins 255 - 8l down to 248 - 8l: lanes in order are
      // bins from the top
      int c[8];
      int sum = 0;
      for (int j = 0; j < 8; ++j) {
        c[j] = static_cast<int>(h.hist[255 - 8 * lane - j]);
        sum += c[j];
      }
      int incl = sum;
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += up;
      }
      int before = incl - sum;
      const int want = h.rank;
      const bool mine = before < want && want <= incl;
      int digit = 0, left = 0, in_bin = 0;
      if (mine) {
        for (int j = 0; j < 8; ++j) {
          if (before + c[j] >= want) {
            digit = 255 - 8 * lane - j;
            left = want - before;
            in_bin = c[j];
            break;
          }
          before += c[j];
        }
      }
      const int src = __ffs(__ballot_sync(FULL, mine)) - 1;
      digit = __shfl_sync(FULL, digit, src);
      left = __shfl_sync(FULL, left, src);
      in_bin = __shfl_sync(FULL, in_bin, src);
      if (lane == 0) {
        h.prefix = prefix | static_cast<unsigned long long>(digit) << shift;
        h.rank = left;
        if (in_bin == left) h.state = 2;
      }
    }
    __syncthreads();
  }
  // The compaction, in rounds of CW words a thread: every read of a round
  // before any write, and a word moves only to a slot below the end of
  // what its round read.
  constexpr int CW = 8;
  const unsigned long long T = h.prefix;
  if (t == 0) h.outc = 0;
  for (int e0 = 0; e0 < n; e0 += THREADS * CW) {
    unsigned long long v[CW];
    bool keep[CW];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int e = e0 + j * THREADS + t;
      v[j] = e < n ? buf[e] : 0ull;
      keep[j] = e < n && v[j] >= T;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const unsigned ballot = __ballot_sync(FULL, keep[j]);
      if (ballot) {
        const int leader = __ffs(ballot) - 1;
        int base = 0;
        if (lane == leader) base = atomicAdd(&h.outc, __popc(ballot));
        base = __shfl_sync(FULL, base, leader);
        if (keep[j])
          buf[base + __popc(ballot & ((1u << lane) - 1u))] = v[j];
      }
    }
  }
  __syncthreads();
  if (t == 0) {
    h.cnt = h.outc;
    h.tau = T;
  }
  __syncthreads();
}

// For need <= 256, where the buffer holds more than `above` words: its
// 256 largest, sorted descending, to the start of the buffer: chunks of
// 256 words sorted in registers, one warp each, then merged two by two
// (the larger of a[i] and b[255 - i] are the pair's 256 largest, a
// bitonic sequence that 8 register steps sort).  cnt = min(cnt, need),
// tau = the last word kept.
__device__ __forceinline__ void compact_top(Head& h, unsigned long long* buf,
                                            int need, int above) {
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int n = h.cnt;  // still until the end
  if (n <= above) return;
  const int chunks = (n + 255) >> 8;
  for (int c = warp; c < chunks; c += WARPS) {
    unsigned long long* a = buf + (c << 8);
    unsigned long long v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = (c << 8) + lane * 8 + i < n ? a[lane * 8 + i] : 0ull;
    warp_sort<8>(v);
#pragma unroll
    for (int i = 0; i < 8; ++i) a[lane * 8 + i] = v[i];
  }
  __syncthreads();
  for (int d = 1; d < chunks; d <<= 1) {
    for (int c = warp * 2 * d; c + d < chunks; c += WARPS * 2 * d) {
      unsigned long long* a = buf + (c << 8);
      const unsigned long long* b = a + (d << 8);
      unsigned long long v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const unsigned long long x = a[lane * 8 + i];
        const unsigned long long y = b[255 - lane * 8 - i];
        v[i] = x > y ? x : y;
      }
      warp_merge<8, 128>(v, 0, 256);
#pragma unroll
      for (int i = 0; i < 8; ++i) a[lane * 8 + i] = v[i];
    }
    __syncthreads();
  }
  if (t == 0) {
    h.cnt = min(n, need);
    h.tau = buf[h.cnt - 1];
  }
  __syncthreads();
}

// Keeps the buffer's need largest words where it holds more than `above`
// (compact_top or compact_rows).  A call, one copy for every kernel: the
// tile loop holds little across it (its loads wait in the ring).
__device__ __noinline__ void compact(Head& h, unsigned long long* buf,
                                     int need, int above) {
  if (need <= 256)
    compact_top(h, buf, need, above);
  else
    compact_rows(h, buf, need, above);
}

// Appends w, where keep, to the buffer: one shared atomic per warp.
// Returns, on the lane that took the slots, the count after them (else
// 0): the largest over the block is the count once all have appended.
__device__ __forceinline__ int append(Head& h, unsigned long long* buf,
                                      bool keep, unsigned long long w) {
  const int lane = threadIdx.x & 31;
  const unsigned ballot = __ballot_sync(FULL, keep);
  int end = 0;
  if (ballot) {
    const int leader = __ffs(ballot) - 1;
    int slot = 0;
    if (lane == leader) {
      slot = atomicAdd(&h.cnt, __popc(ballot));
      end = slot + __popc(ballot);
    }
    slot = __shfl_sync(FULL, slot, leader);
    if (keep) buf[slot + __popc(ballot & ((1u << lane) - 1u))] = w;
  }
  return end;
}

// Sorts buf[0, pw) descending (pw a power of two >= 256): a bitonic sort
// whose steps of stride below 256 run in registers, 256 words a warp, and
// whose wider steps pass through shared memory.
__device__ __noinline__ void sort_words(unsigned long long* buf, int pw) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int size = 256; size <= pw; size <<= 1) {
    for (int stride = size >> 1; stride >= 256; stride >>= 1) {
      for (int i = threadIdx.x; i < (pw >> 1); i += THREADS) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool descending = (lo & size) == 0;
        const unsigned long long va = buf[lo], vb = buf[hi];
        if ((va < vb) == descending) {
          buf[lo] = vb;
          buf[hi] = va;
        }
      }
      __syncthreads();
    }
    for (int gbase = warp << 8; gbase < pw; gbase += WARPS << 8) {
      unsigned long long* a = buf + gbase + lane * 8;
      unsigned long long v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = a[i];
      if (size == 256)
        warp_sort<8>(v, gbase);
      else
        warp_merge<8, 128>(v, gbase, size);
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = v[i];
    }
    __syncthreads();
  }
}

// This thread's copies of one tile into its ring slot, committed as one
// group (empty past the chunk), its elements j < valid.  Strided: element
// j at src + j * jstep into slot[j * THREADS] (bf16: the aligned 4 bytes
// holding it).  VEC (a contiguous row, 16 or 8 aligned bytes): the BV
// elements at src into slot[0 .. BV) in one copy, one by one at the
// chunk's end (bf16: two a 4-byte copy).
template <int MODE, bool VEC>
__device__ __forceinline__ void copy_tile(const char* src, long long jstep,
                                          int valid,
                                          typename Raw<MODE>::T* slot) {
  using RawT = typename Raw<MODE>::T;
  if constexpr (VEC) {
    constexpr int ESIZE = MODE == READ_BF16 ? 2 : 4;
    if (valid == BV) {
      copy_async<BV * ESIZE>(slot, src);
    } else {
#pragma unroll
      for (int j = 0; j < BV; j += 4 / ESIZE)
        if (j < valid) copy_async<4>(slot + j * ESIZE / 4, src + j * ESIZE);
    }
  } else {
#pragma unroll
    for (int j = 0; j < BV; ++j) {
      if (j < valid) {
        const char* a = src + j * jstep;
        if constexpr (MODE == READ_BF16)
          a = reinterpret_cast<const char*>(reinterpret_cast<uintptr_t>(a) &
                                            ~uintptr_t{3});
        copy_async<sizeof(RawT)>(slot + j * THREADS, a);
      }
    }
  }
  copy_commit();
}

// How many of this thread's BV tile elements (columns col0 + j * step)
// lie before end.
__device__ __forceinline__ int valid_of(int col0, int end, int step) {
  return col0 >= end ? 0 : min(BV, (end - col0 + step - 1) / step);
}

// Block (row, chunk): columns [chunk * p.chunk, + p.chunk) of one row.
// Blocks that run together take the same chunk of adjacent rows, so a
// transposed view's strided columns share L2 sectors.
template <int MODE, bool VEC>
__global__ void __launch_bounds__(THREADS, 2) select_block(Stage p) {
  using RawT = typename Raw<MODE>::T;
  constexpr int STAGES = Raw<MODE>::STAGES;
  constexpr int ESIZE = MODE == READ_WORDS ? 8 : MODE == READ_BF16 ? 2 : 4;
  constexpr int TILE = THREADS * BV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Head& h = *reinterpret_cast<Head*>(smem_raw);
  unsigned long long* buf =
      reinterpret_cast<unsigned long long*>(smem_raw + sizeof(Head));
  const int t = threadIdx.x;
  const int cap = 1 << p.log_cap;
  const long long row = blockIdx.x % p.rows;
  const long long chunk = blockIdx.x / p.rows;
  // columns are below 2^31
  const int c0 = static_cast<int>(chunk * p.chunk);
  const int c1 = static_cast<int>(min(p.width, c0 + p.chunk));
  const int need = min(p.k, c1 - c0);
  // the first tile's words a thread that seed tau (need over the
  // threads), where that is at most half of its tile
  const int seed_words = (need + THREADS - 1) / THREADS;
  const int seed = seed_words <= BV / 2 ? seed_words : 0;
  if (t == 0) {
    h.cnt = 0;
    h.tau = 0;
    h.pend = 0;
  }
  __syncthreads();
  // This thread's elements: columns c0 + lead + j * step + i * TILE of
  // tile i, at src + j * jstep + i * tstep; VEC (a contiguous, aligned
  // row) takes BV adjacent columns a thread.  A bf16 element's half of its
  // copy is the same for all of a strided thread's elements (THREADS and
  // TILE are even), element j's parity for VEC.
  const int lead = VEC ? BV * t : t;
  const int step = VEC ? 1 : THREADS;
  const char* src =
      MODE == READ_WORDS
          ? reinterpret_cast<const char*>(p.in + row * p.width + c0 + lead)
          : static_cast<const char*>(p.x) +
                ESIZE * (row * p.s0 + (c0 + lead) * p.s1);
  const long long s1 = MODE == READ_WORDS ? 1 : p.s1;
  const long long jstep = ESIZE * s1 * step;
  const long long tstep = ESIZE * s1 * TILE;
  const bool odd = MODE == READ_BF16 && !VEC &&
                   (reinterpret_cast<uintptr_t>(src) & 2) != 0;
  // A ring of STAGES tiles in shared memory, after the buffer, filled by
  // cp.async STAGES - 1 tiles ahead: the loads hold no register, and each
  // thread reads back only the elements it copied (its own completed
  // groups), so the ring needs no barrier.
  RawT* ring = reinterpret_cast<RawT*>(buf + cap) + (VEC ? BV * t : t);
  int ahead = c0 + lead;  // the column of the next tile copied, element 0
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    copy_tile<MODE, VEC>(src, jstep, valid_of(ahead, c1, step),
                         ring + s * TILE);
    src += tstep;
    ahead += TILE;
  }
  int slot = 0;
  bool full = false;  // compact before this tile's appends
  for (int base = c0; base < c1; base += TILE) {
    copy_tile<MODE, VEC>(src, jstep, valid_of(ahead, c1, step),
                         ring + (slot == 0 ? STAGES - 1 : slot - 1) * TILE);
    src += tstep;
    ahead += TILE;
    copy_wait<STAGES - 1>();
    const int col0 = base + lead;
    const int valid = valid_of(col0, c1, step);
    const RawT* got = ring + slot * TILE;
    unsigned long long w[BV];
#pragma unroll
    for (int j = 0; j < BV; ++j) {
      const int col = col0 + j * step;
      if (j >= valid)
        w[j] = 0ull;
      else if (VEC && MODE == READ_BF16)
        w[j] = word_of<MODE>(got[j / 2], (j & 1) != 0, col);
      else
        w[j] = word_of<MODE>(got[VEC ? j : j * THREADS], odd, col);
    }
    slot = slot == STAGES - 1 ? 0 : slot + 1;
    unsigned long long tau = h.tau;
    // The first tile seeds tau: each thread's `seed` largest words go in
    // first, and the need-th largest of those (a subset of the chunk, so
    // at or below its need-th) becomes tau before the rest of the tile is
    // filtered.  Words are distinct: exactly a thread's `seed` largest are
    // at or above its seed-th largest, ms (all of them where ms is 0).
    const bool seeding = base == c0 && seed > 0;
    unsigned long long ms = 0;
    if (seeding) {
      unsigned long long top0 = 0, top1 = 0;  // this thread's largest
#pragma unroll
      for (int j = 0; j < BV; ++j) {
        if (w[j] > top0) {
          top1 = top0;
          top0 = w[j];
        } else if (w[j] > top1) {
          top1 = w[j];
        }
      }
      ms = seed == 1 ? top0 : top1;
#pragma unroll
      for (int j = 0; j < BV; ++j)
        append(h, buf, w[j] != 0 && w[j] >= ms, w[j]);
      __syncthreads();
      compact(h, buf, need, need - 1);
      tau = h.tau;
    } else if (need > 256) {
      // Past 256 words (compact_rows) the tile's survivors are counted
      // first, so that the buffer is compacted only when they would not
      // fit (the count is still since the last tile's barrier).
      int mine = 0;
#pragma unroll
      for (int j = 0; j < BV; ++j) {
        const bool keep = w[j] != 0 && w[j] >= tau;
        const unsigned ballot = __ballot_sync(FULL, keep);
        if (keep && (t & 31) == __ffs(ballot) - 1) mine += __popc(ballot);
      }
      const int coming = mine ? atomicAdd(&h.pend, mine) + mine : 0;
      full = __syncthreads_or(coming && h.cnt + coming > cap);
      if (t == 0) h.pend = 0;
    }
    if (full) {
      compact(h, buf, need, need);
      tau = h.tau;
    }
    int end = 0;
#pragma unroll
    for (int j = 0; j < BV; ++j)
      end = max(end, append(h, buf,
                            w[j] != 0 && w[j] >= tau &&
                                (!seeding || w[j] < ms),
                            w[j]));
    // Up to 256 words, the next tile is compacted for when a whole tile
    // might not fit: some lane that appended saw the final count.
    full = __syncthreads_or(need <= 256 && end + TILE > cap);
  }
  if (p.out != nullptr) {  // this chunk's need words, zeros to k
    if (h.cnt > need) compact(h, buf, need, need);
    const long long o = row * p.chunks * p.k + chunk * p.k;
    for (int j = t; j < p.k; j += THREADS)
      p.out[o + j] = j < h.cnt ? buf[j] : 0ull;
    return;
  }
  // The last stage: one chunk per row, its k words sorted and written.
  // Up to 256 compact_top sorts them; past it compact_rows keeps them and
  // sort_words sorts them, padded with zeros to a power of two.
  if (need <= 256) {
    compact(h, buf, need, 0);
  } else {
    if (h.cnt > need) compact(h, buf, need, need);
    int pw = 256;
    while (pw < need) pw <<= 1;
    for (int j = need + t; j < pw; j += THREADS) buf[j] = 0ull;
    __syncthreads();
    sort_words(buf, pw);
  }
  for (int j = t; j < need; j += THREADS)
    write_word(p.dtype, row * p.k + j, buf[j], p.vals, p.ids);
}

// ---- the wide path, k > BLOCK_K_MAX: the select over the whole row, its
// state in device memory.  state holds 4 ints per row: the running prefix
// (T at the end), the rank left within it (the keys equal to T that
// belong to the top k), the count of keys above T, and one unused.

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

// A selection's plan: the path, and for the block path its stages.
struct Plan {
  int path;
  int param;   // WARP: words per lane R
  int stages;
  long long scratch;  // bytes
  long long width[MAX_STAGES];
  long long chunk[MAX_STAGES];
  long long chunks[MAX_STAGES];
  int log_cap[MAX_STAGES];
};

// The buffer (log2 of its words) of a block path row: k words and a tile.
int log_cap_of(int k) {
  int lc = 0;
  while ((1 << lc) < k + THREADS * BV) ++lc;
  return lc;
}

// The chunk of a block path stage over `width` columns: one chunk when the
// row is at most 32k wide, else chunks of width / (4 x SMS blocks over the
// rows), kept within [max(16384, 16k), 131072], rounded up to a tile.
void chunk_of(long long width, long long rows, int k, long long* chunk,
              long long* chunks) {
  *chunk = width;
  *chunks = 1;
  if (width <= 32LL * k) return;
  const long long want = ceil_div(4LL * SMS, rows);
  const long long lo = std::max<long long>(16384, 16LL * k);
  const long long hi = std::max<long long>(lo, 131072);
  const long long tile = THREADS * BV;  // chunks start on a tile
  const long long c =
      ceil_div(std::min(std::max(ceil_div(width, want), lo), hi), tile) *
      tile;
  if (c >= width) return;
  *chunk = c;
  *chunks = ceil_div(width, c);
}

// ops/topk.py:plan is the same planner.  Returns -3 when the shape is not
// taken.
int plan_of(long long rows, long long width, int k, Plan* pl) {
  if (rows < 1 || k < 1 || width < k || width >= (1LL << 31)) return -3;
  pl->stages = 0;
  pl->scratch = 0;
  if (k > BLOCK_K_MAX) {
    pl->path = WIDE;
    pl->param = 0;
    pl->scratch =
        rows * (16LL * k + 8LL * ceil_div(width, SLICE) + 4LL * 260);
    return 0;
  }
  if (width <= WARP_MAX) {
    pl->path = WARP;
    int r = 1;
    while (32LL * r < width) r <<= 1;
    pl->param = r;
    return 0;
  }
  pl->path = BLOCK;
  pl->param = 0;
  long long w = width, need = 0;
  for (int s = 0;; ++s) {
    if (s == MAX_STAGES) return -3;
    pl->width[s] = w;
    pl->log_cap[s] = log_cap_of(k);
    chunk_of(w, rows, k, &pl->chunk[s], &pl->chunks[s]);
    pl->stages = s + 1;
    if (rows * pl->chunks[s] >= (1LL << 31)) return -3;
    if (pl->chunks[s] == 1) break;
    w = pl->chunks[s] * k;
    if (s < 2) need += w;  // later stages alternate between two regions
  }
  pl->scratch = 8 * rows * need;
  return 0;
}

int select_warp_path(const void* x, int dtype, long long rows,
                     long long width, long long s0, long long s1, int k,
                     int r, void* vals, long long* ids, cudaStream_t s) {
  const long long blocks = ceil_div(rows, WARP_ROWS);
  if (blocks >= (1LL << 31)) return -3;
  const dim3 grid(static_cast<unsigned>(blocks));
  const int threads = WARP_ROWS * 32;
  using Kernel = void (*)(const void*, int, long long, long long, long long,
                          long long, int, void*, long long*);
  const Kernel kernel = r == 1   ? select_warp<1>
                        : r == 2 ? select_warp<2>
                        : r == 4 ? select_warp<4>
                        : r == 8 ? select_warp<8>
                                 : select_warp<16>;
  kernel<<<grid, threads, 0, s>>>(x, dtype, rows, width, s0, s1, k, vals,
                                  ids);
  return static_cast<int>(cudaGetLastError());
}

// One stage's launch, after its kernel's shared-memory opt-in: the head,
// the buffers (`smem` bytes) and the ring.
template <int MODE, bool VEC>
int launch_stage(const Stage& p, unsigned grid, size_t smem,
                 cudaStream_t s) {
  int sms = 0;
  const int err = hx::ready<select_block<MODE, VEC>>(&sms);
  if (err != 0) return err;
  smem += Raw<MODE>::STAGES * THREADS * BV * sizeof(typename Raw<MODE>::T);
  select_block<MODE, VEC><<<grid, THREADS, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int select_block_path(const void* x, int dtype, long long rows,
                      long long s0, long long s1, int k, const Plan& pl,
                      void* vals, long long* ids, void* scratch,
                      cudaStream_t s) {
  unsigned long long* region[2] = {
      static_cast<unsigned long long*>(scratch), nullptr};
  if (pl.stages > 1)
    region[1] = region[0] + rows * pl.width[1];
  const unsigned long long* in = nullptr;
  for (int st = 0; st < pl.stages; ++st) {
    const bool last = st == pl.stages - 1;
    Stage p{x, dtype, s0, s1, in, rows, pl.width[st], k, pl.chunk[st],
            static_cast<int>(pl.chunks[st]), pl.log_cap[st],
            last ? nullptr : region[st & 1], vals, ids};
    const size_t smem = sizeof(Head) + (size_t{8} << pl.log_cap[st]);
    const unsigned grid = static_cast<unsigned>(rows * pl.chunks[st]);
    // the first stage copies a contiguous, aligned row's BV columns at
    // once (16 bytes; bf16: 8)
    const int esize = dtype == BF16 ? 2 : 4;
    const bool vec =
        st == 0 && s1 == 1 && (rows == 1 || s0 % BV == 0) &&
        reinterpret_cast<uintptr_t>(x) % (BV * esize) == 0;
    const int mode = st == 0 ? dtype : READ_WORDS;
    int err;
    if (mode == READ_WORDS)
      err = launch_stage<READ_WORDS, false>(p, grid, smem, s);
    else if (mode == READ_F32)
      err = vec ? launch_stage<READ_F32, true>(p, grid, smem, s)
                : launch_stage<READ_F32, false>(p, grid, smem, s);
    else if (mode == READ_BF16)
      err = vec ? launch_stage<READ_BF16, true>(p, grid, smem, s)
                : launch_stage<READ_BF16, false>(p, grid, smem, s);
    else
      err = vec ? launch_stage<READ_I32, true>(p, grid, smem, s)
                : launch_stage<READ_I32, false>(p, grid, smem, s);
    if (err != 0) return err;
    in = region[st & 1];
  }
  return 0;
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

// The plan of a selection of k of `width` columns over `rows` rows, as
// ops/topk.py:plan gives it: out[0..3] = path,
// its parameter, stages, scratch bytes; then per stage width, chunk,
// chunks, log2 of the buffer.  Returns 0, or -3 when the shape is not
// taken.
extern "C" int hx_select_topk_plan(long long rows, long long width, int k,
                                   long long* out) {
  Plan pl;
  const int rc = plan_of(rows, width, k, &pl);
  if (rc != 0) return rc;
  out[0] = pl.path;
  out[1] = pl.param;
  out[2] = pl.stages;
  out[3] = pl.scratch;
  for (int s = 0; s < pl.stages; ++s) {
    out[4 + 4 * s] = pl.width[s];
    out[5 + 4 * s] = pl.chunk[s];
    out[6 + 4 * s] = pl.chunks[s];
    out[7 + 4 * s] = pl.log_cap[s];
  }
  return 0;
}

// x: a [rows, width] view with element strides s0, s1 of dtype F32, BF16
// or I32; vals [rows, k] (x's dtype) and ids [rows, k] int64 contiguous;
// scratch holds the plan's scratch bytes (null when that is 0).  Launches
// on `stream`; returns 0, hx::HX_CAPTURED (launched into a stream capturing
// a CUDA graph: a node, not a launch), a cudaError_t, or -3 when the shape
// is not taken.
extern "C" int hx_select_topk(const void* x, int dtype, long long rows,
                              long long width, long long s0,
                              long long s1, int k, void* vals, long long* ids,
                              void* scratch, long long scratch_bytes,
                              void* stream) {
  if (dtype != F32 && dtype != BF16 && dtype != I32) return -3;
  Plan pl;
  if (plan_of(rows, width, k, &pl) != 0 ||
      pl.scratch != scratch_bytes)
    return -3;
  if (scratch_bytes > 0 && scratch == nullptr) return -3;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  if (pl.path == WARP) {
    err = select_warp_path(x, dtype, rows, width, s0, s1, k, pl.param, vals,
                           ids, s);
  } else if (pl.path == BLOCK) {
    err = select_block_path(x, dtype, rows, s0, s1, k, pl, vals, ids,
                            scratch, s);
  } else {
    // the wide path's shared-memory opt-in, on its first call
    int sms = 0;
    err = hx::ready<wide_compact>(&sms);
    if (err == 0) err = hx::ready<wide_sort_runs>(&sms);
    if (err == 0)
      err = select_wide(x, dtype, rows, width, s0, s1, k, vals, ids,
                        scratch, s);
  }
  return hx::launched(s, err);
}
