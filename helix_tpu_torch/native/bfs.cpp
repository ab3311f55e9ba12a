// Multithreaded CSR BFS frontier expansion.
//
// The TPU padded-adjacency kernels (ops/csr.py) pay XLA's scatter cost
// for frontier expansion (~115 ms/hop at 1M nodes / 16M edges on a
// v5e); a byte-mask CSR sweep on the host CPU walks the same hop in a
// few milliseconds because expansion is a linear pass over the edge
// array with no sort.  The executor's traversal planner prefers this
// path; the device kernels remain for multi-chip sharded traversals.
//
// Semantics match ops/csr.py khop_mask: each hop REPLACES the mask
// with the neighbor set (BFS frontier, not closure); an edge counts
// when label_code < 0 or its label matches.
//
// Threading: hops parallelize over source ranges.  Concurrent stores
// of the constant 1 into the next-frontier byte mask are benign
// (idempotent stores of one value; C++ makes unsynchronized bytes UB
// in theory, so the stores go through relaxed atomics, which compile
// to plain byte stores on x86/ARM).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// One BFS hop: frontier `mask` (n bytes, 0/1) -> `next` (n bytes).
// indptr: n+1 entries; targets/labels: indptr[n] entries.
void hx_bfs_hop(const int64_t* indptr, const int32_t* targets,
                const int32_t* labels, int64_t n, const uint8_t* mask,
                uint8_t* next, int32_t label_code, int32_t n_threads) {
  std::memset(next, 0, static_cast<size_t>(n));
  auto* next_atomic = reinterpret_cast<std::atomic<uint8_t>*>(next);
  if (n_threads < 1) n_threads = 1;
  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t u = lo; u < hi; ++u) {
      if (!mask[u]) continue;
      const int64_t start = indptr[u], end = indptr[u + 1];
      if (label_code < 0) {
        for (int64_t e = start; e < end; ++e) {
          next_atomic[targets[e]].store(1, std::memory_order_relaxed);
        }
      } else {
        for (int64_t e = start; e < end; ++e) {
          if (labels[e] == label_code) {
            next_atomic[targets[e]].store(1, std::memory_order_relaxed);
          }
        }
      }
    }
  };
  if (n_threads == 1 || n < 4096) {
    worker(0, n);
    return;
  }
  std::vector<std::thread> pool;
  const int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int32_t t = 0; t < n_threads; ++t) {
    const int64_t lo = t * chunk;
    const int64_t hi = lo + chunk < n ? lo + chunk : n;
    if (lo >= hi) break;
    pool.emplace_back(worker, lo, hi);
  }
  for (auto& th : pool) th.join();
}

// k-hop frontier: hops >= 1, mask updated in place (scratch must be n
// bytes).  Returns the frontier population count.
int64_t hx_bfs_khop(const int64_t* indptr, const int32_t* targets,
                    const int32_t* labels, int64_t n, uint8_t* mask,
                    uint8_t* scratch, int32_t label_code, int32_t hops,
                    int32_t n_threads) {
  uint8_t* cur = mask;
  uint8_t* nxt = scratch;
  for (int32_t h = 0; h < hops; ++h) {
    hx_bfs_hop(indptr, targets, labels, n, cur, nxt, label_code, n_threads);
    uint8_t* tmp = cur; cur = nxt; nxt = tmp;
  }
  if (cur != mask) std::memcpy(mask, cur, static_cast<size_t>(n));
  int64_t count = 0;
  for (int64_t u = 0; u < n; ++u) count += mask[u];
  return count;
}

}  // extern "C"
