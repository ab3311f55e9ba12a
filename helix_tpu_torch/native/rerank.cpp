// Exact candidate re-ranking on the host-resident float32 matrix.
//
// The TPU scan phase returns approximate top-k' candidates (bfloat16 /
// int8 matmul + approx_max_k); this re-scores just those rows in
// float32 and emits the exact final top-k per query.
//
// The naive loop (per query, per candidate, random row reads) is
// memory-miss bound: at 1M x 128-d the matrix is 512 MB, so every
// candidate row is a TLB + cache miss, and clustered query batches
// re-fetch the same rows once per query.  This version sorts the
// (row, query) incidence list by row id first, so the sweep walks the
// matrix in ascending-address order (hardware prefetch works), a row
// shared by many queries is fetched from DRAM once, and an explicit
// software prefetch hides the remaining misses.  Queries (a few
// hundred rows) stay L2-resident throughout.  Large batches split
// across threads by query range (HX_RERANK_THREADS overrides the
// hardware count).
//
// Output contract is unchanged: per query, candidates scored exactly
// in f32, final top-k by (distance, row id) ascending, -1/3.4e38 pads.
//
// C ABI only (loaded via ctypes).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <thread>
#include <vector>

namespace {

inline float dot(const float* a, const float* b, int64_t d) {
  float acc0 = 0.f, acc1 = 0.f, acc2 = 0.f, acc3 = 0.f;
  int64_t i = 0;
  for (; i + 4 <= d; i += 4) {
    acc0 += a[i] * b[i];
    acc1 += a[i + 1] * b[i + 1];
    acc2 += a[i + 2] * b[i + 2];
    acc3 += a[i + 3] * b[i + 3];
  }
  float acc = acc0 + acc1 + acc2 + acc3;
  for (; i < d; i++) acc += a[i] * b[i];
  return acc;
}

// One thread's query range [q_lo, q_hi).
void rerank_range(const float* data, const float* sq_norms, int64_t n,
                  int64_t d, const float* queries, int64_t q_lo, int64_t q_hi,
                  const int64_t* cand, int64_t kc, int64_t k, int metric_l2,
                  int64_t* out_idx, float* out_dist) {
  const int64_t b_local = q_hi - q_lo;
  // Incidence keys: row-major order so the scoring sweep walks the
  // matrix forward.  qi fits 24 bits (16M queries per
  // thread range), rows fit the remaining 40 (1T rows).
  std::vector<uint64_t> keys;
  keys.reserve(static_cast<size_t>(b_local) * kc);
  for (int64_t qi = q_lo; qi < q_hi; qi++) {
    const int64_t* c = cand + qi * kc;
    for (int64_t ci = 0; ci < kc; ci++) {
      int64_t row = c[ci];
      if (row < 0 || row >= n) continue;
      keys.push_back((static_cast<uint64_t>(row) << 24) |
                     static_cast<uint64_t>(qi - q_lo));
    }
  }
  std::sort(keys.begin(), keys.end());

  std::vector<float> q_sq;
  if (metric_l2) {
    q_sq.resize(b_local);
    for (int64_t qi = 0; qi < b_local; qi++)
      q_sq[qi] = dot(queries + (q_lo + qi) * d, queries + (q_lo + qi) * d, d);
  }

  std::vector<std::vector<std::pair<float, int64_t>>> scored(b_local);
  for (auto& s : scored) s.reserve(std::min<int64_t>(kc, 4 * k));

  constexpr int64_t PF = 8;  // prefetch distance (rows ahead)
  const int64_t m = static_cast<int64_t>(keys.size());
  for (int64_t i = 0; i < m; i++) {
    if (i + PF < m) {
      const float* next = data + static_cast<int64_t>(keys[i + PF] >> 24) * d;
      __builtin_prefetch(next, 0, 1);
      __builtin_prefetch(next + 16, 0, 1);
    }
    const int64_t row = static_cast<int64_t>(keys[i] >> 24);
    const int64_t qi = static_cast<int64_t>(keys[i] & 0xFFFFFFu);
    const float* q = queries + (q_lo + qi) * d;
    float s = dot(data + row * d, q, d);
    float dist = metric_l2 ? (sq_norms[row] - 2.f * s + q_sq[qi]) : (1.f - s);
    scored[qi].emplace_back(dist, row);
  }

  for (int64_t qi = 0; qi < b_local; qi++) {
    auto& sc = scored[qi];
    int64_t keep = std::min<int64_t>(k, static_cast<int64_t>(sc.size()));
    std::partial_sort(sc.begin(), sc.begin() + keep, sc.end());
    int64_t* oi = out_idx + (q_lo + qi) * k;
    float* od = out_dist + (q_lo + qi) * k;
    for (int64_t j = 0; j < k; j++) {
      if (j < keep) {
        od[j] = sc[j].first;
        oi[j] = sc[j].second;
      } else {
        od[j] = 3.4e38f;
        oi[j] = -1;
      }
    }
  }
}

int thread_budget() {
  if (const char* env = std::getenv("HX_RERANK_THREADS")) {
    int v = std::atoi(env);
    if (v > 0) return v;
  }
  unsigned hw = std::thread::hardware_concurrency();
  return hw ? static_cast<int>(hw) : 1;
}

}  // namespace

extern "C" {

// Re-rank candidates for a query batch.
//
//   data      [n, d]  row-major float32 packed matrix
//   sq_norms  [n]     squared norms (used when metric_l2 != 0)
//   queries   [b, d]  float32 (pre-normalized for cosine)
//   cand      [b, kc] int64 candidate row indices (may repeat; -1 = pad)
//   out_idx   [b, k]  int64 final indices
//   out_dist  [b, k]  float32 final distances ascending
//                     (cosine: 1 - dot; l2: |x|^2 - 2x.q + |q|^2)
void hx_rerank(const float* data, const float* sq_norms, int64_t n, int64_t d,
               const float* queries, int64_t b,
               const int64_t* cand, int64_t kc,
               int64_t k, int metric_l2,
               int64_t* out_idx, float* out_dist) {
  // threads only pay off past ~32 queries of work each
  int nt = std::min<int64_t>(thread_budget(), std::max<int64_t>(b / 32, 1));
  if (nt <= 1) {
    rerank_range(data, sq_norms, n, d, queries, 0, b, cand, kc, k, metric_l2,
                 out_idx, out_dist);
    return;
  }
  std::vector<std::thread> workers;
  workers.reserve(nt);
  int64_t per = (b + nt - 1) / nt;
  for (int t = 0; t < nt; t++) {
    int64_t lo = t * per, hi = std::min<int64_t>(b, lo + per);
    if (lo >= hi) break;
    workers.emplace_back(rerank_range, data, sq_norms, n, d, queries, lo, hi,
                         cand, kc, k, metric_l2, out_idx, out_dist);
  }
  for (auto& w : workers) w.join();
}

}  // extern "C"
