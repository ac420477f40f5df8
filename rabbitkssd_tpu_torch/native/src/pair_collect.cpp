// Sparse strip counting, stage 1: expand the posting join into packed
// (row, col) keys instead of incrementing a dense strip.
//
// The dense walk (pair_count.cpp, the reference's dist.cpp:174-204
// loop) pays O(rows * n1) memory traffic per strip to memset the strip
// and scan it back for emission — at 1M genomes that is ~4 TB across
// the run while the join itself is only ~2G increments (measured: the
// 1M-genome config-5 wall was 6x the 300k one at identical nnz).  When
// the join is small relative to the strip area, the engine instead
// collects one i*n1+j key per joined pair; a radix sort + run-length
// pass then yields exactly the (row, col, count) triples emission
// needs, i-major / j-ascending, with memory traffic O(join).
//
// Same layout contract as kssd_pair_count: for column c, side-0 rows
// g0[s0[c] .. s0[c]+k0[c]) (strip-LOCAL ids) and side-1 genomes
// g1[s1[c] .. s1[c]+k1[c]) (GLOBAL ids, ascending within a run — the
// stable index build; validated on load).  Only upper-triangle pairs
// (j > diag + i) are kept, matching the emission scan's row_start.
//
// Threading: threads split the COLUMN range; thread t writes compacted
// keys at out[bound[c_lo_t]] where bound is the caller's exclusive
// prefix of the k0*k1 upper bounds (disjoint by construction), and
// reports its compacted count in counts[t].  The caller concatenates
// the T runs — order does not matter, the sort follows.

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

extern "C" void kssd_pair_collect(const int32_t *g0, const int64_t *s0,
                                  const int64_t *k0, const int32_t *g1,
                                  const int64_t *s1, const int64_t *k1,
                                  int64_t n_cols, int64_t n1, int64_t diag,
                                  const int64_t *bound, int64_t *out,
                                  int64_t *starts, int64_t *counts,
                                  int n_threads) {
    if (n_threads < 1) n_threads = 1;
    std::vector<std::thread> th;
    for (int t = 0; t < n_threads; ++t)
        th.emplace_back([&, t] {
            const int64_t c_lo = n_cols * t / n_threads;
            const int64_t c_hi = n_cols * (t + 1) / n_threads;
            int64_t *w = out + bound[c_lo];
            starts[t] = bound[c_lo];
            const int64_t *w0 = w;
            for (int64_t c = c_lo; c < c_hi; ++c) {
                const int32_t *gi = g0 + s0[c];
                const int32_t *gj = g1 + s1[c];
                const int64_t a = k0[c];
                const int64_t b = k1[c];
                for (int64_t x = 0; x < a; ++x) {
                    const int64_t i = gi[x];
                    const int64_t jmin = diag + i + 1;
                    // runs are short on the sparse path; linear trim
                    // reads the same cache lines the appends do
                    int64_t y = 0;
                    if (b > 64) {
                        y = std::lower_bound(gj, gj + b, (int32_t)jmin) - gj;
                    } else {
                        while (y < b && gj[y] < jmin)
                            ++y;
                    }
                    const int64_t base = i * n1;
                    for (; y < b; ++y)
                        *w++ = base + gj[y];
                }
            }
            counts[t] = w - w0;
        });
    for (auto &x : th) x.join();
}
