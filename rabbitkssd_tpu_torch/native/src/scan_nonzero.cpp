// Upper-triangle nonzero gather over a counts strip: the candidate
// scan feeding distance-row emission (reference dist.cpp:206-256 walks
// its count rows the same way).  np.nonzero over the [rows, n] strip
// was the measured emission wall at 100k-genome scale (single-threaded
// scan + a separate triangle filter + a separate value gather); these
// two passes run multithreaded at memory speed and emit only the
// in-triangle entries, already i-major with j ascending (the
// reference's deterministic row order).
//
// Row r of the strip holds global genome diag + r (diag = i0 + g0 of
// the caller's row group); entries with j <= diag + r are not
// emission-candidates, so the scan starts at j = diag + r + 1
// (diag < 0 scans full rows — the rectangular ref-vs-query layout).
//
// Threading contract: callers pass n_threads; ctypes releases the GIL.

#include <cstdint>
#include <thread>
#include <vector>

namespace {

struct Span {
    int64_t lo, hi;
};

static std::vector<Span> split(int64_t n, int t) {
    std::vector<Span> s(t);
    for (int i = 0; i < t; ++i)
        s[i] = {n * i / t, n * (i + 1) / t};
    return s;
}

static inline int64_t row_start(int64_t diag, int64_t r, int64_t n) {
    int64_t j0 = diag < 0 ? 0 : diag + r + 1;
    return j0 < n ? j0 : n;
}

}  // namespace

// Pass 1: per-row nonzero counts (disjoint writes, no reduction).
extern "C" void kssd_scan_count(const int32_t *blk, int64_t rows, int64_t n,
                                int64_t diag, int64_t *row_counts,
                                int n_threads) {
    if (n_threads < 1) n_threads = 1;
    auto spans = split(rows, n_threads);
    std::vector<std::thread> th;
    for (int t = 0; t < n_threads; ++t)
        th.emplace_back([&, t] {
            for (int64_t r = spans[t].lo; r < spans[t].hi; ++r) {
                const int32_t *row = blk + r * n;
                int64_t c = 0;
                for (int64_t j = row_start(diag, r, n); j < n; ++j)
                    c += row[j] != 0;
                row_counts[r] = c;
            }
        });
    for (auto &x : th) x.join();
}

// Pass 2: gather (row, col, value) triples; row r's triples land at
// [row_starts[r], row_starts[r] + row_counts[r]) — the exclusive
// prefix sum the caller computed from pass 1, making thread writes
// disjoint and the output globally i-major / j-ascending.
extern "C" void kssd_scan_fill(const int32_t *blk, int64_t rows, int64_t n,
                               int64_t diag, const int64_t *row_starts,
                               int32_t *ii, int32_t *jj, int32_t *vv,
                               int n_threads) {
    if (n_threads < 1) n_threads = 1;
    auto spans = split(rows, n_threads);
    std::vector<std::thread> th;
    for (int t = 0; t < n_threads; ++t)
        th.emplace_back([&, t] {
            for (int64_t r = spans[t].lo; r < spans[t].hi; ++r) {
                const int32_t *row = blk + r * n;
                int64_t w = row_starts[r];
                for (int64_t j = row_start(diag, r, n); j < n; ++j) {
                    const int32_t v = row[j];
                    if (v != 0) {
                        ii[w] = int32_t(r);
                        jj[w] = int32_t(j);
                        vv[w] = v;
                        ++w;
                    }
                }
            }
        });
    for (auto &x : th) x.join();
}
