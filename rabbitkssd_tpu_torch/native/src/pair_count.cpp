// Posting-list intersection counting: the reference's distance hot loop
// (reference dist.cpp:174-204 — for each hash, bump the
// counter of every genome sharing it) as a native kernel over the
// column-join layout the Python engine already builds.
//
// Layout (from ops/distance.py _join_layout): for each shared column c,
// side 0 holds genome ids g0[s0[c] .. s0[c]+k0[c]) and side 1
// g1[s1[c] .. s1[c]+k1[c]); every cross pair (i, j) increments
// out[i * n1 + j].  numpy's add.at does ~3.6M increments/s; this loop
// runs at memory speed (hundreds of M/s).
//
// Parallelism contract: different columns may hit the SAME (i, j), so
// threads split the OUTPUT ROW SPACE instead (the reference's
// per-thread privatized counter rows, dist.cpp:143, without the copy):
// each caller thread passes a disjoint [row_lo, row_hi) and walks all
// columns, touching only its own rows — no atomics, no false sharing
// beyond row boundaries.  ctypes releases the GIL for the call.

#include <algorithm>
#include <cstdint>

// col_lo: skip all side-1 genomes < col_lo (upper-triangle alldist
// strips only emit j > i >= col_lo; gj runs are gid-ascending — the
// stable index sort — so one lower_bound per column trims the join).
extern "C" void kssd_pair_count(const int32_t *g0, const int64_t *s0,
                                const int64_t *k0, const int32_t *g1,
                                const int64_t *s1, const int64_t *k1,
                                int64_t n_cols, int32_t *out, int64_t n1,
                                int32_t row_lo, int32_t row_hi,
                                int32_t col_lo) {
    for (int64_t c = 0; c < n_cols; ++c) {
        const int32_t *gi = g0 + s0[c];
        const int32_t *gj = g1 + s1[c];
        const int64_t a = k0[c];
        const int64_t b = k1[c];
        // lazy trim: only a thread that OWNS a row of this column ever
        // touches gj (an eager per-column lower_bound is a random
        // cache miss paid n_cols x n_threads times — measured 2x the
        // whole walk at 100k-genome scale); short runs trim by linear
        // scan since the increments read the same cache lines anyway
        int64_t y0 = col_lo > 0 ? -1 : 0;
        for (int64_t x = 0; x < a; ++x) {
            const int32_t i = gi[x];
            if (i < row_lo || i >= row_hi)
                continue;
            if (y0 < 0) {
                if (b > 64) {
                    y0 = std::lower_bound(gj, gj + b, col_lo) - gj;
                } else {
                    y0 = 0;
                    while (y0 < b && gj[y0] < col_lo)
                        ++y0;
                }
                if (y0 == b)
                    break;
            }
            int32_t *row = out + (int64_t)i * n1;
            for (int64_t y = y0; y < b; ++y)
                row[gj[y]]++;
        }
    }
}
