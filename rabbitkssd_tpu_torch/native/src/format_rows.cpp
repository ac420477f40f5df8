// Exact distance-row text emission (the reference's per-pair fprintf,
// reference dist.cpp:206-256, 591-686).
//
// Candidates arrive prefiltered (a vectorized integer-count superset);
// each row's jaccard/containment + mash/aaf distance is recomputed here
// in double with glibc libm log() — the SAME call the reference makes —
// and the final `< maxDist` (or `<=`) test applied before formatting.
// "%.6f" is glibc's correctly-rounded conversion, byte-identical to
// both std::to_string (reference, dist.cpp:233) and Python's format.
//
// row_len[t] receives each input row's emitted byte count (0 when the
// exact test rejects it) so the caller can slice the buffer by genome
// for the part-file index protocol.  Returns total bytes, or -1 if
// out_cap would overflow (caller sizes the buffer from name lengths).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>

namespace {

// unsigned decimal itoa, returns bytes written
static inline int put_u(char *p, uint64_t v) {
    char tmp[20];
    int k = 0;
    do {
        tmp[k++] = char('0' + v % 10);
        v /= 10;
    } while (v);
    for (int x = 0; x < k; ++x)
        p[x] = tmp[k - 1 - x];
    return k;
}

}  // namespace

extern "C" int64_t kssd_format_rows(
    const int32_t *ii, const int32_t *jj, const int32_t *cc, int64_t n,
    const int64_t *sizes_i, const int64_t *sizes_j,
    const char *names_i, const int64_t *off_i,
    const char *names_j, const int64_t *off_j,
    int32_t kmer_size, double max_dist, int32_t containment,
    int32_t strict, int32_t order, char *out, int64_t out_cap,
    int32_t *row_len) {
    const double inv_k = -1.0 / (double)kmer_size;
    int64_t w = 0;
    for (int64_t t = 0; t < n; ++t) {
        const int64_t i = ii[t], j = jj[t];
        const int64_t c = cc[t];
        const int64_t si = sizes_i[i], sj = sizes_j[j];
        double jorc, d;
        if (containment) {
            const int64_t mn = si < sj ? si : sj;
            jorc = (si == 0 || sj == 0) ? 0.0 : (double)c / (double)mn;
            d = jorc == 1.0 ? 0.0
                : jorc == 0.0 ? 1.0
                              : inv_k * log(jorc);
        } else {
            jorc = (si == 0 || sj == 0)
                       ? 0.0
                       : (double)c / (double)(si + sj - c);
            d = jorc == 1.0 ? 0.0
                : jorc == 0.0 ? 1.0
                              : inv_k * log((2.0 * jorc) / (1.0 + jorc));
        }
        const bool pass = strict ? (d < max_dist) : (d <= max_dist);
        if (!pass) {
            row_len[t] = 0;
            continue;
        }
        // first/second name + size column order differ between the
        // alldist (order 0: name_j, name_i, c|si|sj) and dist
        // (order 1: name_i, name_j, c|sj|si) row formats
        const char *nA = order ? names_i + off_i[i] : names_j + off_j[j];
        int64_t lA = order ? off_i[i + 1] - off_i[i]
                           : off_j[j + 1] - off_j[j];
        const char *nB = order ? names_j + off_j[j] : names_i + off_i[i];
        int64_t lB = order ? off_j[j + 1] - off_j[j]
                           : off_i[i + 1] - off_i[i];
        const int64_t sA = order ? sj : si;
        const int64_t sB = order ? si : sj;
        if (w + lA + lB + 96 > out_cap)
            return -1;
        char *p = out + w;
        memcpy(p, nA, lA);
        p += lA;
        *p++ = '\t';
        memcpy(p, nB, lB);
        p += lB;
        *p++ = '\t';
        p += put_u(p, (uint64_t)c);
        *p++ = '|';
        p += put_u(p, (uint64_t)sA);
        *p++ = '|';
        p += put_u(p, (uint64_t)sB);
        *p++ = '\t';
        p += snprintf(p, 32, "%.6f", jorc);
        *p++ = '\t';
        p += snprintf(p, 32, "%.6f", d);
        *p++ = '\n';
        row_len[t] = (int32_t)(p - (out + w));
        w = p - out;
    }
    return w;
}
