// Fisher-Yates swap application for glibc-rand shuffles.
//
// The j-sequence is computed vectorized in Python (glibc_rand.py block
// generator); only the inherently sequential swap chain runs here.
// Mirrors the reference loop (reference shuffle.cpp:95-103).

#include <cstdint>

extern "C" void kssd_fisher_yates_apply(int32_t *arr, int64_t n,
                                        const int32_t *js) {
    // js[idx] is j for i = n-1-idx, idx in [0, n-1)
    for (int64_t idx = 0; idx < n - 1; ++idx) {
        int64_t i = n - 1 - idx;
        int32_t j = js[idx];
        int32_t t = arr[i];
        arr[i] = arr[j];
        arr[j] = t;
    }
}
