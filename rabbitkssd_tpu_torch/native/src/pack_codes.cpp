// 2-bit packing of base-code tapes + packed whole-file parsing.
//
// The round-1 feeder parsed natively but then 2-bit-packed and
// exception-extracted in single-threaded numpy on the Python feeder
// thread — measured as the sketch pipeline's wall (~60 Mbase/s fed vs
// ~3x device capacity).  These entry points move that work into the
// native pass, the role RabbitFX's consumer threads play in the
// reference (reference sketch.cpp:396-410): one C++ sweep
// emits the u32 packed word stream (base i at bits 2*(i%16) of word
// i/16, the layout ops/kmer.py:hash_windows_stream consumes) plus the
// flat positions of invalid bases (N runs, low-quality, separators),
// so Python only does word-level slicing.
//
// All buffers are malloc'd here; the caller frees with kssd_free().

#include <cstdint>
#include <cstdlib>
#include <cstring>

extern "C" {

// from fasta_codes.cpp
int kssd_fasta_codes(const char *path, int least_qual, int8_t **out_codes,
                     int64_t *out_len);

// Pack an int8 code array (-1 = invalid) into 2-bit u32 words.
// out_words must hold ceil(n/16) words (tail bits of a partial final
// word are zero).  *out_exc receives a malloc'd int32 array of the flat
// positions of invalid codes (their packed bits are 0); *out_n_exc its
// length.  Returns 0 on success.
int kssd_pack_codes(const int8_t *codes, int64_t n, uint32_t *out_words,
                    int32_t **out_exc, int64_t *out_n_exc) {
    *out_exc = nullptr;
    *out_n_exc = 0;
    int64_t n_words = (n + 15) / 16;
    int64_t n_exc = 0;
    int64_t exc_cap = 0;
    int32_t *exc = nullptr;

    for (int64_t w = 0; w < n_words; ++w) {
        int64_t base = w * 16;
        int lim = (int)(n - base < 16 ? n - base : 16);
        uint32_t word = 0;
        for (int t = 0; t < lim; ++t) {
            int8_t c = codes[base + t];
            if (c < 0) {
                if (n_exc == exc_cap) {
                    exc_cap = exc_cap ? exc_cap * 2 : 1024;
                    auto *ne = static_cast<int32_t *>(
                        realloc(exc, exc_cap * sizeof(int32_t)));
                    if (!ne) { free(exc); return 2; }
                    exc = ne;
                }
                exc[n_exc++] = (int32_t)(base + t);
            } else {
                word |= (uint32_t)c << (2 * t);
            }
        }
        out_words[w] = word;
    }
    *out_exc = exc;
    *out_n_exc = n_exc;
    return 0;
}

// Whole-file parse + pack in one call: FASTA/FASTQ(.gz) -> packed word
// stream + exception positions.  Semantics of the code tape are those
// of kssd_fasta_codes (BaseMap 2-bit codes, quality threshold, one -1
// separator between records).  Returns 0 on success.
int kssd_fasta_packed(const char *path, int least_qual,
                      uint32_t **out_words, int64_t *out_n_bases,
                      int32_t **out_exc, int64_t *out_n_exc) {
    *out_words = nullptr;
    *out_n_bases = 0;
    *out_exc = nullptr;
    *out_n_exc = 0;
    int8_t *codes = nullptr;
    int64_t n = 0;
    int rc = kssd_fasta_codes(path, least_qual, &codes, &n);
    if (rc != 0) return rc;
    int64_t n_words = (n + 15) / 16;
    auto *words = static_cast<uint32_t *>(
        malloc((n_words ? n_words : 1) * sizeof(uint32_t)));
    if (!words) { free(codes); return 2; }
    rc = kssd_pack_codes(codes, n, words, out_exc, out_n_exc);
    free(codes);
    if (rc != 0) { free(words); return rc; }
    *out_words = words;
    *out_n_bases = n;
    return 0;
}

}  // extern "C"
