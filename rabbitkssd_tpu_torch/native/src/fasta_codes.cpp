// Streaming FASTA/FASTQ(.gz) -> 2-bit base-code tape.
//
// Native replacement for the Python record parser + encode_concat on the
// sketching hot path — the role RabbitFX/kseq play in the reference
// (reference sketch.cpp:14-17, 401-410).  Parses records
// (multi-line FASTA, multi-line FASTQ with '+' quality sections), maps
// bases via the BaseMap table (A/a=0, C/c=1, G/g=2, T/t=3, else -1;
// reference common.h:27-37), applies the FASTQ quality threshold
// (quality byte < least_qual -> invalid, reference sketch.cpp:795), and
// separates records with a single -1 sentinel so k-mer windows never
// span records.
//
// Line bodies are processed in BULK (memchr to the next newline, then a
// branch-free table-map loop over the whole segment) — the per-char
// state machine only classifies line starts.  This is what makes the
// parser compete with the reference's kseq throughput per core.
//
// Output buffer is malloc'd here; the caller frees with kssd_free().

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <zlib.h>

namespace {

int8_t BASE_MAP[256];

struct MapInit {
    MapInit() {
        memset(BASE_MAP, -1, sizeof BASE_MAP);
        BASE_MAP['A'] = BASE_MAP['a'] = 0;
        BASE_MAP['C'] = BASE_MAP['c'] = 1;
        BASE_MAP['G'] = BASE_MAP['g'] = 2;
        BASE_MAP['T'] = BASE_MAP['t'] = 3;
    }
} map_init;

struct Buf {
    int8_t *data = nullptr;
    int64_t len = 0;
    int64_t cap = 0;
    bool grow(int64_t need) {
        if (len + need <= cap) return true;
        int64_t ncap = cap ? cap : (1 << 20);
        while (ncap < len + need) ncap *= 2;
        auto *nd = static_cast<int8_t *>(realloc(data, ncap));
        if (!nd) return false;
        data = nd;
        cap = ncap;
        return true;
    }
};

// Length of the bulk-processable prefix of [p, p+len): stops before the
// first '\r' (rare; handled per-char to preserve skip semantics).
inline int64_t clean_run(const char *p, int64_t len) {
    const char *cr = static_cast<const char *>(memchr(p, '\r', len));
    return cr ? cr - p : len;
}

}  // namespace

extern "C" {

void kssd_free(void *p) { free(p); }

// Returns 0 on success. *out_codes/*out_len: the code tape.
int kssd_fasta_codes(const char *path, int least_qual, int8_t **out_codes,
                     int64_t *out_len) {
    *out_codes = nullptr;
    *out_len = 0;
    gzFile f = gzopen(path, "rb");
    if (!f) return 1;
    gzbuffer(f, 1 << 20);

    Buf out;
    // parser state
    bool any_record = false;
    bool in_record = false;
    bool in_qual = false;
    int64_t seq_len = 0;     // bases of current record emitted
    int64_t seq_start = 0;   // offset in out.data of current record
    int64_t qual_len = 0;

    constexpr int CHUNK = 1 << 20;
    char *buf = static_cast<char *>(malloc(CHUNK));
    if (!buf) { gzclose(f); return 2; }
    bool at_line_start = true;
    int line_kind = 0;  // 0 seq, 1 header, 2 plus(quality intro)

    int n;
    while ((n = gzread(f, buf, CHUNK)) > 0) {
        int64_t i = 0;
        while (i < n) {
            unsigned char ch = buf[i];
            if (!at_line_start) {
                // ---- bulk path: the rest of this line ----
                const char *nl = static_cast<const char *>(
                    memchr(buf + i, '\n', n - i));
                int64_t seg_end = nl ? nl - buf : n;
                int64_t run = clean_run(buf + i, seg_end - i);
                if (run < seg_end - i) seg_end = i + run;  // stop at '\r'
                if (run > 0) {
                    if (line_kind == 0 && in_record) {
                        if (in_qual) {
                            int64_t remain = seq_len - qual_len;
                            int64_t apply = run < remain ? run : remain;
                            for (int64_t k = 0; k < apply; ++k) {
                                if ((unsigned char)buf[i + k]
                                    < (unsigned char)least_qual)
                                    out.data[seq_start + qual_len + k] = -1;
                            }
                            qual_len += run;
                            if (qual_len >= seq_len) {
                                in_qual = false;
                                in_record = false;
                            }
                        } else {
                            if (!out.grow(run)) {
                                free(buf); gzclose(f); return 2;
                            }
                            int8_t *dst = out.data + out.len;
                            for (int64_t k = 0; k < run; ++k)
                                dst[k] = BASE_MAP[(unsigned char)buf[i + k]];
                            out.len += run;
                            seq_len += run;
                        }
                    }
                    // header/plus lines and out-of-record bytes: skipped
                }
                i = seg_end;
                if (i < n && buf[i] == '\r') { ++i; continue; }
                if (i < n) { ++i; at_line_start = true; }  // consume '\n'
                continue;
            }
            // ---- per-char path: the first char of a line ----
            if (ch == '\n') { at_line_start = true; ++i; continue; }
            if (ch == '\r') { ++i; continue; }
            at_line_start = false;
            if (in_qual && qual_len >= seq_len) {
                // quality already complete (e.g. empty record):
                // close it and reprocess this char as a fresh line
                in_qual = false;
                in_record = false;
            }
            if (in_qual) {
                line_kind = 0;  // quality data line (bulk handles it)
                continue;       // re-enter bulk with the same char
            } else if (ch == '>' || ch == '@') {
                line_kind = 1;
                if (any_record) {  // one separator per record boundary
                    if (!out.grow(1)) { free(buf); gzclose(f); return 2; }
                    out.data[out.len++] = -1;
                }
                any_record = true;
                in_record = true;
                seq_len = 0;
                seq_start = out.len;
                ++i;
                continue;
            } else if (ch == '+' && in_record && !in_qual) {
                line_kind = 2;
                in_qual = true;
                qual_len = 0;
                ++i;
                continue;
            } else {
                line_kind = 0;
                continue;  // re-enter bulk with the same char
            }
        }
    }
    free(buf);
    gzclose(f);
    if (n < 0) { free(out.data); return 3; }
    *out_codes = out.data;
    *out_len = out.len;
    return 0;
}

}  // extern "C"
