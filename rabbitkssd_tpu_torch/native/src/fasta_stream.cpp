// Stateful chunked FASTA/FASTQ(.gz) -> 2-bit code streaming.
//
// Handle-based variant of fasta_codes.cpp for multi-GB inputs (the
// mammal/metagenome configs): the caller pulls bounded chunks of the
// code tape instead of materializing whole files — the streaming role
// of the RabbitFX chunked producer (reference sketch.cpp:
// 396-410).  FASTA records stream straight through; FASTQ records are
// staged per record so the trailing quality section can invalidate
// low-quality bases (reference sketch.cpp:795) before emission (reads
// are short, so staging is cheap).
//
// Line bodies are processed in BULK (memchr to the next newline + a
// branch-free table-map loop over the segment); the per-char state
// machine only classifies line starts — see fasta_codes.cpp.
//
// Semantics identical to kssd_fasta_codes: BaseMap 2-bit codes, -1 for
// invalid, one -1 separator between records, no trailing separator.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>
#include <zlib.h>

namespace {

int8_t BASE_MAP2[256];
struct MapInit2 {
    MapInit2() {
        memset(BASE_MAP2, -1, sizeof BASE_MAP2);
        BASE_MAP2['A'] = BASE_MAP2['a'] = 0;
        BASE_MAP2['C'] = BASE_MAP2['c'] = 1;
        BASE_MAP2['G'] = BASE_MAP2['g'] = 2;
        BASE_MAP2['T'] = BASE_MAP2['t'] = 3;
    }
} map_init2;

constexpr int RCHUNK = 1 << 20;

struct Reader {
    gzFile f = nullptr;
    int least_qual = 0;
    // raw input buffer
    char *buf = nullptr;
    int buf_len = 0;
    int buf_pos = 0;
    bool eof = false;
    // parser state
    bool any_record = false;
    bool in_record = false;
    bool in_qual = false;
    bool is_fastq_record = false;
    bool at_line_start = true;
    int line_kind = 0;
    int64_t seq_len = 0;
    int64_t qual_len = 0;
    std::vector<int8_t> staged;  // current fastq record's codes
    // pending output not yet taken by the caller
    std::vector<int8_t> carry;
    int64_t carry_pos = 0;
};

bool refill(Reader *r) {
    if (r->eof) return false;
    r->buf_len = gzread(r->f, r->buf, RCHUNK);
    r->buf_pos = 0;
    if (r->buf_len <= 0) {
        r->eof = true;
        return false;
    }
    return true;
}

inline int64_t clean_run2(const char *p, int64_t len) {
    const char *cr = static_cast<const char *>(memchr(p, '\r', len));
    return cr ? cr - p : len;
}

}  // namespace

extern "C" {

void *kssd_fasta_open(const char *path, int least_qual) {
    gzFile f = gzopen(path, "rb");
    if (!f) return nullptr;
    gzbuffer(f, 1 << 20);
    auto *r = new Reader();
    r->f = f;
    r->least_qual = least_qual;
    r->buf = static_cast<char *>(malloc(RCHUNK));
    return r;
}

void kssd_fasta_close(void *h) {
    auto *r = static_cast<Reader *>(h);
    if (!r) return;
    gzclose(r->f);
    free(r->buf);
    delete r;
}

// Fill out[0..cap) with the next codes; returns count (0 = EOF).
int64_t kssd_fasta_read_codes(void *h, int8_t *out, int64_t cap) {
    auto *r = static_cast<Reader *>(h);
    int64_t n = 0;

    auto emit = [&](int8_t code) {
        if (n < cap) out[n++] = code;
        else r->carry.push_back(code);
    };
    // mapped bulk emission of `len` raw bytes
    auto emit_mapped = [&](const char *src, int64_t len) {
        int64_t direct = cap - n;
        if (direct > len) direct = len;
        for (int64_t k = 0; k < direct; ++k)
            out[n + k] = BASE_MAP2[(unsigned char)src[k]];
        n += direct;
        if (direct < len) {
            size_t old = r->carry.size();
            r->carry.resize(old + (len - direct));
            for (int64_t k = direct; k < len; ++k)
                r->carry[old + (k - direct)] =
                    BASE_MAP2[(unsigned char)src[k]];
        }
    };
    auto flush_staged = [&]() {
        for (int8_t c : r->staged) emit(c);
        r->staged.clear();
    };

    // drain carry from a previous call first
    while (n < cap && r->carry_pos < (int64_t)r->carry.size()) {
        out[n++] = r->carry[r->carry_pos++];
    }
    if (r->carry_pos >= (int64_t)r->carry.size()) {
        r->carry.clear();
        r->carry_pos = 0;
    }

    while (n < cap) {
        if (r->buf_pos >= r->buf_len && !refill(r)) break;
        if (!r->at_line_start) {
            // ---- bulk path: the rest of this line ----
            int64_t i = r->buf_pos;
            const char *nl = static_cast<const char *>(
                memchr(r->buf + i, '\n', r->buf_len - i));
            int64_t seg_end = nl ? nl - r->buf : r->buf_len;
            int64_t run = clean_run2(r->buf + i, seg_end - i);
            if (run < seg_end - i) seg_end = i + run;  // stop at '\r'
            if (run > 0 && r->line_kind == 0 && r->in_record) {
                if (r->in_qual) {
                    int64_t remain = r->seq_len - r->qual_len;
                    int64_t apply = run < remain ? run : remain;
                    int64_t staged_n = (int64_t)r->staged.size();
                    for (int64_t k = 0; k < apply; ++k) {
                        if (r->qual_len + k < staged_n
                            && (unsigned char)r->buf[i + k]
                               < (unsigned char)r->least_qual)
                            r->staged[r->qual_len + k] = -1;
                    }
                    r->qual_len += run;
                    if (r->qual_len >= r->seq_len) {
                        r->in_qual = false;
                        r->in_record = false;
                        flush_staged();
                    }
                } else if (r->is_fastq_record) {
                    size_t old = r->staged.size();
                    r->staged.resize(old + run);
                    for (int64_t k = 0; k < run; ++k)
                        r->staged[old + k] =
                            BASE_MAP2[(unsigned char)r->buf[i + k]];
                    r->seq_len += run;
                } else {
                    emit_mapped(r->buf + i, run);
                    r->seq_len += run;
                }
            }
            r->buf_pos = (int)seg_end;
            if (r->buf_pos < r->buf_len && r->buf[r->buf_pos] == '\r') {
                ++r->buf_pos;
                continue;
            }
            if (r->buf_pos < r->buf_len) {  // consume '\n'
                ++r->buf_pos;
                r->at_line_start = true;
            }
            continue;
        }
        // ---- per-char path: the first char of a line ----
        unsigned char ch = r->buf[r->buf_pos];
        if (ch == '\n') { r->at_line_start = true; ++r->buf_pos; continue; }
        if (ch == '\r') { ++r->buf_pos; continue; }
        r->at_line_start = false;
        if (r->in_qual && r->qual_len >= r->seq_len) {
            // quality already complete (e.g. empty record): close it
            r->in_qual = false;
            r->in_record = false;
            flush_staged();
        }
        if (r->in_qual) {
            r->line_kind = 0;  // quality data line (bulk handles it)
        } else if (ch == '>' || ch == '@') {
            r->line_kind = 1;
            if (r->any_record) emit(-1);  // record separator
            r->any_record = true;
            r->in_record = true;
            r->is_fastq_record = (ch == '@');
            r->seq_len = 0;
            r->staged.clear();
            ++r->buf_pos;
        } else if (ch == '+' && r->in_record && !r->in_qual) {
            // kseq semantics: '+' starts quality for any record
            // type; for streamed '>' records the bases are already
            // emitted so quality can only be consumed, not applied
            r->line_kind = 2;
            r->in_qual = true;
            r->qual_len = 0;
            ++r->buf_pos;
        } else {
            r->line_kind = 0;  // sequence line (bulk handles it)
        }
    }
    // EOF with staged bases (missing or partial quality): flush —
    // kseq keeps such records (partial quality applied as far as read)
    if (n < cap && r->eof && r->buf_pos >= r->buf_len
        && !r->staged.empty()) {
        flush_staged();
        r->in_record = false;
        r->in_qual = false;
    }
    return n;
}

}  // extern "C"
