// Split-and-verify chunked FASTA/FASTQ(.gz) reader: the code tape of the
// sequential chunked reader it replaces (kssd_fasta_read_codes, which the
// JAX package keeps in rabbitkssd_tpu/native/src/fasta_stream.cpp, and
// the tests hold this reader to), byte for byte, parsed on several
// threads and handed out as 2-bit packed chunks (kssd_pack_codes'
// layout, native/src/pack_codes.cpp).  The sketcher streams every file
// over its threshold (1 GiB) through it, one file at a time, on the
// threads its budget gives (engine/sketcher.py:DeviceSketcher.sketch_files).
//
// A plain file is read with pread by every worker, a piece at a time; a
// gzipped one is inflated a block at a time on the calling thread and
// parsed from memory.  The rule, for each block:
//
// 1. Cuts.  The stream is cut every `range` bytes.  A cut moves forward
//    to the next line start if one lies within the next min(range, 64
//    KiB) bytes, else it stays inside the line.  A block is T ranges.
// 2. Speculation.  Each range is parsed on its own thread from an
//    assumed state: inside a FASTA record's sequence, no quality
//    pending, a record already seen; at a line start or inside a
//    sequence line, as its cut says.  The parse stops at the first line
//    that starts with '@' or '+', whose meaning depends on state it
//    cannot know (a FASTQ record, kseq's quality section after '+').
// 3. Verification, in file order.  A range's codes are kept if the true
//    state at its start (the previous range's end) is the assumed one,
//    or if its first line is a '>' header and no quality is pending: a
//    header resets the state, and its separator is dropped where no
//    record came before (the file's start).  Any other range is parsed
//    again, sequentially, from the true state.  So the output is the
//    sequential reader's on every input: FASTQ, '+' lines in FASTA, a
//    range that starts in a header or a quality section, the file's
//    first range.
// 4. Pack and stitch.  Each worker packs its codes as it parses them, a
//    piece at a time while they are in its cache, into words aligned to
//    its range's start.  Once the ranges' code counts are known, each
//    range's words are shifted into place on a tape of words behind the
//    last block's leftover (one thread a range; the words two ranges
//    share are or-ed), and a chunk is a copy of the tape's words.
//
// Counters: stream_bytes (bytes parsed) and split_bytes (bytes of the
// ranges whose speculative parse was kept).
//
// Memory, T threads of `range` bytes: each range's packed words (at most
// range / 4 bytes), a 1 MiB piece of the file and its codes; the tape, a
// block's words (T x range / 4) behind the chunk not yet handed out; 8
// bytes for each invalid base of a block; and for a .gz file the inflated
// block (T x range).

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <fcntl.h>
#include <sys/stat.h>
#include <system_error>
#include <thread>
#include <unistd.h>
#include <vector>
#include <zlib.h>

namespace {

int8_t MAP[256];
struct MapInit {
    MapInit() {
        memset(MAP, -1, sizeof MAP);
        MAP['A'] = MAP['a'] = 0;
        MAP['C'] = MAP['c'] = 1;
        MAP['G'] = MAP['g'] = 2;
        MAP['T'] = MAP['t'] = 3;
    }
} map_init;

constexpr int64_t PIECE = 1 << 20;       // bytes a worker parses at a time
constexpr int64_t CUT_WINDOW = 1 << 16;  // how far a cut looks for a line

// The sequential reader's parser state (its Reader).
struct State {
    bool any_record = false;
    bool in_record = false;
    bool in_qual = false;
    bool is_fastq = false;
    bool at_line_start = true;
    int line_kind = 0;  // 0 sequence or quality, 1 header, 2 '+'
    int64_t seq_len = 0;
    int64_t qual_len = 0;
    std::vector<int8_t> staged;  // the open FASTQ record's codes
};

// The state a range's speculative parse assumes.
State assumed(bool at_line_start) {
    State s;
    s.any_record = s.in_record = true;
    s.at_line_start = at_line_start;
    return s;
}

// Whether the true state `x` is the state assumed at a range's start.
bool holds(const State &x, bool at_line_start) {
    return x.any_record && x.in_record && !x.in_qual && !x.is_fastq
        && x.at_line_start == at_line_start
        && (at_line_start || x.line_kind == 0);
}

struct Codes {
    std::vector<int8_t> v;
    int64_t n = 0;
    int8_t *room(int64_t k) {
        if (n + k > (int64_t)v.size())
            v.resize(std::max<int64_t>(n + k, 2 * (int64_t)v.size()));
        return v.data() + n;
    }
};

// What a speculative parse saw.
struct Spec {
    bool started = false;      // met its first non-empty line start
    bool lead_header = false;  // ... and it was a '>' header
    bool saw_header = false;
};

// Parse [p, p + len) from `s`, appending codes to `out`: the sequential
// reader's state machine.  With `spec`, stop at the first line that
// starts with '@' or '+' and return false.
bool parse(State &s, const char *p, int64_t len, int least_qual,
           Codes &out, Spec *spec) {
    auto flush = [&]() {
        int64_t k = (int64_t)s.staged.size();
        memcpy(out.room(k), s.staged.data(), k);
        out.n += k;
        s.staged.clear();
    };
    int64_t i = 0;
    while (i < len) {
        if (!s.at_line_start) {
            // the rest of this line, in bulk, up to a '\r' or '\n'
            const char *nl = static_cast<const char *>(
                memchr(p + i, '\n', len - i));
            int64_t seg_end = nl ? nl - p : len;
            const char *cr = static_cast<const char *>(
                memchr(p + i, '\r', seg_end - i));
            if (cr) seg_end = cr - p;
            int64_t run = seg_end - i;
            if (run > 0 && s.line_kind == 0 && s.in_record) {
                if (s.in_qual) {
                    int64_t remain = s.seq_len - s.qual_len;
                    int64_t apply = run < remain ? run : remain;
                    int64_t staged_n = (int64_t)s.staged.size();
                    for (int64_t k = 0; k < apply; ++k) {
                        if (s.qual_len + k < staged_n
                            && (unsigned char)p[i + k]
                               < (unsigned char)least_qual)
                            s.staged[s.qual_len + k] = -1;
                    }
                    s.qual_len += run;
                    if (s.qual_len >= s.seq_len) {
                        s.in_qual = false;
                        s.in_record = false;
                        flush();
                    }
                } else if (s.is_fastq) {
                    size_t old = s.staged.size();
                    s.staged.resize(old + run);
                    for (int64_t k = 0; k < run; ++k)
                        s.staged[old + k] = MAP[(unsigned char)p[i + k]];
                    s.seq_len += run;
                } else {
                    int8_t *d = out.room(run);
                    for (int64_t k = 0; k < run; ++k)
                        d[k] = MAP[(unsigned char)p[i + k]];
                    out.n += run;
                    s.seq_len += run;
                }
            }
            i = seg_end;
            if (i < len && p[i] == '\r') { ++i; continue; }
            if (i < len) {  // consume '\n'
                ++i;
                s.at_line_start = true;
            }
            continue;
        }
        // the first byte of a line
        unsigned char ch = p[i];
        if (ch == '\n' || ch == '\r') { ++i; continue; }
        if (spec) {
            if (ch == '@' || ch == '+') return false;
            if (!spec->started) {
                spec->started = true;
                spec->lead_header = ch == '>';
            }
        }
        s.at_line_start = false;
        if (s.in_qual && s.qual_len >= s.seq_len) {
            // quality already complete (e.g. empty record): close it
            s.in_qual = false;
            s.in_record = false;
            flush();
        }
        if (s.in_qual) {
            s.line_kind = 0;  // quality line (bulk handles it)
        } else if (ch == '>' || ch == '@') {
            s.line_kind = 1;
            if (s.any_record) {
                *out.room(1) = -1;
                ++out.n;
            }
            s.any_record = s.in_record = true;
            s.is_fastq = ch == '@';
            s.seq_len = 0;
            s.staged.clear();
            if (spec) spec->saw_header = true;
            ++i;
        } else if (ch == '+' && s.in_record) {
            // kseq: '+' starts quality for any record type
            s.line_kind = 2;
            s.in_qual = true;
            s.qual_len = 0;
            ++i;
        } else {
            s.line_kind = 0;  // sequence line (bulk handles it)
        }
    }
    return true;
}

// Eight 2-bit codes a byte apart (none invalid) -> 16 contiguous bits.
inline uint32_t gather8(uint64_t x) {
    x &= 0x0303030303030303ULL;
    x = (x | x >> 6) & 0x000F000F000F000FULL;
    x = (x | x >> 12) & 0x000000FF000000FFULL;
    return (uint32_t)((x | x >> 24) & 0xFFFF);
}

// Run f(0..n-1) on n threads, f(0) on the calling one (and any whose
// thread cannot be started).
template <class F>
void run_parallel(int n, F f) {
    std::vector<std::thread> th;
    std::vector<int> here = {0};
    for (int i = 1; i < n; ++i) {
        try {
            th.emplace_back(f, i);
        } catch (const std::system_error &) {
            here.push_back(i);
        }
    }
    if (n > 0)
        for (int i : here) f(i);
    for (auto &t : th) t.join();
}

struct Range {
    int64_t lo = 0, hi = 0;
    bool line_start = true;  // its cut lies at a line start
    Spec spec;
    State end;
    bool parsed = false;  // the speculative parse ran to its end
    bool io_ok = true;
    std::vector<char> scratch;  // a piece of the file
    Codes codes;                // a piece's codes
    // the range's codes packed from its start: base i at bits 2 (i % 16)
    // of word i / 16, and the positions of the invalid ones
    std::vector<uint32_t> words;
    int64_t n = 0;
    std::vector<int64_t> exc;

    void reset() {
        n = 0;
        exc.clear();
    }

    // Pack k more codes.
    void append(const int8_t *c, int64_t k) {
        int64_t need = (n + k + 15) / 16;
        if ((int64_t)words.size() < need)
            words.resize(std::max<int64_t>(need, 2 * words.size()));
        uint32_t *w = words.data();
        int64_t i = 0, p = n;
        auto one = [&](int64_t at, int8_t v) {
            if (v < 0) exc.push_back(at);
            else w[at >> 4] |= (uint32_t)v << (2 * (at & 15));
        };
        for (; i < k && (p & 15); ++i, ++p) one(p, c[i]);
        for (; k - i >= 16; i += 16, p += 16) {
            uint64_t a, b;
            memcpy(&a, c + i, 8);
            memcpy(&b, c + i + 8, 8);
            if (((a | b) & 0x8080808080808080ULL) == 0) {
                w[p >> 4] = gather8(a) | gather8(b) << 16;
                continue;
            }
            w[p >> 4] = 0;
            for (int t = 0; t < 16; ++t) one(p + t, c[i + t]);
        }
        if (i < k) w[p >> 4] = 0;
        for (; i < k; ++i, ++p) one(p, c[i]);
        n = p;
    }

    // Drop the first code (an invalid one: a separator).
    void drop_first() {
        int64_t nw = (n + 15) / 16;
        for (int64_t j = 0; j < nw; ++j)
            words[j] = words[j] >> 2
                | (j + 1 < nw ? words[j + 1] << 30 : 0);
        exc.erase(exc.begin());
        for (int64_t &e : exc) --e;
        --n;
    }
};

struct Split {
    int least_qual = 0;
    int threads = 1;
    int64_t range = 0;
    // source: a plain file read with pread, or an inflated gzip stream
    int fd = -1;
    gzFile gz = nullptr;
    int64_t size = -1;  // known from the start (plain) or at EOF (gz)
    std::vector<char> raw;  // gz: inflated bytes from raw_lo
    int64_t raw_lo = 0, raw_n = 0;
    // parse
    State state;
    int64_t cut = 0;  // where the next block starts
    bool cut_line_start = true;
    int64_t nominal = 0;  // index of the next block's first nominal cut
    bool done = false;
    bool failed = false;
    std::vector<Range> ranges;
    // the tape: packed words from word `base` to code `total`, and the
    // invalid positions from `emitted`, the first code not handed out
    std::vector<uint32_t> tape;
    int64_t base = 0, total = 0, emitted = 0;
    std::vector<int64_t> exc_tape;
    size_t exc_pos = 0;
    std::vector<int32_t> exc;  // the last chunk's
    int64_t stream_bytes = 0, split_bytes = 0;

    // The stream's bytes [off, off + len): into raw (gz) or `scratch`.
    const char *view(int64_t off, int64_t len, std::vector<char> &scratch,
                     bool &ok) {
        if (gz) return raw.data() + (off - raw_lo);
        if ((int64_t)scratch.size() < len) scratch.resize(len);
        for (int64_t got = 0; got < len;) {
            ssize_t r = pread(fd, scratch.data() + got, len - got, off + got);
            if (r <= 0) { ok = false; return scratch.data(); }
            got += r;
        }
        return scratch.data();
    }

    // gz: hold the inflated bytes [lo, hi), or to EOF.
    bool inflate_to(int64_t lo, int64_t hi) {
        if (lo > raw_lo) {
            int64_t drop = std::min(lo - raw_lo, raw_n);
            memmove(raw.data(), raw.data() + drop, raw_n - drop);
            raw_lo += drop;
            raw_n -= drop;
        }
        while (size < 0 && raw_lo + raw_n < hi) {
            int64_t want = std::min<int64_t>(hi - raw_lo - raw_n, 1 << 30);
            if ((int64_t)raw.size() < raw_n + want) raw.resize(raw_n + want);
            int got = gzread(gz, raw.data() + raw_n, (unsigned)want);
            if (got < 0) return false;
            if (got == 0) size = raw_lo + raw_n;
            raw_n += got;
        }
        return true;
    }

    // The cut at nominal offset c, and whether it lies at a line start.
    int64_t cut_at(int64_t c, bool &line_start, Range &rg) {
        line_start = false;
        if (size >= 0 && c >= size) return size;
        int64_t lo = c - 1;
        int64_t n = std::min(std::min(range, CUT_WINDOW),
                             (gz ? raw_lo + raw_n : size) - lo);
        const char *p = view(lo, n, rg.scratch, rg.io_ok);
        if (!rg.io_ok) return c;
        const char *nl = static_cast<const char *>(memchr(p, '\n', n));
        if (!nl) return c;
        line_start = true;
        return lo + (nl - p) + 1;
    }

    // Parse and pack [lo, hi) from `s`; false if a speculative parse
    // stopped or a read failed.
    bool parse_range(Range &rg, State &s, Spec *spec) {
        rg.reset();
        for (int64_t off = rg.lo; off < rg.hi; off += PIECE) {
            int64_t len = std::min(PIECE, rg.hi - off);
            const char *p = view(off, len, rg.scratch, rg.io_ok);
            if (!rg.io_ok) return false;
            rg.codes.n = 0;
            bool ok = parse(s, p, len, least_qual, rg.codes, spec);
            rg.append(rg.codes.v.data(), rg.codes.n);
            if (!ok) return false;
        }
        return true;
    }

    // Make the tapes hold codes to `upto`: drop what was handed out.
    void grow_tape(int64_t upto) {
        exc_tape.erase(exc_tape.begin(), exc_tape.begin() + exc_pos);
        exc_pos = 0;
        int64_t first = emitted / 16;  // chunks are whole words
        int64_t keep = (total + 15) / 16 - first;
        if (first > base) {
            memmove(tape.data(), tape.data() + (first - base),
                    keep * sizeof(uint32_t));
            base = first;
        }
        int64_t need = (upto + 15) / 16 - base;
        if ((int64_t)tape.size() < need) tape.resize(need);
    }

    // Zero the words that range rg, from code g, may share with another
    // range, unless they hold codes already on the tape.
    void zero_ends(const Range &rg, int64_t g) {
        if (rg.n == 0) return;
        uint32_t *t = tape.data() - base;  // indexed by tape word
        int64_t held = total % 16 ? total / 16 : -1;
        for (int64_t gw : {g >> 4, (g + rg.n - 1) >> 4})
            if (gw != held) t[gw] = 0;
    }

    // Put range rg's words onto the tape from code g, after zero_ends:
    // shifted into place, or-ed into the two words it may share.
    void place(const Range &rg, int64_t g) {
        if (rg.n == 0) return;
        uint32_t *t = tape.data() - base;
        const uint32_t *w = rg.words.data();
        int64_t q = g >> 4, last = (g + rg.n - 1) >> 4;
        int64_t nw = (rg.n + 15) / 16;
        int sh = 2 * (int)(g & 15);
        for (int64_t gw = q; gw <= last; ++gw) {
            int64_t j = gw - q;
            uint32_t v = j < nw ? w[j] << sh : 0;
            if (sh && j > 0) v |= w[j - 1] >> (32 - sh);
            // the first and last words may be another range's too
            if (gw == q || gw == last)
                __atomic_fetch_or(&t[gw], v, __ATOMIC_RELAXED);
            else
                t[gw] = v;
        }
    }

    // Parse the next block onto the tape; false on a read error.
    bool next_block() {
        int T = threads;
        int64_t end = (nominal + T) * range;  // the block's nominal end
        if (gz && !inflate_to(cut, end - 1 + std::min(range, CUT_WINDOW)))
            return false;
        if (size >= 0 && cut >= size) {
            finish();
            return true;
        }
        // cuts: range r is [cut r, cut r + 1); a window no wider than a
        // range keeps them in order
        ranges[0].lo = cut;
        ranges[0].line_start = cut_line_start;
        std::vector<int> live;  // the ranges that hold bytes
        for (int r = 0; r < T; ++r) {
            Range &rg = ranges[r];
            bool ls;
            rg.hi = cut_at((nominal + r + 1) * range, ls, rg);
            if (!rg.io_ok) return false;
            if (r + 1 < T) {
                ranges[r + 1].lo = rg.hi;
                ranges[r + 1].line_start = ls;
            } else {
                cut = rg.hi;
                cut_line_start = ls;
            }
            if (rg.lo < rg.hi) live.push_back(r);
        }
        nominal += T;
        // speculative parses, one thread a range (a lone range on this one)
        run_parallel((int)live.size(), [&](int k) {
            Range &rg = ranges[live[k]];
            rg.spec = Spec();
            rg.spec.started = !rg.line_start;
            rg.end = assumed(rg.line_start);
            rg.parsed = parse_range(rg, rg.end, &rg.spec);
        });
        // verify in file order; parse again where the speculation fails
        std::vector<int64_t> at;  // each live range's first code
        int64_t g = total;
        for (int r : live) {
            Range &rg = ranges[r];
            if (!rg.io_ok) return false;
            bool kept = false;
            if (rg.parsed && holds(state, rg.line_start)) {
                if (!rg.spec.saw_header) rg.end.seq_len += state.seq_len;
                kept = true;
            } else if (rg.parsed && rg.spec.lead_header && rg.line_start
                       && !state.in_qual) {
                if (!state.any_record) rg.drop_first();
                kept = true;
            }
            if (kept) {
                state = std::move(rg.end);
                split_bytes += rg.hi - rg.lo;
            } else if (!parse_range(rg, state, nullptr)) {
                return false;
            }
            at.push_back(g);
            g += rg.n;
        }
        stream_bytes += ranges[T - 1].hi - ranges[0].lo;
        // stitch the ranges' words and invalid positions onto the tapes
        grow_tape(g);
        size_t e = exc_tape.size();
        std::vector<size_t> exc_at;
        for (int r : live) {
            exc_at.push_back(e);
            e += ranges[r].exc.size();
        }
        exc_tape.resize(e);
        for (size_t k = 0; k < live.size(); ++k)
            zero_ends(ranges[live[k]], at[k]);
        run_parallel((int)live.size(), [&](int k) {
            const Range &rg = ranges[live[k]];
            place(rg, at[k]);
            for (size_t i = 0; i < rg.exc.size(); ++i)
                exc_tape[exc_at[k] + i] = at[k] + rg.exc[i];
        });
        total = g;
        if (size >= 0 && cut >= size) finish();
        return true;
    }

    // EOF: an open FASTQ record's codes go out, as the sequential
    // reader's do.
    void finish() {
        done = true;
        if (state.staged.empty()) return;
        Range &rg = ranges[0];
        rg.reset();
        rg.append(state.staged.data(), (int64_t)state.staged.size());
        state.staged.clear();
        grow_tape(total + rg.n);
        zero_ends(rg, total);
        place(rg, total);
        for (int64_t e : rg.exc) exc_tape.push_back(total + e);
        total += rg.n;
    }
};

}  // namespace

extern "C" {

// Open `path` for split reading on `threads` threads, `range` bytes a
// thread a block.  nullptr if it cannot be opened.
void *kssd_split_open(const char *path, int least_qual, int threads,
                      int64_t range) {
    gzFile gz = gzopen(path, "rb");
    if (!gz) return nullptr;
    auto *h = new Split();
    h->least_qual = least_qual;
    h->threads = threads < 1 ? 1 : threads;
    h->range = range < 1 ? 1 : range;
    h->ranges.resize(h->threads);
    if (gzdirect(gz)) {
        gzclose(gz);
        h->fd = open(path, O_RDONLY);
        struct stat st;
        if (h->fd < 0 || fstat(h->fd, &st) != 0) {
            if (h->fd >= 0) close(h->fd);
            delete h;
            return nullptr;
        }
        h->size = st.st_size;
    } else {
        gzbuffer(gz, 1 << 20);
        h->gz = gz;
    }
    return h;
}

void kssd_split_close(void *hp) {
    auto *h = static_cast<Split *>(hp);
    if (!h) return;
    if (h->gz) gzclose(h->gz);
    if (h->fd >= 0) close(h->fd);
    delete h;
}

// Copy the next `chunk` codes' words (fewer at the end; `chunk` a
// multiple of 16) into `words`; returns their count, 0 at EOF, -1 on a
// read error.  *n_exc: the chunk's invalid positions, which
// kssd_split_exc copies out.
int64_t kssd_split_next(void *hp, int64_t chunk, uint32_t *words,
                        int64_t *n_exc) {
    auto *h = static_cast<Split *>(hp);
    *n_exc = 0;
    if (h->failed) return -1;
    while (h->total - h->emitted < chunk && !h->done) {
        if (!h->next_block()) {
            h->failed = true;
            return -1;
        }
    }
    int64_t n = std::min(chunk, h->total - h->emitted);
    h->exc.clear();
    if (n == 0) return 0;
    memcpy(words, h->tape.data() + (h->emitted / 16 - h->base),
           (n + 15) / 16 * sizeof(uint32_t));
    int64_t end = h->emitted + n;
    for (; h->exc_pos < h->exc_tape.size()
           && h->exc_tape[h->exc_pos] < end; ++h->exc_pos)
        h->exc.push_back((int32_t)(h->exc_tape[h->exc_pos] - h->emitted));
    h->emitted = end;
    *n_exc = (int64_t)h->exc.size();
    return n;
}

// Copy the last chunk's invalid positions into `out`.
void kssd_split_exc(void *hp, int32_t *out) {
    auto *h = static_cast<Split *>(hp);
    memcpy(out, h->exc.data(), h->exc.size() * sizeof(int32_t));
}

void kssd_split_stats(void *hp, int64_t *stream_bytes, int64_t *split_bytes) {
    auto *h = static_cast<Split *>(hp);
    *stream_bytes = h->stream_bytes;
    *split_bytes = h->split_bytes;
}

}  // extern "C"
