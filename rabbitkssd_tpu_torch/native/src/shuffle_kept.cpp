// The kept set of a shuffle file's table in one pass: the keep test
// needs only {d : 0 <= shuffled_dim[d] < dim_end}, so the int32[dim_size]
// permutation (1 GiB at half_subk 7) is never held whole.  The table is
// read with pread in fixed ranges of `range` entries (a multiple of 32),
// taken in turn by T threads, each with one reused buffer; each range
// writes its bitmap words (bit d of word d >> 5) straight into the
// output and collects its kept (dim, value) pairs.  The pairs are joined
// range by range in file order, so the output is the same for every T.
// shuffle.py:read_shuffle_kept calls it after reading the header, and its
// NumPy twin there reads the same ranges where the library is missing.

#include <algorithm>
#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

// Reads `bytes` at `off` into `buf`: 0, 1 at end of file first, or -1
// (errno set).
int read_full(int fd, char *buf, int64_t bytes, int64_t off) {
  while (bytes > 0) {
    ssize_t got = pread(fd, buf, (size_t)bytes, (off_t)off);
    if (got < 0) {
      if (errno == EINTR) continue;
      return -1;
    }
    if (got == 0) return 1;
    buf += got;
    off += got;
    bytes -= got;
  }
  return 0;
}

// One range's bitmap words and kept pairs.  `t` holds `cnt` entries
// that start at entry `base` (a multiple of 32).
void scan_range(const int32_t *t, int64_t cnt, int64_t base, uint32_t dim_end,
                int32_t *bitmap, std::vector<int32_t> &dims,
                std::vector<int32_t> &vals) {
  const int64_t whole = cnt / 32;
  int32_t *out = bitmap + base / 32;
  for (int64_t w = 0; w <= whole; ++w) {
    const int32_t *p = t + 32 * w;
    uint32_t bits = 0;
    if (w < whole) {
      for (int j = 0; j < 32; ++j)  // negatives compare as large
        bits |= (uint32_t)((uint32_t)p[j] < dim_end) << j;
    } else {
      if (32 * w == cnt) break;
      for (int64_t j = 0; j < cnt - 32 * w; ++j)
        bits |= (uint32_t)((uint32_t)p[j] < dim_end) << j;
    }
    out[w] = (int32_t)bits;
    while (bits) {
      int j = __builtin_ctz(bits);
      dims.push_back((int32_t)(base + 32 * w + j));
      vals.push_back(p[j]);
      bits &= bits - 1;
    }
  }
}

}  // namespace

extern "C" {

// Scans the n int32 entries at byte `offset` of `fd` on `threads`
// threads in ranges of `range` entries.  Writes bitmap[ceil(n / 32)];
// *dims and *vals get malloc'd arrays of *n_kept kept dims (ascending)
// and their values (free with kssd_free).  Returns 0; 1 if the file
// ends before the table does; 2 on a read error or a bad argument (errno
// set); 3 if out of memory.
int kssd_shuffle_kept(int fd, int64_t offset, int64_t n, int32_t dim_end,
                      int64_t range, int threads, int32_t *bitmap,
                      int32_t **dims, int32_t **vals, int64_t *n_kept) {
  *dims = *vals = nullptr;
  *n_kept = 0;
  if (n < 0 || range <= 0 || range % 32 || dim_end < 0) {
    errno = EINVAL;
    return 2;
  }
  const int64_t n_ranges = (n + range - 1) / range;
  const int nt = (int)std::max<int64_t>(1, std::min<int64_t>(threads, n_ranges));
  std::vector<std::vector<int32_t>> rd(n_ranges), rv(n_ranges);
  std::atomic<int64_t> next{0};
  std::atomic<int> fail{0};
  std::atomic<int> err{0};
  auto work = [&]() {
    std::vector<int32_t> buf;
    try {
      buf.resize((size_t)std::min(range, n));
    } catch (const std::bad_alloc &) {
      fail.store(3);
      return;
    }
    for (int64_t r; fail.load() == 0 && (r = next.fetch_add(1)) < n_ranges;) {
      const int64_t base = r * range;
      const int64_t cnt = std::min(range, n - base);
      int rc = read_full(fd, (char *)buf.data(), 4 * cnt, offset + 4 * base);
      if (rc != 0) {
        if (rc < 0) err.store(errno);
        int want = 0;
        fail.compare_exchange_strong(want, rc < 0 ? 2 : 1);
        return;
      }
      try {
        scan_range(buf.data(), cnt, base, (uint32_t)dim_end, bitmap, rd[r],
                   rv[r]);
      } catch (const std::bad_alloc &) {
        fail.store(3);
        return;
      }
    }
  };
  std::vector<std::thread> pool;
  for (int i = 1; i < nt; ++i) pool.emplace_back(work);
  work();
  for (auto &th : pool) th.join();
  if (fail.load()) {
    if (fail.load() == 2) errno = err.load();
    return fail.load();
  }
  int64_t total = 0;
  for (const auto &v : rd) total += (int64_t)v.size();
  // at least one entry, so that no allocation returns a null pointer
  *dims = (int32_t *)malloc(4 * std::max<int64_t>(total, 1));
  *vals = (int32_t *)malloc(4 * std::max<int64_t>(total, 1));
  if (!*dims || !*vals) {
    free(*dims);
    free(*vals);
    *dims = *vals = nullptr;
    return 3;
  }
  int64_t at = 0;
  for (int64_t r = 0; r < n_ranges; ++r) {
    if (rd[r].empty()) continue;
    std::memcpy(*dims + at, rd[r].data(), 4 * rd[r].size());
    std::memcpy(*vals + at, rv[r].data(), 4 * rv[r].size());
    at += (int64_t)rd[r].size();
  }
  *n_kept = total;
  return 0;
}

}  // extern "C"
