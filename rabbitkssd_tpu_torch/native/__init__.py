"""Native (C++) host runtime components.

The reference's host-side hot paths are native C++ (RabbitFX chunked
readers, robin_hood sets, glibc-rand shuffling).  The port keeps host
streaming/bookkeeping native too: sources in ``src/`` are compiled on
demand into a shared library loaded via ctypes (no pybind11).  Every
entry point but the chunked reader has a pure-Python fallback so the
package works without a toolchain.

The port's copy of ``rabbitkssd_tpu/native``.  It builds into its own
cache (``~/.cache/rabbitkssd_tpu_torch/native`` or
``RABBITKSSD_TPU_TORCH_NATIVE_DIR``); one process builds at a time
(a file lock) into a per-process temporary name, so concurrent test
workers on a cold cache neither race on one file nor build twice.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import sys
import threading

_SRC_DIR = os.path.join(os.path.dirname(__file__), "src")
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _build_dir() -> str:
    d = os.environ.get(
        "RABBITKSSD_TPU_TORCH_NATIVE_DIR",
        os.path.expanduser("~/.cache/rabbitkssd_tpu_torch/native"),
    )
    os.makedirs(d, exist_ok=True)
    return d


def _sources() -> list[str]:
    return sorted(
        os.path.join(_SRC_DIR, f)
        for f in os.listdir(_SRC_DIR)
        if f.endswith(".cpp")
    )


# mallopt parameters (glibc malloc.h) and the mmap threshold fixed here
_M_TRIM_THRESHOLD, _M_MMAP_THRESHOLD = -1, -3
_MMAP_THRESHOLD = 32 << 20


def _fix_malloc_thresholds() -> None:
    """Fix glibc's mmap threshold at 32 MiB and its trim threshold at
    twice that, where its dynamic rule ends.  Until a free of a larger
    block raises it, glibc maps every block of 128 KiB or more on its
    own; the parse threads' buffers of each genome are such blocks, and
    each unmap stalls every thread of the process (a bact sketch
    command spent 4x the kernel time, and its stream pipeline ran 1.4x
    longer, on an H100 host).  Nothing to do off glibc."""
    try:
        mallopt = ctypes.CDLL(None).mallopt
    except AttributeError:
        return
    mallopt.argtypes = [ctypes.c_int, ctypes.c_int]
    mallopt(_M_MMAP_THRESHOLD, _MMAP_THRESHOLD)
    mallopt(_M_TRIM_THRESHOLD, 2 * _MMAP_THRESHOLD)


def load_native():
    """Compile (if needed) and load the native library, and fix the
    process's malloc thresholds for its threads
    (:func:`_fix_malloc_thresholds`); None on failure."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        try:
            srcs = _sources()
            import hashlib

            h = hashlib.sha256()
            for s in srcs:
                with open(s, "rb") as f:
                    h.update(f.read())
            so = os.path.join(_build_dir(), f"libkssd_{h.hexdigest()[:16]}.so")
            if not os.path.exists(so):
                with open(so + ".lock", "w") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)
                    if not os.path.exists(so):
                        tmp = f"{so}.{os.getpid()}.tmp"
                        cmd = [
                            "g++", "-O3", "-march=native", "-shared", "-fPIC",
                            "-std=c++17", "-fopenmp", *srcs, "-lz", "-o", tmp,
                        ]
                        subprocess.run(cmd, check=True, capture_output=True)
                        os.replace(tmp, so)
            _LIB = ctypes.CDLL(so)
        except Exception as e:  # toolchain absent -> python fallbacks
            print(f"rabbitkssd_tpu_torch: native build unavailable ({e}); "
                  f"using Python fallbacks", file=sys.stderr)
            _LIB = None
        if _LIB is not None:
            import ctypes as ct

            _fix_malloc_thresholds()
            _LIB.kssd_fasta_codes.restype = ct.c_int
            _LIB.kssd_fasta_codes.argtypes = [
                ct.c_char_p, ct.c_int,
                ct.POINTER(ct.POINTER(ct.c_int8)), ct.POINTER(ct.c_int64),
            ]
            _LIB.kssd_free.argtypes = [ct.c_void_p]
            _LIB.kssd_pack_codes.restype = ct.c_int
            _LIB.kssd_pack_codes.argtypes = [
                ct.POINTER(ct.c_int8), ct.c_int64, ct.POINTER(ct.c_uint32),
                ct.POINTER(ct.POINTER(ct.c_int32)), ct.POINTER(ct.c_int64),
            ]
            _LIB.kssd_fasta_packed.restype = ct.c_int
            _LIB.kssd_fasta_packed.argtypes = [
                ct.c_char_p, ct.c_int,
                ct.POINTER(ct.POINTER(ct.c_uint32)), ct.POINTER(ct.c_int64),
                ct.POINTER(ct.POINTER(ct.c_int32)), ct.POINTER(ct.c_int64),
            ]
            _LIB.kssd_split_open.restype = ct.c_void_p
            _LIB.kssd_split_open.argtypes = [ct.c_char_p, ct.c_int, ct.c_int,
                                             ct.c_int64]
            _LIB.kssd_split_next.restype = ct.c_int64
            _LIB.kssd_split_next.argtypes = [
                ct.c_void_p, ct.c_int64, ct.POINTER(ct.c_uint32),
                ct.POINTER(ct.c_int64),
            ]
            _LIB.kssd_split_exc.restype = None
            _LIB.kssd_split_exc.argtypes = [ct.c_void_p, ct.POINTER(ct.c_int32)]
            _LIB.kssd_split_stats.restype = None
            _LIB.kssd_split_stats.argtypes = [
                ct.c_void_p, ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64)]
            _LIB.kssd_split_close.restype = None
            _LIB.kssd_split_close.argtypes = [ct.c_void_p]
            _LIB.kssd_shuffle_kept.restype = ct.c_int
            _LIB.kssd_shuffle_kept.argtypes = [
                ct.c_int, ct.c_int64, ct.c_int64, ct.c_int32, ct.c_int64,
                ct.c_int, ct.POINTER(ct.c_int32),
                ct.POINTER(ct.POINTER(ct.c_int32)),
                ct.POINTER(ct.POINTER(ct.c_int32)), ct.POINTER(ct.c_int64),
            ]
            _LIB.kssd_pair_count.restype = None
            _LIB.kssd_pair_count.argtypes = [
                ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int64),
                ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int32),
                ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
                ct.c_int64, ct.POINTER(ct.c_int32), ct.c_int64,
                ct.c_int32, ct.c_int32, ct.c_int32,
            ]
            _LIB.kssd_radix_sort_u64.restype = ct.c_int
            _LIB.kssd_radix_sort_u64.argtypes = [
                ct.POINTER(ct.c_uint64), ct.POINTER(ct.c_uint64),
                ct.c_int64, ct.c_int, ct.c_int, ct.c_int,
            ]
            _LIB.kssd_radix_sort_kv64.restype = ct.c_int
            _LIB.kssd_radix_sort_kv64.argtypes = [
                ct.POINTER(ct.c_uint64), ct.POINTER(ct.c_uint64),
                ct.POINTER(ct.c_uint64), ct.POINTER(ct.c_uint64),
                ct.c_int64, ct.c_int, ct.c_int, ct.c_int,
            ]
            _LIB.kssd_build_postings32.restype = ct.c_int64
            _LIB.kssd_build_postings32.argtypes = [
                ct.POINTER(ct.c_uint32), ct.c_int64,
                ct.POINTER(ct.c_int64), ct.c_int32, ct.c_int,
                ct.POINTER(ct.c_uint32), ct.POINTER(ct.c_int32),
                ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int64), ct.c_int,
            ]
            _LIB.kssd_build_postings64.restype = ct.c_int64
            _LIB.kssd_build_postings64.argtypes = [
                ct.POINTER(ct.c_uint64), ct.c_int64,
                ct.POINTER(ct.c_int64), ct.c_int32, ct.c_int,
                ct.POINTER(ct.c_uint64), ct.POINTER(ct.c_int32),
                ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int64), ct.c_int,
            ]
            _LIB.kssd_partition_pairs.restype = None
            _LIB.kssd_partition_pairs.argtypes = [
                ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
                ct.c_int64, ct.c_int32, ct.c_int32,
                ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
                ct.POINTER(ct.c_int64), ct.c_int,
            ]
            _LIB.kssd_pair_collect.restype = None
            _LIB.kssd_pair_collect.argtypes = [
                ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int64),
                ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int32),
                ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
                ct.c_int64, ct.c_int64, ct.c_int64,
                ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
                ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64), ct.c_int,
            ]
            _LIB.kssd_scan_count.restype = None
            _LIB.kssd_scan_count.argtypes = [
                ct.POINTER(ct.c_int32), ct.c_int64, ct.c_int64,
                ct.c_int64, ct.POINTER(ct.c_int64), ct.c_int,
            ]
            _LIB.kssd_scan_fill.restype = None
            _LIB.kssd_scan_fill.argtypes = [
                ct.POINTER(ct.c_int32), ct.c_int64, ct.c_int64,
                ct.c_int64, ct.POINTER(ct.c_int64),
                ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
                ct.POINTER(ct.c_int32), ct.c_int,
            ]
            _LIB.kssd_format_rows.restype = ct.c_int64
            _LIB.kssd_format_rows.argtypes = [
                ct.POINTER(ct.c_int32), ct.POINTER(ct.c_int32),
                ct.POINTER(ct.c_int32), ct.c_int64,
                ct.POINTER(ct.c_int64), ct.POINTER(ct.c_int64),
                ct.c_char_p, ct.POINTER(ct.c_int64),
                ct.c_char_p, ct.POINTER(ct.c_int64),
                ct.c_int32, ct.c_double, ct.c_int32, ct.c_int32,
                ct.c_int32, ct.POINTER(ct.c_char), ct.c_int64,
                ct.POINTER(ct.c_int32),
            ]
        return _LIB


def _nthreads(n: int) -> int:
    """Thread count for the native kernels: all host cores by default
    (the reference uses get_nprocs_conf(), main.cpp:50), overridable
    with KSSD_NATIVE_THREADS for bandwidth-bound kernels where extra
    cores stop paying."""
    cap = int(os.environ.get("KSSD_NATIVE_THREADS", "0")) or (
        os.cpu_count() or 1
    )
    return max(1, min(cap, n))


def radix_sort_u64(keys, lo_bit: int, hi_bit: int):
    """Stable sort of a u64 array by bits [lo_bit, hi_bit) (payload bits
    outside the range ride along).  Returns the sorted array, or None if
    the toolchain is unavailable.  ``keys`` is consumed (ping-pong
    buffer)."""
    import ctypes as ct

    import numpy as np

    lib = load_native()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, np.uint64)
    tmp = np.empty_like(keys)
    flip = lib.kssd_radix_sort_u64(
        keys.ctypes.data_as(ct.POINTER(ct.c_uint64)),
        tmp.ctypes.data_as(ct.POINTER(ct.c_uint64)),
        ct.c_int64(keys.size), lo_bit, hi_bit, _nthreads(keys.size),
    )
    return tmp if flip else keys


def radix_sort_kv64(keys, vals, lo_bit: int, hi_bit: int):
    """Stable sort of u64 keys by bits [lo_bit, hi_bit) with a u64
    payload permuted alongside.  Returns (sorted_keys, permuted_vals) or
    None; both inputs are consumed."""
    import ctypes as ct

    import numpy as np

    lib = load_native()
    if lib is None:
        return None
    keys = np.ascontiguousarray(keys, np.uint64)
    vals = np.ascontiguousarray(vals, np.uint64)
    tk = np.empty_like(keys)
    tv = np.empty_like(vals)
    flip = lib.kssd_radix_sort_kv64(
        keys.ctypes.data_as(ct.POINTER(ct.c_uint64)),
        vals.ctypes.data_as(ct.POINTER(ct.c_uint64)),
        tk.ctypes.data_as(ct.POINTER(ct.c_uint64)),
        tv.ctypes.data_as(ct.POINTER(ct.c_uint64)),
        ct.c_int64(keys.size), lo_bit, hi_bit, _nthreads(keys.size),
    )
    return (tk, tv) if flip else (keys, vals)


def build_postings(hashes, sizes, hash_bits: int):
    """Full inverted-index build from a concatenated hash tape: stable
    radix sort of (hash, genome) pairs plus run-boundary detection and
    per-pair vocabulary column ids, all native (the pack/sort/unpack
    numpy temporaries around the raw sort were the measured config-5
    index-build wall).  ``hashes`` is the genome-major concatenation,
    ``sizes`` the per-genome pair counts.  Returns
    (sorted_hashes, sorted_gids i32, cols i32, offsets i64[nv+1]) or
    None if the toolchain is unavailable.
    """
    import ctypes as ct

    import numpy as np

    lib = load_native()
    if lib is None:
        return None
    sizes = np.ascontiguousarray(sizes, np.int64)
    n = int(sizes.sum())
    g = len(sizes)
    use64 = hashes.dtype.itemsize > 4 and hash_bits > 32
    hdt = np.uint64 if use64 else np.uint32
    hashes = np.ascontiguousarray(hashes, hdt)
    sh = np.empty(n, hdt)
    sg = np.empty(n, np.int32)
    cols = np.empty(n, np.int32)
    starts = np.empty(n + 1, np.int64)
    fn = lib.kssd_build_postings64 if use64 else lib.kssd_build_postings32
    cptr = ct.POINTER(ct.c_uint64 if use64 else ct.c_uint32)
    nv = fn(
        hashes.ctypes.data_as(cptr), ct.c_int64(n),
        sizes.ctypes.data_as(ct.POINTER(ct.c_int64)), ct.c_int32(g),
        ct.c_int(hash_bits), sh.ctypes.data_as(cptr),
        sg.ctypes.data_as(ct.POINTER(ct.c_int32)),
        cols.ctypes.data_as(ct.POINTER(ct.c_int32)),
        starts.ctypes.data_as(ct.POINTER(ct.c_int64)),
        _nthreads(n),
    )
    if nv < 0:
        raise MemoryError("native postings build allocation failed")
    offsets = np.empty(nv + 1, np.int64)
    offsets[:nv] = starts[:nv]
    offsets[nv] = n
    return sh, sg, cols, offsets


def partition_pairs(gids, cols, block: int, n_strips: int):
    """Stable partition of (gid i32, col i32) pairs by strip gid//block:
    one counting-sort pass (dist_engine strip grouping).  Returns
    (g_out, c_out, bounds i64[n_strips+1]) or None.  Requires
    n_strips <= 65536."""
    import ctypes as ct

    import numpy as np

    lib = load_native()
    if lib is None or n_strips > 65536:
        return None
    gids = np.ascontiguousarray(gids, np.int32)
    cols = np.ascontiguousarray(cols, np.int32)
    g_out = np.empty_like(gids)
    c_out = np.empty_like(cols)
    bounds = np.empty(n_strips + 1, np.int64)
    lib.kssd_partition_pairs(
        gids.ctypes.data_as(ct.POINTER(ct.c_int32)),
        cols.ctypes.data_as(ct.POINTER(ct.c_int32)),
        ct.c_int64(gids.size), ct.c_int32(block), ct.c_int32(n_strips),
        g_out.ctypes.data_as(ct.POINTER(ct.c_int32)),
        c_out.ctypes.data_as(ct.POINTER(ct.c_int32)),
        bounds.ctypes.data_as(ct.POINTER(ct.c_int64)),
        _nthreads(gids.size),
    )
    return g_out, c_out, bounds


def pair_count_native(g0, s0, k0, g1, s1, k1, out, threads: int = 0,
                      col_lo: int = 0):
    """Join-layout posting-list counting into ``out`` int32[n0, n1]
    (the reference's dist.cpp:174-204 walk).  Threads split the output
    row space — the reference's per-thread privatized counter rows
    without the copies.  col_lo > 0 skips side-1 genomes below it (the
    upper-triangle trim; out columns < col_lo are left untouched).
    Returns False if the toolchain is unavailable.
    """
    import ctypes as ct

    import numpy as np

    lib = load_native()
    if lib is None:
        return False
    n0, n1 = out.shape
    g0 = np.ascontiguousarray(g0, np.int32)
    g1 = np.ascontiguousarray(g1, np.int32)
    s0 = np.ascontiguousarray(s0, np.int64)
    k0 = np.ascontiguousarray(k0, np.int64)
    s1 = np.ascontiguousarray(s1, np.int64)
    k1 = np.ascontiguousarray(k1, np.int64)
    assert out.dtype == np.int32 and out.flags["C_CONTIGUOUS"]

    def run(row_lo: int, row_hi: int) -> None:
        lib.kssd_pair_count(
            g0.ctypes.data_as(ct.POINTER(ct.c_int32)),
            s0.ctypes.data_as(ct.POINTER(ct.c_int64)),
            k0.ctypes.data_as(ct.POINTER(ct.c_int64)),
            g1.ctypes.data_as(ct.POINTER(ct.c_int32)),
            s1.ctypes.data_as(ct.POINTER(ct.c_int64)),
            k1.ctypes.data_as(ct.POINTER(ct.c_int64)),
            ct.c_int64(len(s0)),
            out.ctypes.data_as(ct.POINTER(ct.c_int32)),
            ct.c_int64(n1), ct.c_int32(row_lo), ct.c_int32(row_hi),
            ct.c_int32(col_lo),
        )

    nthreads = threads or min(os.cpu_count() or 1, 8)
    nthreads = max(1, min(nthreads, n0))
    if nthreads == 1:
        run(0, n0)
        return True
    from concurrent.futures import ThreadPoolExecutor

    bounds = [n0 * t // nthreads for t in range(nthreads + 1)]
    with ThreadPoolExecutor(max_workers=nthreads) as ex:
        list(ex.map(lambda t: run(bounds[t], bounds[t + 1]),
                    range(nthreads)))
    return True


def pair_collect(g0, s0, k0, g1, s1, k1, n1: int, diag: int):
    """Expand the posting join into packed upper-triangle i*n1+j keys
    (sparse strip counting, stage 1 — see pair_collect.cpp).  Returns
    an int64 array of one key per joined pair with j > diag + i, in
    arbitrary order (the caller sorts), or None if the toolchain is
    unavailable."""
    import ctypes as ct

    import numpy as np

    lib = load_native()
    if lib is None:
        return None
    g0 = np.ascontiguousarray(g0, np.int32)
    g1 = np.ascontiguousarray(g1, np.int32)
    s0 = np.ascontiguousarray(s0, np.int64)
    k0 = np.ascontiguousarray(k0, np.int64)
    s1 = np.ascontiguousarray(s1, np.int64)
    k1 = np.ascontiguousarray(k1, np.int64)
    n_cols = len(s0)
    # exclusive prefix of per-column join upper bounds: thread t's
    # compacted writes start at bound[its first column]
    bound = np.zeros(n_cols + 1, np.int64)
    np.cumsum(k0 * k1, out=bound[1:])
    out = np.empty(int(bound[-1]), np.int64)
    nt = _nthreads(n_cols)
    starts = np.zeros(nt, np.int64)
    counts = np.zeros(nt, np.int64)
    lib.kssd_pair_collect(
        g0.ctypes.data_as(ct.POINTER(ct.c_int32)),
        s0.ctypes.data_as(ct.POINTER(ct.c_int64)),
        k0.ctypes.data_as(ct.POINTER(ct.c_int64)),
        g1.ctypes.data_as(ct.POINTER(ct.c_int32)),
        s1.ctypes.data_as(ct.POINTER(ct.c_int64)),
        k1.ctypes.data_as(ct.POINTER(ct.c_int64)),
        ct.c_int64(n_cols), ct.c_int64(n1), ct.c_int64(diag),
        bound.ctypes.data_as(ct.POINTER(ct.c_int64)),
        out.ctypes.data_as(ct.POINTER(ct.c_int64)),
        starts.ctypes.data_as(ct.POINTER(ct.c_int64)),
        counts.ctypes.data_as(ct.POINTER(ct.c_int64)),
        ct.c_int(nt),
    )
    if nt == 1:
        return out[: int(counts[0])]
    return np.concatenate(
        [out[int(starts[t]) : int(starts[t] + counts[t])]
         for t in range(nt)])


def scan_nonzero(blk, diag: int):
    """Multithreaded (row, col, value) gather of a strip's nonzero
    entries above the diagonal: row r scans columns > diag + r
    (diag < 0: full rows).  Output is i-major with j ascending — the
    emission candidate order.  Returns (ii i32, jj i32, vv i32) or
    None if the toolchain is unavailable.  ``blk`` must be C-contiguous
    int32 [rows, n]."""
    import ctypes as ct

    import numpy as np

    lib = load_native()
    if lib is None:
        return None
    assert blk.dtype == np.int32 and blk.flags["C_CONTIGUOUS"]
    rows, n = blk.shape
    nt = _nthreads(rows * max(n, 1))
    counts = np.empty(rows, np.int64)
    p32 = ct.POINTER(ct.c_int32)
    p64 = ct.POINTER(ct.c_int64)
    lib.kssd_scan_count(blk.ctypes.data_as(p32), ct.c_int64(rows),
                        ct.c_int64(n), ct.c_int64(diag),
                        counts.ctypes.data_as(p64), nt)
    starts = np.empty(rows, np.int64)
    total = 0
    if rows:
        np.cumsum(counts[:-1], out=starts[1:])
        starts[0] = 0
        total = int(starts[-1] + counts[-1])
    ii = np.empty(total, np.int32)
    jj = np.empty(total, np.int32)
    vv = np.empty(total, np.int32)
    lib.kssd_scan_fill(blk.ctypes.data_as(p32), ct.c_int64(rows),
                       ct.c_int64(n), ct.c_int64(diag),
                       starts.ctypes.data_as(p64),
                       ii.ctypes.data_as(p32), jj.ctypes.data_as(p32),
                       vv.ctypes.data_as(p32), nt)
    return ii, jj, vv


# per-call scratch ceiling for format_rows (see its docstring)
_FORMAT_BUF_BYTES = 128 << 20


class NameBlob:
    """Concatenated UTF-8 name bytes + int64 offsets (name k occupies
    ``blob[off[k]:off[k+1]]``) — the zero-copy name table the native
    row formatter indexes."""

    def __init__(self, names: list[str]):
        import numpy as np

        enc = [n.encode("utf-8") for n in names]
        self.blob = b"".join(enc)
        self.off = np.zeros(len(enc) + 1, np.int64)
        np.cumsum([len(e) for e in enc], out=self.off[1:])
        self.lens = np.diff(self.off)


def format_rows(ii, jj, cc, sizes_i, sizes_j, blob_i: "NameBlob",
                blob_j: "NameBlob", kmer_size: int, max_dist: float,
                containment: bool, strict: bool, order: int):
    """Exact distance-row text for prefiltered candidates (the
    reference's per-pair recompute + fprintf, dist.cpp:206-256).

    Returns (buf bytes, row_len int32[n]) — row t's text occupies
    ``buf[cum[t]:cum[t+1]]`` where cum = cumsum(row_len); rejected rows
    have length 0.  None if the toolchain is unavailable.

    The scratch buffer is sized at worst case (~96 B + names per
    candidate); on dense candidate sets (max_dist >= 1, or clustered
    corpora) one caller group can imply a multi-GB transient, so calls
    beyond ``_FORMAT_BUF_BYTES`` are split internally on candidate
    count and the pieces concatenated — callers see one result.
    """
    import ctypes as ct

    import numpy as np

    lib = load_native()
    if lib is None:
        return None
    ii = np.ascontiguousarray(ii, np.int32)
    jj = np.ascontiguousarray(jj, np.int32)
    cc = np.ascontiguousarray(cc, np.int32)
    sizes_i = np.ascontiguousarray(sizes_i, np.int64)
    sizes_j = np.ascontiguousarray(sizes_j, np.int64)
    n = ii.size
    per_row = blob_i.lens[ii] + blob_j.lens[jj] + 96
    budget = _FORMAT_BUF_BYTES
    if int(per_row.sum()) + 96 > budget and n > 1:
        cum_cap = np.cumsum(per_row)
        splits = np.searchsorted(
            cum_cap, np.arange(budget, cum_cap[-1], budget)
        )
        bufs, lens = [], []
        for s0, s1 in zip(np.r_[0, splits], np.r_[splits, n]):
            if s0 >= s1:
                continue
            buf, rl = _format_rows_call(
                lib, ii[s0:s1], jj[s0:s1], cc[s0:s1], sizes_i, sizes_j,
                blob_i, blob_j, kmer_size, max_dist, containment,
                strict, order,
            )
            bufs.append(buf)
            lens.append(rl)
        return b"".join(bufs), np.concatenate(lens)
    return _format_rows_call(lib, ii, jj, cc, sizes_i, sizes_j, blob_i,
                             blob_j, kmer_size, max_dist, containment,
                             strict, order)


def _format_rows_call(lib, ii, jj, cc, sizes_i, sizes_j, blob_i, blob_j,
                      kmer_size, max_dist, containment, strict, order):
    """One unchunked kssd_format_rows call (inputs pre-validated)."""
    import ctypes as ct

    import numpy as np

    n = ii.size
    cap = int(blob_i.lens[ii].sum() + blob_j.lens[jj].sum()) + 96 * n + 96
    out = np.empty(cap, np.uint8)
    row_len = np.empty(n, np.int32)
    w = lib.kssd_format_rows(
        ii.ctypes.data_as(ct.POINTER(ct.c_int32)),
        jj.ctypes.data_as(ct.POINTER(ct.c_int32)),
        cc.ctypes.data_as(ct.POINTER(ct.c_int32)),
        ct.c_int64(n),
        sizes_i.ctypes.data_as(ct.POINTER(ct.c_int64)),
        sizes_j.ctypes.data_as(ct.POINTER(ct.c_int64)),
        blob_i.blob, blob_i.off.ctypes.data_as(ct.POINTER(ct.c_int64)),
        blob_j.blob, blob_j.off.ctypes.data_as(ct.POINTER(ct.c_int64)),
        ct.c_int32(kmer_size), ct.c_double(max_dist),
        ct.c_int32(1 if containment else 0),
        ct.c_int32(1 if strict else 0), ct.c_int32(order),
        out.ctypes.data_as(ct.POINTER(ct.c_char)), ct.c_int64(cap),
        row_len.ctypes.data_as(ct.POINTER(ct.c_int32)),
    )
    if w < 0:
        raise MemoryError("format_rows buffer overflow")
    return out[:w].tobytes(), row_len


def _take_i32(lib, ptr, n):
    """Copy a malloc'd int32 buffer into numpy and free it."""
    import numpy as np

    try:
        if n == 0:
            return np.empty(0, np.int32)
        return np.ctypeslib.as_array(ptr, shape=(n,)).astype(
            np.int32, copy=True
        )
    finally:
        if ptr:
            lib.kssd_free(ptr)


def shuffle_kept(fd: int, offset: int, n: int, dim_end: int, threads: int,
                 range_entries: int):
    """The kept set of the ``n`` int32 table entries at byte ``offset``
    of the open file ``fd``: (bitmap int32[ceil(n/32)], kept dims int32
    ascending, their values int32), read in one pass on ``threads``
    threads in ranges of ``range_entries`` (a multiple of 32); None if
    the toolchain is unavailable.  Raises EOFError if the file ends
    before the table does."""
    import ctypes as ct

    import numpy as np

    lib = load_native()
    if lib is None:
        return None
    bitmap = np.empty(-(-n // 32), np.int32)
    dp = ct.POINTER(ct.c_int32)()
    vp = ct.POINTER(ct.c_int32)()
    nk = ct.c_int64()
    rc = lib.kssd_shuffle_kept(
        fd, offset, n, dim_end, range_entries, threads,
        bitmap.ctypes.data_as(ct.POINTER(ct.c_int32)),
        ct.byref(dp), ct.byref(vp), ct.byref(nk))
    dims, vals = _take_i32(lib, dp, nk.value), _take_i32(lib, vp, nk.value)
    if rc == 1:
        raise EOFError
    if rc == 2:
        raise OSError("shuffle table read failed")
    if rc:
        raise MemoryError("shuffle table pass: out of memory")
    return bitmap, dims, vals


def fasta_packed(path: str, least_qual: int = 0):
    """Native FASTA/FASTQ(.gz) -> (words u32[ceil(n/16)], n_bases,
    exc i32[n_exc]); None if the toolchain is unavailable.

    One native pass: parse + 2-bit pack + invalid-position extraction
    (the packed-feeder hot path; round-1 did the pack in numpy on the
    feeder thread, which was the measured pipeline wall).
    """
    import ctypes as ct

    import numpy as np

    lib = load_native()
    if lib is None:
        return None
    wp = ct.POINTER(ct.c_uint32)()
    nb = ct.c_int64()
    ep = ct.POINTER(ct.c_int32)()
    ne = ct.c_int64()
    rc = lib.kssd_fasta_packed(path.encode(), int(least_qual),
                               ct.byref(wp), ct.byref(nb),
                               ct.byref(ep), ct.byref(ne))
    if rc != 0:
        raise IOError(f"native packed reader failed (rc={rc}) on {path}")
    try:
        nw = (nb.value + 15) // 16
        words = (np.ctypeslib.as_array(wp, shape=(nw,)).astype(
            np.uint32, copy=True) if nw else np.empty(0, np.uint32))
    finally:
        if wp:
            lib.kssd_free(wp)
    exc = _take_i32(lib, ep, ne.value)
    return words, nb.value, exc


def pack_codes_native(codes):
    """int8 code array -> (words u32, exc i32) via the native packer;
    None if the toolchain is unavailable."""
    import ctypes as ct

    import numpy as np

    lib = load_native()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, np.int8)
    n = codes.size
    words = np.empty((n + 15) // 16, np.uint32)
    ep = ct.POINTER(ct.c_int32)()
    ne = ct.c_int64()
    rc = lib.kssd_pack_codes(
        codes.ctypes.data_as(ct.POINTER(ct.c_int8)), ct.c_int64(n),
        words.ctypes.data_as(ct.POINTER(ct.c_uint32)),
        ct.byref(ep), ct.byref(ne),
    )
    if rc != 0:
        raise MemoryError("native pack failed")
    return words, _take_i32(lib, ep, ne.value)


# bytes a thread parses a block (T ranges make a block, after which the
# threads wait for each other): tens of MB, so a 1.2 GB file is a few
# dozen blocks, and a block's chunks outlast the next block's parse
_SPLIT_RANGE = 16 << 20


class PackedChunks:
    """Iterator of (words u32, n_bases, exc i32) chunks of one file, read
    by ``native/src/fasta_split.cpp`` on ``threads`` threads,
    ``range_bytes`` a thread a block; the chunks are those of the
    sequential chunked reader (``kssd_fasta_read_codes`` +
    ``kssd_pack_codes``, which the JAX package keeps).

    ``stream_bytes``: the bytes parsed; ``split_bytes``: those whose
    speculative parse of a byte range held.  The file is opened on the
    first ``next()`` and closed at its end or by ``close()``."""

    def __init__(self, path: str, least_qual: int, chunk: int,
                 threads: int, range_bytes: int = _SPLIT_RANGE):
        self._h = None
        self._done = False
        if chunk % 16:
            raise ValueError(f"chunk {chunk} is not a multiple of 16")
        self._lib = load_native()
        if self._lib is None:
            raise RuntimeError("native toolchain unavailable")
        self._path = path
        self._args = (int(least_qual), int(threads), int(range_bytes))
        self._chunk = chunk
        self.stream_bytes = 0
        self.split_bytes = 0

    def __iter__(self):
        return self

    def __next__(self):
        import ctypes as ct

        import numpy as np

        if self._done:
            raise StopIteration
        lib = self._lib
        if self._h is None:
            self._h = lib.kssd_split_open(self._path.encode(), *self._args)
            if not self._h:
                self._done = True
                raise IOError(f"cannot open {self._path}")
        words = np.empty(self._chunk // 16, np.uint32)
        n_exc = ct.c_int64()
        n = lib.kssd_split_next(
            self._h, ct.c_int64(self._chunk),
            words.ctypes.data_as(ct.POINTER(ct.c_uint32)), ct.byref(n_exc))
        if n <= 0:
            self.close()
            if n < 0:
                raise IOError(f"native split reader failed on {self._path}")
            raise StopIteration
        exc = np.empty(n_exc.value, np.int32)
        lib.kssd_split_exc(self._h, exc.ctypes.data_as(ct.POINTER(ct.c_int32)))
        return words[:(n + 15) // 16], int(n), exc

    def close(self) -> None:
        self._done = True
        if self._h is None:
            return
        got, held = ctypes.c_int64(), ctypes.c_int64()
        self._lib.kssd_split_stats(self._h, ctypes.byref(got),
                                   ctypes.byref(held))
        self.stream_bytes, self.split_bytes = got.value, held.value
        self._lib.kssd_split_close(self._h)
        self._h = None

    def __del__(self):
        self.close()


def fasta_packed_chunks(path: str, least_qual: int = 0,
                        chunk: int = 1 << 24, threads: int = 1):
    """Iterator of (words u32, n_bases, exc i32) chunks for one file.

    Bounded memory for multi-GB inputs; every chunk except the last
    holds exactly ``chunk`` bases (a multiple of 16, so chunks
    concatenate word-aligned).  The file is parsed on ``threads``
    threads, in byte ranges cut at line ends (``PackedChunks``); the
    caller owns the thread budget.  Raises if the toolchain is
    unavailable.
    """
    return PackedChunks(path, least_qual, chunk, threads)


def fasta_codes(path: str, least_qual: int = 0):
    """Native FASTA/FASTQ(.gz) -> int8 code tape; None if unavailable.

    Equivalent to ``encode_concat([(r.seq, r.qual) for r in
    read_records(path)], least_qual)`` but parses + encodes in one
    native streaming pass (the RabbitFX role, reference sketch.cpp:401).
    """
    import ctypes as ct

    import numpy as np

    lib = load_native()
    if lib is None:
        return None
    out = ct.POINTER(ct.c_int8)()
    n = ct.c_int64()
    rc = lib.kssd_fasta_codes(path.encode(), int(least_qual),
                              ct.byref(out), ct.byref(n))
    if rc != 0:
        raise IOError(f"native fasta reader failed (rc={rc}) on {path}")
    try:
        if n.value == 0:
            return np.empty(0, np.int8)
        arr = np.ctypeslib.as_array(out, shape=(n.value,)).astype(
            np.int8, copy=True
        )
    finally:
        lib.kssd_free(out)
    return arr
