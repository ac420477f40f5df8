"""The port's chunked reader, which parses on several threads
(``native/src/fasta_split.cpp`` behind ``native.fasta_packed_chunks``),
against the JAX package's sequential one
(``rabbitkssd_tpu.native.fasta_codes_chunks``, ``kssd_fasta_read_codes``,
then its ``kssd_pack_codes``), chunk by chunk: words, base count and
invalid positions, at 1, 2, 3 and 8 threads and two chunk sizes, on
inputs that exercise each rule of its split-and-verify parse.  Byte
ranges are made small, so that a file of a few hundred kB spans many
ranges and blocks.
"""

import gzip
import os

import numpy as np
import pytest

from rabbitkssd_tpu import native as jax_native
from rabbitkssd_tpu_torch import native

THREADS = (1, 2, 3, 8)
# 2^16, and 16 x 397: a multiple of none of the line widths below
CHUNKS = (1 << 16, 16 * 397)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")


def _bases(rng, n: int, lower: bool = False, n_runs: int = 0) -> bytes:
    seq = np.frombuffer(b"acgt" if lower else b"ACGT", np.uint8)[
        rng.integers(0, 4, n)]
    for _ in range(n_runs):
        at = int(rng.integers(0, n - 50))
        seq[at: at + int(rng.integers(1, 50))] = ord("N")
    return seq.tobytes()


def _lines(seq: bytes, width: int, end: bytes = b"\n") -> bytes:
    return b"".join(seq[i: i + width] + end
                    for i in range(0, len(seq), width))


def _one_record(rng) -> bytes:
    """One record, 100-letter lines, N runs and a lower-case stretch."""
    seq = bytearray(_bases(rng, 200_000, n_runs=12))
    seq[50_000:80_000] = seq[50_000:80_000].lower()
    return b">chr1 one record\n" + _lines(bytes(seq), 100)


def _crlf(rng) -> bytes:
    """Three records in 60-letter lines ended by CRLF."""
    return b"".join(b">r%d\r\n" % i
                    + _lines(_bases(rng, 40_000, i == 1, 3), 60, b"\r\n")
                    for i in range(3))


def _empty_lines(rng) -> bytes:
    """Empty lines before, between and inside records."""
    out = [b"\n\n"]
    for i in range(6):
        body = _lines(_bases(rng, 20_000, n_runs=1), 70).split(b"\n")
        for j in range(0, len(body), 37):
            body[j] += b"\n" if j % 2 else b"\r\n"
        out.append(b">r%d\n" % i + b"\n".join(body) + b"\n\n")
    return b"".join(out)


# every record exactly this long, so with ranges of this size each cut,
# and so each block's start, falls on a header
RECORD = 800


def _headers_at_cuts(rng) -> bytes:
    out = []
    for i in range(300):
        # an 8-byte header, 7 lines of 100 letters and one of 84
        out.append(b">h%05d\n" % i + _lines(_bases(rng, 784), 100))
        assert len(out[-1]) == RECORD
    return b"".join(out)


def _long_line(rng) -> bytes:
    """A 150 kb line, longer than a range, then a record of short lines."""
    return (b">long\n" + _bases(rng, 150_000, n_runs=2) + b"\n>short\n"
            + _lines(_bases(rng, 30_000), 80))


def _small(rng) -> bytes:
    """A file smaller than one block (and than one range)."""
    return b">a\n" + _lines(_bases(rng, 200), 50) + b">b\nACGTNacgt\n"


def _fastq(rng) -> bytes:
    """FASTQ reads with qualities, read with -Q 53."""
    out = []
    for i in range(1500):
        seq = _bases(rng, 150)
        qual = np.frombuffer(b"#5?I", np.uint8)[
            rng.integers(0, 4, 150)].tobytes()
        out.append(b"@read%d/1\n%s\n+\n%s\n" % (i, seq, qual))
    return b"".join(out)


def _plus_line(rng) -> bytes:
    """A FASTA record with a '+' line, which kseq reads as the start of
    a quality section as long as its sequence, then more records."""
    return (b">r0\n" + _lines(_bases(rng, 3_000), 100) + b"+\n"
            + _lines(b"5" * 3_000, 100)
            + b"".join(b">r%d\n" % i + _lines(_bases(rng, 40_000), 100)
                       for i in (1, 2, 3)))


# name: (maker, least_qual, range bytes, gzipped)
CASES = {
    "one-record": (_one_record, 0, 1000, False),
    "crlf-60": (_crlf, 0, 997, False),
    "empty-lines": (_empty_lines, 0, 613, False),
    "headers-at-cuts": (_headers_at_cuts, 0, RECORD, False),
    "long-line": (_long_line, 0, 1000, False),
    "small-file": (_small, 0, 1 << 20, False),
    "gz": (_one_record, 0, 1000, True),
    "fastq-Q53": (_fastq, 53, 1000, False),
    "plus-line": (_plus_line, 0, 1000, False),
}
# inputs whose every speculative parse holds (plain FASTA)
PLAIN = ("one-record", "crlf-60", "empty-lines", "headers-at-cuts",
         "long-line", "small-file", "gz")


@pytest.fixture(scope="module")
def lib():
    """Both native libraries: the JAX package's, with the sequential
    reader, and the port's, with the split one."""
    got = native.load_native()
    assert got is not None and jax_native.load_native() is not None, \
        "the native toolchain builds here"
    return got


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("split")
    out = {}
    for k, (name, (make, _, _, gz)) in enumerate(CASES.items()):
        data = make(np.random.default_rng(1800 + k))
        path = str(d / (name + (".fa.gz" if gz else ".fa")))
        with open(path, "wb") as f:
            f.write(gzip.compress(data) if gz else data)
        out[name] = (path, len(data))
    return out


def _sequential(path: str, least_qual: int, chunk: int) -> list:
    """The JAX package's chunks: its sequential reader, then its packer."""
    out = []
    for codes in jax_native.fasta_codes_chunks(path, least_qual,
                                               chunk=chunk):
        words, exc = jax_native.pack_codes_native(codes)
        out.append((words, len(codes), exc))
    return out


def _split(path, least_qual, chunk, threads, range_bytes):
    reader = native.PackedChunks(path, least_qual, chunk, threads,
                                 range_bytes)
    return list(reader), reader


def _assert_same(got: list, want: list) -> None:
    assert [n for _, n, _ in got] == [n for _, n, _ in want]
    for k, ((w, n, e), (w0, _, e0)) in enumerate(zip(got, want)):
        assert w.dtype == np.uint32 and e.dtype == np.int32
        assert np.array_equal(w, w0), f"words of chunk {k}"
        assert np.array_equal(e, e0), f"invalid positions of chunk {k}"


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("threads", THREADS)
@pytest.mark.parametrize("case", list(CASES))
def test_chunks_equal_the_sequential_reader(lib, files, case, threads,
                                            chunk):
    path, _ = files[case]
    _, least_qual, range_bytes, _ = CASES[case]
    want = _sequential(path, least_qual, chunk)
    got, _ = _split(path, least_qual, chunk, threads, range_bytes)
    assert len(want) > 1 or case == "small-file"
    _assert_same(got, want)
    # every chunk but the last holds `chunk` bases
    assert all(n == chunk for _, n, _ in got[:-1])


@pytest.mark.parametrize("case", list(CASES))
def test_counters(lib, files, case):
    """``stream_bytes`` counts every byte (inflated for .gz);
    ``split_bytes`` all of plain FASTA, none of FASTQ, and less than all
    where a '+' line sends the ranges after it to the sequential parse."""
    path, size = files[case]
    _, least_qual, range_bytes, _ = CASES[case]
    _, reader = _split(path, least_qual, 1 << 16, 3, range_bytes)
    assert reader.stream_bytes == size
    if case in PLAIN:
        assert reader.split_bytes == reader.stream_bytes
    elif case == "fastq-Q53":
        assert reader.split_bytes == 0
    else:
        assert 0 < reader.split_bytes < reader.stream_bytes


# bytes drawn for the random inputs: bases, line ends, headers, '+', '\r'
# and quality letters, in shares that make FASTA-like and FASTQ-like mixes
SOUP = np.frombuffer(b"ACGTacgtNn\n>@+\r!5I", np.uint8)
SOUP_P = np.array([8, 8, 8, 8, 3, 3, 3, 3, 2, 1, 6, 0.3, 0.3, 0.3, 0.3, 1,
                   1, 1])


@pytest.mark.parametrize("seed", range(6))
def test_random_inputs_equal_the_sequential_reader(lib, tmp_path, seed):
    rng = np.random.default_rng(4200 + seed)
    for t in range(12):
        p = SOUP_P.copy()
        if t % 2:
            p[11:14] *= 0.02  # mostly FASTA
        data = SOUP[rng.choice(len(SOUP), int(rng.integers(0, 4000)),
                               p=p / p.sum())].tobytes()
        path = str(tmp_path / f"r{t}.fa")
        with open(path, "wb") as f:
            f.write(data)
        least_qual = int(rng.choice([0, 53]))
        for threads in THREADS:
            chunk = 16 * int(rng.integers(1, 40))
            range_bytes = int(rng.integers(1, 300))
            got, reader = _split(path, least_qual, chunk, threads,
                                 range_bytes)
            _assert_same(got, _sequential(path, least_qual, chunk))
            assert reader.stream_bytes == len(data)


@pytest.mark.parametrize("threads", (1, 4))
def test_fasta_packed_chunks_keeps_its_interface(lib, files, threads):
    """The public entry: default ranges, the same chunks at one thread
    (the default) and at four; a chunk that is not a multiple of 16 is
    refused."""
    path, size = files["one-record"]
    reader = native.fasta_packed_chunks(path, 0, 1 << 16, threads=threads)
    _assert_same(list(reader), _sequential(path, 0, 1 << 16))
    assert reader.split_bytes == reader.stream_bytes == size
    with pytest.raises(ValueError):
        next(native.fasta_packed_chunks(path, 0, 1000))
    with pytest.raises(IOError):
        next(native.fasta_packed_chunks(path + ".missing"))


def test_sketch_budget_counts_the_chunked_reader(monkeypatch, capsys):
    """``sketch`` over the threshold: the budget's ``stream_bytes`` are
    the streamed files' bytes, all of them split (FASTA), and the
    sketches equal those of the whole-file reader; under it both read 0.
    """
    import json

    from rabbitkssd_tpu_torch.engine.sketcher import sketch_file_list
    from rabbitkssd_tpu_torch.shuffle import read_shuffle_file

    monkeypatch.chdir(GOLDEN)
    shuf = read_shuffle_file("k8s4l1.shuf")
    with open("fa.list") as f:
        sizes = [os.path.getsize(ln.strip()) for ln in f if ln.strip()]
    threshold = 100_000
    got = {}
    for tag, limit in (("whole", None), ("streamed", threshold)):
        if limit is None:
            monkeypatch.delenv("KSSD_STREAM_THRESHOLD", raising=False)
        else:
            monkeypatch.setenv("KSSD_STREAM_THRESHOLD", str(limit))
        capsys.readouterr()
        sk = sketch_file_list("fa.list", shuf, device="cpu", threads=2,
                              n_blocks=4, block=1 << 14)
        line, = [ln for ln in capsys.readouterr().err.splitlines()
                 if ln.startswith("sketch budget: ")]
        budget = json.loads(line[len("sketch budget: "):])
        got[tag] = ([s.hashes for s in sk.sketches], budget)
    big = sum(s for s in sizes if s > threshold)
    assert big > 0
    assert got["streamed"][1]["stream_bytes"] == big
    assert got["streamed"][1]["split_bytes"] == big
    assert got["whole"][1]["stream_bytes"] == 0
    assert got["whole"][1]["split_bytes"] == 0
    for a, b in zip(got["whole"][0], got["streamed"][0]):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("threads, want", [(2, 1), (6, 3), (16, 5)])
def test_sketch_streams_one_file_at_a_time(monkeypatch, threads, want):
    """``sketch_files`` gives the chunked reader its thread budget less
    three (the producer, consumer and flusher), at most five, and lets
    one file stream at a time, though several are parsed ahead."""
    import threading
    import time

    from rabbitkssd_tpu_torch.engine.sketcher import sketch_file_list
    from rabbitkssd_tpu_torch.shuffle import read_shuffle_file

    monkeypatch.chdir(GOLDEN)
    monkeypatch.setenv("KSSD_STREAM_THRESHOLD", "100000")
    whole = native.fasta_packed_chunks
    given, live, most = [], [0], [0]
    lock = threading.Lock()

    def watched(path, least_qual=0, threads=1):
        given.append(threads)
        inner = whole(path, least_qual, 1 << 12, threads=threads)

        def chunks():
            with lock:
                live[0] += 1
                most[0] = max(most[0], live[0])
            try:
                for c in inner:
                    time.sleep(0.002)  # long enough for streams to overlap
                    yield c
            finally:
                with lock:
                    live[0] -= 1
        return chunks()

    monkeypatch.setattr(native, "fasta_packed_chunks", watched)
    shuf = read_shuffle_file("k8s4l1.shuf")
    sketch_file_list("fa.list", shuf, device="cpu", threads=threads,
                     n_blocks=4, block=1 << 14)
    assert given == [want] * 3  # g1, g2, g4 are over the threshold
    assert most[0] == 1
