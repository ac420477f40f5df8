"""BASELINE config 4 in miniature: the port's CLI against the JAX CLI at
L3K12 (K = 24, 36-bit hashes, so ``use64``), through the chunked reader.

The corpus is config 4's recipe (``chip_smoke.make_config4_corpus``,
seed 77: two single-record genomes from one ancestor with 1 % mutations
and N runs, the second 1024 bases shorter, and a file of 20 contigs,
every third lowercase) at ~1 Mb: genomes of 400 kb, contigs of 10 kb.
``KSSD_STREAM_THRESHOLD`` is lowered below the genome files' size and
above the contig file's, so the genomes stream through the chunked
native reader (in the port, in 64 kb chunks, so one genome spans
several) and the contigs are read whole, as at full size.  The port's
``.sketch`` must be byte-equal to the JAX CLI's, and the sorted
``alldist -D 1.0`` rows equal.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
from rabbitkssd_tpu.cli import main as jax_main  # noqa: E402
from rabbitkssd_tpu_torch import native  # noqa: E402
from rabbitkssd_tpu_torch.cli import main as port_main  # noqa: E402
from rabbitkssd_tpu_torch.formats import read_sketches  # noqa: E402
from rabbitkssd_tpu_torch.shuffle import (generate_shuffle,  # noqa: E402
                                          write_shuffle_file)


def _rows(path):
    with open(path) as f:
        lines = f.readlines()
    return lines[:1] + sorted(lines[1:])


def test_config4_port_cli_equals_jax_cli(tmp_path, monkeypatch):
    list_path, files, total = chip_smoke.make_config4_corpus(
        str(tmp_path / "corpus"), 400_000, contig_len=10_000)
    assert total == 2 * 400_000 - 1024 + 20 * 10_000
    sizes = [os.path.getsize(f) for f in files]
    threshold = 300_000
    assert min(sizes[:2]) > threshold > sizes[2]
    shuf = str(tmp_path / "L3K12.shuf")
    write_shuffle_file(generate_shuffle(12, 6, 3), shuf)
    monkeypatch.setenv("KSSD_STREAM_THRESHOLD", str(threshold))
    assert native.load_native() is not None  # else no chunked reader

    chunks = []
    whole = native.fasta_packed_chunks

    def small_chunks(path, least_qual=0):
        for c in whole(path, least_qual, chunk=1 << 16):
            chunks.append(path)
            yield c

    monkeypatch.setattr(native, "fasta_packed_chunks", small_chunks)
    out = {}
    for tag, main, argv0 in (("port", port_main, ["--device", "cpu"]),
                             ("jax", jax_main, [])):
        sk = str(tmp_path / f"{tag}.sketch")
        assert main(argv0 + ["sketch", "-i", list_path, "-o", sk,
                             "-L", shuf]) == 0
        assert main(argv0 + ["alldist", "-i", sk, "-o", sk + ".alldist",
                             "-D", "1.0"]) == 0
        out[tag] = sk
    # each genome file streamed in several chunks; the contigs were not
    assert sorted(set(chunks)) == sorted(files[:2])
    assert len(chunks) >= 2 * (400_000 // (1 << 16))
    port, jax = out["port"], out["jax"]
    with open(port, "rb") as a, open(jax, "rb") as b:
        assert a.read() == b.read()
    sketches = read_sketches(port).sketches
    assert [s.hashes.dtype for s in sketches] == [np.uint64] * 3
    assert all(s.hashes.size > 20 for s in sketches)
    assert any(int(s.hashes.max()) >= 1 << 32 for s in sketches)
    rows = _rows(port + ".alldist")
    # one row: the two genomes (the contigs share no hash with them)
    assert len(rows) == 2 and rows == _rows(jax + ".alldist")

