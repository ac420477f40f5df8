"""The read-set cell's pieces on the CPU: the FASTQ generator, the plain
FASTQ reference, and a tiny reads cell run in a copy of the benchmark
(added as files, as a later cell would be), correct against the
reference and incorrect when the program under it ignores ``-n``."""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import kssd_bench_tiny as tiny  # noqa: E402

sys.path.insert(0, tiny.ROOT)
from kssd_bench import harness  # noqa: E402
from kssd_bench.reference import fastq  # noqa: E402
from kssd_bench.traffic import fastq_reads  # noqa: E402

MIX = harness.load_json("traffic", "illumina-4x50x-2x150")
SMALL = dict(MIX, n_samples=3, genome_len=[20_000, 40_000], coverage=10)
CELL = "sketch.test-reads-L2K6"
CONFIG = {"source": "test only", "sizes": tiny.CONFIG["sizes"],
          "filters": {"least_qual": 53, "least_num_kmer": 2}}


def _make(root, seed, params=SMALL) -> dict:
    os.makedirs(root, exist_ok=True)
    return fastq_reads.make(str(root), params, seed, torch.device("cpu"))


def _files(got: dict) -> list[str]:
    with open(got["paths"]["list"]) as f:
        return f.read().split()


def _lines(path: str) -> list[bytes]:
    with open(path, "rb") as f:
        return f.read().split(b"\n")[:-1]


# -- traffic ------------------------------------------------------------------

def test_the_same_seed_gives_the_same_bytes(tmp_path):
    seeds = [2 ** 31 + 11, 2 ** 31 + 11, 5]
    runs = [_make(tmp_path / str(k), s) for k, s in enumerate(seeds)]
    blobs = [[open(p, "rb").read() for p in _files(r)] for r in runs]
    assert blobs[0] == blobs[1] != blobs[2]
    assert runs[0]["work"] == runs[1]["work"] == runs[2]["work"]
    # distinct sizes, so the size order has no ties
    sizes = [len(b) for b in blobs[0]]
    assert len(set(sizes)) == len(sizes)


def test_bases_are_the_sequence_letters_written(tmp_path):
    got = _make(tmp_path, 7)
    letters = 0
    for path in _files(got):
        lines = _lines(path)
        assert all(h.startswith(b"@r") for h in lines[0::4])
        assert all(p == b"+" for p in lines[2::4])
        assert all(len(s) == MIX["read_len"] for s in lines[1::4])
        assert [len(q) for q in lines[3::4]] == [len(s) for s in
                                                 lines[1::4]]
        letters += sum(len(s) for s in lines[1::4])
    assert got["work"] == {"bases": letters, "genomes": 3}


def test_quality_bins_keep_their_shares(tmp_path):
    got = _make(tmp_path, 2 ** 40 + 3)
    quals = np.concatenate([
        np.frombuffer(b"".join(_lines(p)[3::4]), np.uint8).reshape(
            -1, MIX["read_len"]) for p in _files(got)])
    letters = [chr(q + 33).encode()[0] for q in MIX["quality_bins"]]
    assert set(np.unique(quals)) <= set(letters)
    for ch, share in zip(letters, MIX["bin_share"]):
        assert abs((quals == ch).mean() - share) < 0.01
    # the low bins lean toward the 3' end
    low = (quals == letters[0]) | (quals == letters[1])
    half = MIX["read_len"] // 2
    assert low[:, half:].mean() > 1.5 * low[:, :half].mean()
    # a base in the lowest bin is written as N
    seqs = np.concatenate([
        np.frombuffer(b"".join(_lines(p)[1::4]), np.uint8).reshape(
            -1, MIX["read_len"]) for p in _files(got)])
    assert ((seqs == ord("N")) == (quals == letters[0])).all()


# -- the FASTQ reference --------------------------------------------------------

HAND = (b"@a\nACGTN\n+\nII#II\n"       # '#' (35) masked, N invalid
        b"@b x\r\nacgt\r\n+b x\r\n5555\r\n"  # '5' is 53: kept
        b"@c\nGGA\n+\n45!\n")             # '4' (52) and '!' masked


@pytest.mark.parametrize("least_qual,want", [
    (53, [0, 1, -1, 3, -1, -1, 0, 1, 2, 3, -1, -1, 2, -1]),
    (0, [0, 1, 2, 3, -1, -1, 0, 1, 2, 3, -1, 2, 2, 0])])
def test_a_hand_written_fastq_masks_what_it_should(tmp_path, least_qual,
                                                   want):
    path = tmp_path / "h.fq"
    path.write_bytes(HAND)
    tape = fastq.read_tape(str(path), least_qual, torch.device("cpu"))
    assert tape.dtype == torch.int8 and tape.tolist() == want


def test_pieces_join_into_the_whole_tape(tmp_path, monkeypatch):
    got = _make(tmp_path, 3)
    path = _files(got)[0]
    whole = fastq.read_tape(path, 53, torch.device("cpu"))
    monkeypatch.setattr(fastq, "PIECE", 1000)
    assert len(list(fastq.read_pieces(path, 53, torch.device("cpu")))) > 2
    assert torch.equal(fastq.read_tape(path, 53, torch.device("cpu")),
                       whole)


@pytest.mark.parametrize("text", [b"@a\nAC\n+\nI\n", b"@a\nAC\n+\n",
                                  b">a\nAC\n+\nII\n"])
def test_a_file_not_of_four_line_records_is_refused(tmp_path, text):
    path = tmp_path / "bad.fq"
    path.write_bytes(text)
    with pytest.raises(ValueError):
        fastq.read_tape(str(path), 0, torch.device("cpu"))


# -- a tiny reads cell in a copy of the benchmark -------------------------------

@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    dest = tiny.bench_copy(str(tmp_path_factory.mktemp("bench")))
    b = os.path.join(dest, "kssd_bench")

    def write(path, obj):
        with open(path, "w") as f:
            json.dump(obj, f, indent=1)

    write(os.path.join(b, "configs", "test-reads-L2K6.json"), CONFIG)
    write(os.path.join(b, "traffic", "test-reads.json"), SMALL)
    cell = harness.load_json("cells", "sketch.reads-L3K10")
    cell.update(config="test-reads-L2K6", traffic="test-reads")
    write(os.path.join(b, "cells", f"{CELL}.json"), cell)
    with open(os.path.join(dest, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "sketch.reads-L3K10" in m.get("workloads", ()):
            m["workloads"].append(CELL)
    bench["workloads"].append({"name": CELL, "config": "test-reads-L2K6",
                               "traffic": "test-reads", "chips": 1,
                               "why": "test only"})
    write(os.path.join(dest, "BENCHMARK.json"), bench)
    return dest


def test_the_cell_command_passes_the_configurations_filters():
    cell = harness.load_json("cells", "sketch.reads-L3K10")
    config = harness.load_json("configs", cell["config"])
    from kssd_bench.checks import read_sets

    ctx = type("Ctx", (), {"cell": cell, "config": config})
    assert read_sets.filters(ctx) == {"least_qual": 53,
                                      "least_num_kmer": 2}
    ctx.cell = dict(cell, argv=[("3" if a == "2" else a)
                                for a in cell["argv"]])
    with pytest.raises(ValueError):
        read_sets.filters(ctx)


@pytest.mark.parametrize("trace_on", [0, 1])
def test_a_tiny_reads_cell_is_correct(copy, trace_on):
    r = tiny.cpu_run(copy, CELL, trace_on)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert all(c["value"] == 0 for c in r["checks"].values())
    if trace_on:
        got = r["metrics"]
        assert got["exc_per_batch.sketch"]["value"] > 4096
        assert 0 <= got["exc_build_share.sketch"]["value"] < 100
        assert 0 < got["abundance_share.sketch"]["value"] < 100
    else:
        assert "sketch_Mbase_s" in r["metrics"]


IGNORE_N = """
import rabbitkssd_tpu_torch.engine.sketcher as sk
_init = sk.GenomeFinalizer.__init__
def init(self, feeder, p, least_num_kmer):
    _init(self, feeder, p, 1)
sk.GenomeFinalizer.__init__ = init
"""


def test_a_program_that_ignores_n_reads_incorrect(copy):
    r = tiny.cpu_run(copy, CELL, patch=IGNORE_N)
    assert r["correct"] is False
    assert r["checks"]["genomes_differing"]["value"] == 3


@pytest.mark.parametrize("control", [None, {"least_qual": 0}])
def test_the_control_reads_above_the_limits(copy, control):
    rc, out, err = tiny.run_in(copy, f"""
from kssd_bench import controls
print(json.dumps(controls.readings({CELL!r}, 2 ** 33 + 1, "cpu",
                                   {control!r})))
""")
    assert rc == 0, err[-3000:]
    got = json.loads(out.strip().splitlines()[-1])
    if control is None:
        assert got["control"] == {"least_num_kmer": 1}
        assert got["readings"]["genomes_differing"] == 3
    else:
        assert got["readings"]["genomes_differing"] > 0
