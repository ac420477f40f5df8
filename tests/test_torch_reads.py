"""The port's ``sketch`` of FASTQ read sets with the quality mask (``-Q``)
and the abundance filter (``-n``), held to the plain reference
``kssd_bench/reference/fastq.py`` on seeded Illumina-like read sets
(``kssd_bench/traffic/fastq_reads.py``).

Read sets put far more invalid positions on the exception path than
assemblies do: one a read end, and one a masked base.  The CPU tests
run the CLI, and the page-locked ring's rotation with unpinned slots
and a fake fence at a small block; the ``cuda`` test runs the real ring
on the card (``python -m pytest tests/test_torch_reads.py -m cuda``).
Nothing here imports JAX.
"""

import json
import os

import numpy as np
import pytest
import torch

from kssd_bench.harness import run_command
from kssd_bench.reference import fastq, kssd
from kssd_bench.reference import shuffle as ref_shuffle
from kssd_bench.reference import sketchfile
from kssd_bench.traffic import fastq_reads
from rabbitkssd_tpu_torch import cli
from rabbitkssd_tpu_torch.engine.sketcher import DeviceSketcher, \
    WordTapeFeeder, _StagingRing, aligned_halo
from rabbitkssd_tpu_torch.params import KssdParams
from rabbitkssd_tpu_torch.shuffle import read_shuffle_file
from rabbitkssd_tpu_torch.seqio import read_list

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHUF = os.path.join(ROOT, "tests", "golden", "k8s4l1.shuf")
SIZES = kssd.KssdSizes(8, 4, 1)
with open(os.path.join(ROOT, "kssd_bench", "traffic",
                       "illumina-4x50x-2x150.json")) as _f:
    MIX = json.load(_f)


def _reads(root, seed, **change) -> dict:
    return fastq_reads.make(str(root), {**MIX, **change}, seed,
                            torch.device("cpu"))


@pytest.fixture(scope="module")
def reads(tmp_path_factory):
    """3 samples of 20-40 kb at 10x: ~0.9 Mbase, ~4.7 % of it masked at
    -Q 53 or N, one read end every 151 positions."""
    return _reads(tmp_path_factory.mktemp("reads"), 2 ** 31 + 5,
                  n_samples=3, genome_len=[20_000, 40_000], coverage=10)


def _reference(list_path, least_qual, least_num_kmer, device="cpu"):
    table = torch.from_numpy(ref_shuffle.read_table(SHUF)).to(device)
    files = sorted(read_list(list_path), key=lambda p: -os.path.getsize(p))
    return files, [fastq.sample_sketch(p, SIZES, table, least_qual,
                                       least_num_kmer)[0] for p in files]


def _sketch_cli(list_path, out, device, least_qual, least_num_kmer):
    p = run_command(cli, ["--device", device, "sketch", "-q", "-i",
                          list_path, "-L", SHUF, "-Q", str(least_qual),
                          "-n", str(least_num_kmer), "-o", out], out,
                    torch.device(device))
    assert p.error is None, p.error
    return p


def _assert_sets(names, hashes, files, want):
    assert list(names) == files
    for f, a, b in zip(files, hashes, want, strict=True):
        np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("least_qual,least_num_kmer",
                         [(0, 1), (53, 1), (53, 2)])
def test_cli_sketch_of_reads_equals_the_reference(reads, tmp_path,
                                                  least_qual,
                                                  least_num_kmer):
    out = str(tmp_path / "r.sketch")
    p = _sketch_cli(reads["paths"]["list"], out, "cpu", least_qual,
                    least_num_kmer)
    files, want = _reference(reads["paths"]["list"], least_qual,
                             least_num_kmer)
    _, names, hashes = sketchfile.read(out)
    _assert_sets(names, hashes, files, want)
    b = p.budget
    # one read end every 151 positions at least; masked bases add more
    reads_n = reads["work"]["bases"] // MIX["read_len"]
    assert b["exceptions"] >= reads_n - len(files)
    if least_qual:
        assert b["exceptions"] > reads["work"]["bases"] * 0.03
    assert 0 <= b["exc_build"] <= b["feed"]
    assert 0 <= b["abundance"] <= b["finalize"]
    if least_num_kmer == 1:
        assert b["abundance"] == 0


def test_the_filters_change_the_sketch(reads):
    """Each filter drops hashes the reference keeps without it, so each
    case above tests it."""
    lst = reads["paths"]["list"]
    sizes = [sum(h.size for h in _reference(lst, q, n)[1])
             for q, n in [(0, 1), (53, 1), (53, 2)]]
    assert sizes[0] > sizes[1] > sizes[2] > 0


class Fence:
    """A CUDA event's three calls, pending from ``record`` to
    ``synchronize``."""

    def __init__(self):
        self.pending = False

    def record(self):
        self.pending = True

    def query(self):
        return not self.pending

    def synchronize(self):
        self.pending = False


def test_a_small_block_carries_many_exceptions_through_the_ring(reads):
    """Batches of 4 x 2^15 positions, each with more than 4,096
    exceptions, through the ring's rotation on the CPU: every slot's
    region grows, and the sets equal the reference's."""
    shuf = read_shuffle_file(SHUF)
    params = KssdParams(shuf.k, shuf.subk, shuf.drlevel)
    sk = DeviceSketcher(params, shuf.shuffled_dim, device="cpu",
                        n_blocks=4, block=1 << 15, least_qual=53,
                        least_num_kmer=2)
    # 3 slots whose fences lag, in place of the sketcher's own ring
    row = sk.block + aligned_halo(params)
    ring = sk._staging_ring = _StagingRing(3, 4, row // 16 + 2, 4 * row,
                                           pin=False, fence=Fence)
    got = sk.sketch_files(read_list(reads["paths"]["list"]))
    files, want = _reference(reads["paths"]["list"], 53, 2)
    _assert_sets([s.name for s in got.sketches],
                 [s.hashes for s in got.sketches], files, want)
    b = sk.last_budget
    assert b["batches"] > len(ring.slots)
    assert b["exceptions"] > 4096 * b["batches"]
    assert all(len(s.exc) == 8192 for s in ring.slots)
    assert b["abundance"] > 0


def test_the_feeder_counts_what_it_emits():
    rng = np.random.default_rng(3)
    genomes = []
    for n in (5000, 70, 12_000):
        g = rng.integers(0, 4, size=n).astype(np.int8)
        g[rng.integers(0, n, size=n // 20)] = -1
        genomes.append(g)
    feeder = WordTapeFeeder(iter(genomes), 2, 2048, 32)
    batches = list(feeder)
    assert feeder.exc_n == sum(len(b.exc) for b in batches)
    assert feeder.exc_n >= sum(int((g < 0).sum()) for g in genomes)
    assert feeder.exc_s >= 0


@pytest.mark.parametrize("budget,want", [
    ({"exceptions": 300_000, "exc_build": 0.5, "abundance": 0.25,
      "batches": 3, "wall": 5.0}, (100_000, 10.0, 5.0)),
    ({"batches": 3, "wall": 5.0}, (None, None, None))],
    ids=["read sets", "no keys"])
def test_the_exception_metrics_read_the_budget(budget, want):
    """``kssd_bench``'s readers, summed over the window; nothing where
    the budget lacks the key (a tree without it)."""
    from kssd_bench import harness

    line = [(0.1, "sketch budget: " + json.dumps(budget))]
    rec = harness.Record(config={}, work={}, setup_s=1.0, trace=None,
                         extras={}, passes=[harness.Pass("x", t, t + 1.0,
                                                         line, None)
                                            for t in (0.0, 1.0)])
    got = tuple(harness.load_module("metrics", m).read(rec) for m in
                ("exc_per_batch.sketch", "exc_build_share.sketch",
                 "abundance_share.sketch"))
    assert got == pytest.approx(want) if want[0] else got == want


@pytest.mark.cuda
def test_the_card_ring_carries_a_read_set_batch(tmp_path):
    """On the card, at the CLI's own batch of 16 x 2^17 positions: read
    sets whose batches carry more than 65,536 exceptions each equal the
    CPU path, and a second command pins no new block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ring pins host memory")
    got = _reads(tmp_path, 2 ** 32 + 9, n_samples=2,
                 genome_len=[100_000, 150_000], coverage=30)
    lst = got["paths"]["list"]
    cpu = str(tmp_path / "cpu.sketch")
    _sketch_cli(lst, cpu, "cpu", 53, 2)
    passes = [_sketch_cli(lst, str(tmp_path / f"c{i}.sketch"), "cuda", 53,
                          2) for i in range(2)]
    with open(cpu, "rb") as f:
        want = f.read()
    for i, p in enumerate(passes):
        with open(tmp_path / f"c{i}.sketch", "rb") as f:
            assert f.read() == want
        b = p.budget
        assert b["batches"] >= 3
        assert b["exceptions"] > 65_536 * b["batches"]
    assert passes[1].budget["pinned_allocs"] == 0, passes[1].budget
