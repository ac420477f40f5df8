"""Staging of sketch batches (``engine/sketcher.py``).

The feeder writes each batch's rows into a destination it is given (a
slot of :class:`_StagingRing`, page-locked on CUDA), and the ring hands
a slot out again only once the copies from it have ended.  The CPU
tests run the ring with unpinned slots, with its own fence or a fake
one that lags; the ``cuda`` test runs the real ring on the card
(``python -m pytest tests/test_torch_staging.py -m cuda``).  Nothing
here imports JAX.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from rabbitkssd_tpu_torch.engine import sketcher
from rabbitkssd_tpu_torch.engine.sketcher import (DeviceSketcher,
                                                  StreamStep,
                                                  WordTapeFeeder,
                                                  _StagingRing, _TapeBatch,
                                                  aligned_halo)
from rabbitkssd_tpu_torch.ops.kmer import encode_concat, pad_exceptions
from rabbitkssd_tpu_torch.oracle import sketch_records_oracle
from rabbitkssd_tpu_torch.parallel.sharded import Mesh
from rabbitkssd_tpu_torch.params import KssdParams
from rabbitkssd_tpu_torch.seqio import read_records
from rabbitkssd_tpu_torch.shuffle import generate_shuffle

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
BLOCK, HALO = 2048, 32
DIRT = 0xDEADBEEF


class Fence:
    """A CUDA event's three calls; pending from ``record`` until
    ``synchronize``, or until ``query`` has been asked ``lag`` times."""

    def __init__(self, lag=None):
        self.lag = lag
        self.pending = False
        self.asked = 0
        self.syncs = 0

    def record(self):
        self.pending = True
        self.asked = 0

    def query(self):
        if self.pending and self.lag is not None:
            self.asked += 1
            self.pending = self.asked < self.lag
        return not self.pending

    def synchronize(self):
        self.syncs += 1
        self.pending = False


def _golden_codes():
    return [encode_concat([(r.seq, r.qual) for r in read_records(f)])
            for f in sorted(glob.glob(os.path.join(GOLDEN, "genomes",
                                                   "*.fna")))]


def _chunked(rows):
    """One genome of 3.2 batches with N runs, in 1000-base int8 chunks
    (not word-aligned, so the feeder stages their ends)."""
    rng = np.random.default_rng(7)
    g = rng.integers(0, 4, size=int(3.2 * rows * BLOCK)).astype(np.int8)
    g[500:530] = -1
    g[rows * BLOCK - 40: rows * BLOCK + 40] = -1
    return [iter([g[i:i + 1000] for i in range(0, len(g), 1000)])]


def _tail(rows):
    """A tape whose second and last batch holds 112 bases (pads
    included): its other rows are past the tape."""
    rng = np.random.default_rng(8)
    return [rng.integers(0, 4, size=rows * BLOCK - 50).astype(np.int8),
            rng.integers(0, 4, size=150).astype(np.int8)]


SOURCES = {"golden": lambda rows: _golden_codes(), "chunked": _chunked,
           "tail": _tail}


@pytest.mark.parametrize("case", list(SOURCES))
@pytest.mark.parametrize("mesh_size", [1, 3])
def test_batches_in_a_dirty_destination_equal_the_default(case, mesh_size):
    rows = 2 * mesh_size
    nw_row = (BLOCK + HALO) // 16 + 2
    dest = np.full((rows, nw_row), DIRT, np.uint32)
    dest[:, -2:] = 0  # as a slot is made
    want = list(WordTapeFeeder(iter(SOURCES[case](rows)), rows, BLOCK,
                               HALO))
    n = 0
    for b, w in zip(WordTapeFeeder(iter(SOURCES[case](rows)), rows, BLOCK,
                                   HALO, rows_out=lambda: dest), want,
                    strict=True):
        assert b.words is dest
        np.testing.assert_array_equal(b.words, w.words)
        np.testing.assert_array_equal(b.exc, w.exc)
        assert (b.base, b.valid_upto, b.end) == (w.base, w.valid_upto,
                                                 w.end)
        assert not dest[:, -2:].any()
        # rows that start (halo included) past the tape read zero
        past = -(-b.valid_upto // 16)
        first = next(r for r in range(rows + 1)
                     if r == rows or r * BLOCK // 16 - HALO // 16 >= past)
        assert not dest[first:].any()
        if b.valid_upto < BLOCK:
            assert first < rows
        dest[:, :-2] = DIRT  # the next batch finds the slot dirty again
        n += 1
    assert n == len(want) >= 2
    if case == "tail":
        assert want[-1].valid_upto == 112


def test_a_slot_is_written_only_after_its_fence():
    ring = _StagingRing(3, 2, 10, 7, pin=False, fence=Fence)
    taken = []
    for i in range(7):
        rows = ring.take()
        assert not ring.slot.fence.pending  # nothing in flight from it
        rows[:, :8] = i
        taken.append(ring.slot)
        ring.sent()
    assert taken[:3] == taken[3:6] and taken[6] is taken[0]
    # the first pass found fresh slots; every later take waited
    assert ring.waits == 4
    assert [s.fence.syncs for s in ring.slots] == [2, 1, 1]
    assert not ring.slots[0].words[:, 8:].any()  # pad columns


def test_a_finished_copy_is_not_waited_on():
    ring = _StagingRing(2, 1, 4, 7, pin=False, fence=lambda: Fence(lag=1))
    for _ in range(6):
        ring.take()
        ring.sent()
    assert ring.waits == 0
    assert all(s.fence.syncs == 0 for s in ring.slots)


def test_a_larger_exception_bucket_grows_the_slot_once():
    ring = _StagingRing(2, 1, 4, 9999, pin=False, fence=Fence)
    ring.take()
    small = ring.slot.exc
    assert len(small) == 4096
    exc = np.arange(5000, dtype=np.int32)
    e = ring.exceptions(exc)
    np.testing.assert_array_equal(e.numpy(), pad_exceptions(exc, 9999))
    grown = ring.slot.exc
    assert len(grown) == 8192 and grown is not small
    assert e.data_ptr() == grown.data_ptr()
    ring.sent()
    ring.take()  # the other slot keeps its region
    assert len(ring.slot.exc) == 4096
    ring.take()
    # fewer than the last batch: its surplus is padded again
    for k in (3000, 10, 0, 5000, 4096, 4097):
        e = ring.exceptions(exc[:k] + 1)
        assert ring.slot.exc is grown
        np.testing.assert_array_equal(e.numpy(),
                                      pad_exceptions(exc[:k] + 1, 9999))


@pytest.mark.parametrize("rank", [0, 1, 2])
def test_a_rank_uploads_its_own_rows_of_the_slot(monkeypatch, rank):
    sk = object.__new__(DeviceSketcher)
    sk.mesh, sk.n_blocks, sk.block = Mesh(3, 1), 2, BLOCK
    sk.params = KssdParams(10, 6, 3)
    monkeypatch.setattr(sketcher, "rank", lambda: rank)
    ring = _StagingRing(1, 6, 4, 7, pin=False, fence=Fence)
    ring.take()
    flat = 2 * (BLOCK + HALO)
    exc = np.array([3, flat + 5, 2 * flat + 7], np.int32)
    b = sk._local(_TapeBatch(ring.slot.words, exc, 0, 3 * 2 * BLOCK,
                             3 * 2 * BLOCK))
    assert b.words.data_ptr() == ring.slot.words[2 * rank].data_ptr()
    assert b.words.shape == (2, 4)
    assert b.exc.tolist() == [[3, 5, 7][rank]]


@pytest.mark.parametrize("budget,want",
                         [({"slot_waits": 3, "batches": 12}, 0.25),
                          ({"batches": 12}, None)], ids=["ring", "no key"])
def test_the_slot_waits_metric_reads_the_budget(budget, want):
    """``kssd_bench``'s reader: waits over batches, summed over the
    window; nothing where the budget has no ``slot_waits`` (a tree
    without the ring)."""
    from kssd_bench import harness

    line = [(0.1, "sketch budget: " + json.dumps(budget))]
    rec = harness.Record(config={}, work={}, setup_s=1.0, trace=None,
                         extras={}, passes=[harness.Pass("x", t, t + 1.0,
                                                         line, None)
                                            for t in (0.0, 1.0)])
    metric = harness.load_module("metrics", "slot_waits_per_batch.sketch")
    assert metric.read(rec) == want


def _corpus():
    """36 batches of 2 x 2048 bases; one batch wholly inside a run of
    N, so its exception list (4,128 flat positions) exceeds 4,096."""
    rng = np.random.default_rng(11)
    out = []
    for n in [30_000, 700, 9_000, 45_000, 5, 60_000]:
        g = rng.integers(0, 4, size=n).astype(np.int8)
        if n > 100:
            st = int(rng.integers(0, n - 60))
            g[st:st + int(rng.integers(1, 40))] = -1
        out.append(g)
    out[3][10_000:19_000] = -1
    return out


def _sketch(device, genomes, cap=None, fence=None):
    """(sets, budget, ring) of a sketcher of 2 x BLOCK batches at
    (8, 4, 1); with a ``fence`` class, its ring is one of 3 unpinned
    slots with that fence."""
    params = KssdParams(8, 4, 1)
    shuf = generate_shuffle(8, 4, 1)
    sk = DeviceSketcher(params, shuf.shuffled_dim, device=device,
                        n_blocks=2, block=BLOCK)
    if cap is not None:
        sk.cap = cap
        sk.step = StreamStep(params, cap, sk.buf_cap)
    if fence is not None:
        row = BLOCK + aligned_halo(params)
        sk._staging_ring = _StagingRing(3, 2, row // 16 + 2, 2 * row,
                                        pin=False, fence=fence)
    got, n = sk.sketch_codes(iter([g.copy() for g in genomes]))
    assert n == len(genomes)
    return got, sk.last_budget, sk._staging_ring


def _oracle(genomes):
    """The numpy oracle's sets of the code arrays (-1 read as N)."""
    shuf = generate_shuffle(8, 4, 1)
    acgtn = np.frombuffer(b"ACGTN", np.uint8)
    return [sketch_records_oracle(
        [(acgtn[np.where(g < 0, 4, g)].tobytes(), None)],
        KssdParams(8, 4, 1), shuf.shuffled_dim) for g in genomes]


def _assert_equal(got, want):
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(a, b, err_msg=f"genome {i}")


@pytest.mark.parametrize("cap", [None, 64], ids=["fits", "overflows"])
def test_sketch_through_a_ring_equals_the_plain_path(cap):
    """A 3-slot ring whose fences lag, against the CPU sketcher's own
    ring and both against the numpy oracle: more batches than slots,
    every reuse waits on a pending fence, one batch grows its slot's
    exceptions, and an overflowing window re-runs from the pending
    batches' own tensors after their slots were written again."""
    genomes = _corpus()
    want, plain, _ = _sketch("cpu", genomes)
    _assert_equal(want, _oracle(genomes))
    got, b, ring = _sketch("cpu", genomes, cap=cap, fence=Fence)
    _assert_equal(got, want)
    assert b["batches"] == plain["batches"] > 3 * len(ring.slots)
    assert b["slot_waits"] == b["batches"] - 3
    assert plain["slot_waits"] == 0
    assert 0 <= b["pin"] <= b["h2d_put"] and b["feed"] >= 0
    regions = sorted(len(s.exc) for s in ring.slots)
    assert regions[0] == 4096 and regions[-1] == 8192
    if cap is not None:
        assert b["reruns"] == b["batches"]


def test_a_cpu_sketcher_stages_through_its_own_ring():
    """With nothing injected, a CPU sketcher stages every batch through
    its ring of unpinned slots, whose fence never waits, and its sets
    equal the oracle's."""
    genomes = _corpus()
    got, b, ring = _sketch("cpu", genomes)
    _assert_equal(got, _oracle(genomes))
    assert isinstance(ring, _StagingRing)
    assert not any(s.words.is_pinned() or s.exc.is_pinned()
                   for s in ring.slots)
    # every batch took the next slot; none waited
    assert b["batches"] > len(ring.slots)
    assert ring._i == (b["batches"] - 1) % len(ring.slots)
    assert ring.waits == b["slot_waits"] == 0
    # the batch inside a run of N grew its slot's exceptions
    assert max(len(s.exc) for s in ring.slots) == 8192
    assert 0 <= b["pin"] <= b["h2d_put"] and b["pinned_allocs"] == 0


@pytest.mark.cuda
def test_the_card_ring_equals_the_cpu_path(tmp_path):
    """On the card: the real ring, with more batches than slots, a batch
    over the 4,096-entry region and a window forced into the re-run;
    then a second command in the process pins no new block."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ring pins host memory")
    from kssd_bench.harness import run_command
    from rabbitkssd_tpu_torch import cli

    genomes = _corpus()
    want, plain, _ = _sketch("cpu", genomes)
    for cap in (None, 64):
        got, b, _ = _sketch("cuda", genomes, cap=cap)
        _assert_equal(got, want)
        assert b["batches"] == plain["batches"] > sketcher._QUEUE_DEPTH + 2
        assert b["reruns"] == (0 if cap is None else b["batches"])
        assert 0 <= b["pin"] <= b["h2d_put"]
        assert b["slot_waits"] >= 0
    cwd = os.getcwd()
    os.chdir(GOLDEN)
    try:
        passes = [run_command(
            cli, ["--device", "cuda", "sketch", "-q", "-i", "fa.list", "-L",
                  "k8s4l1.shuf", "-o", str(tmp_path / f"{i}.sketch")],
            str(tmp_path / f"{i}.sketch"), torch.device("cuda"))
            for i in range(2)]
    finally:
        os.chdir(cwd)
    for p in passes:
        assert p.error is None, p.error
    assert passes[1].budget["batches"] >= 1
    assert passes[1].budget["pinned_allocs"] == 0, passes[1].budget
