"""A cell on several ranks, one for each of its ``chips``, on the CPU over
gloo: the run is correct and writes the one-rank run's bytes; a command
that fails on one rank fails the run's ``correct``; a worker that dies,
or a rank left waiting in the program's collective, ends the run with an
error within the harness's bound; no process outlives a run; a cell
on one chip starts no process; and the exchange between ranks, a
rank's share of each batch, an answer or half the stream steps broken
underneath reads incorrect."""

from __future__ import annotations

import json
import os
import sys
import time

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import kssd_bench_tiny as tiny  # noqa: E402

sys.path.insert(0, tiny.ROOT)

ONE = "sketch.test-L2K6"
# a corpus over one batch of rows a rank (16 x 2^17 bases), so that rank
# 1 has rows of its own: on one rank and on two (the card check is off
# on the CPU, so two chips here are two ranks on the CPU)
BIG, TWO = "sketch.test-L2K6.big", "sketch.test-L2K6.2rank"
MIX = dict(tiny.MIXES["test-genomes"], n_genomes=5, genome_len=1_000_000)
SEED = 2 ** 31 + 29


def _write(path: str, obj) -> None:
    with open(path, "w") as f:
        json.dump(obj, f, indent=1)


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    """The tiny copy with ``ONE`` on the larger corpus, on one rank and on
    two, added as files and in the copy's ``BENCHMARK.json`` where
    ``ONE`` is."""
    dest = tiny.bench_copy(str(tmp_path_factory.mktemp("bench")))
    b = os.path.join(dest, "kssd_bench")
    _write(os.path.join(b, "traffic", "test-big.json"), MIX)
    with open(os.path.join(b, "cells", f"{ONE}.json")) as f:
        cell = json.load(f)
    cell["traffic"] = "test-big"
    _write(os.path.join(b, "cells", f"{BIG}.json"), cell)
    _write(os.path.join(b, "cells", f"{TWO}.json"), dict(cell, chips=2))
    path = os.path.join(dest, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    for m in bench["end_to_end"] + bench["per_layer"]:
        if ONE in m.get("workloads", ()):
            m["workloads"] += [BIG, TWO]
    bench["workloads"] += [{"name": n, "config": "test-L2K6",
                            "traffic": "test-big", "chips": c,
                            "why": "test only"}
                           for n, c in ((BIG, 1), (TWO, 2))]
    _write(path, bench)
    # the reference's shuffle file, cached before any run is counted
    from kssd_bench import harness
    import torch

    harness.shuffle_file(tiny.CONFIG["sizes"], torch.device("cpu"))
    return dest


# code run in the harness process first: every process it starts is
# written to PIDS; the last command's output is kept as KEPT; the run's
# work directory is WORK, so that the genome files' names, which a
# .sketch file holds, are the same in every run
RECORD = """
import os, shutil, subprocess
def mkdtemp(prefix=""):
    os.makedirs({work!r})
    return {work!r}
import tempfile
tempfile.mkdtemp = mkdtemp
_Popen = subprocess.Popen
class Popen(_Popen):
    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        with open({pids!r}, "a") as f:
            f.write(f"{{self.pid}}\\n")
subprocess.Popen = Popen
from kssd_bench import harness
_context = harness.check_context
def check_context(cell, config, traffic, values, dev, outputs):
    shutil.copy(outputs[-1], {kept!r})
    return _context(cell, config, traffic, values, dev, outputs)
harness.check_context = check_context
"""

# code that plants a fault in each worker, before it serves
WORKER = """
from kssd_bench import ranks
_argv = ranks.worker_argv
def worker_argv():
    a = _argv()
    a[2] = a[2].replace("from kssd_bench.ranks", {fault!r} + "\\nfrom kssd_bench.ranks")
    return a
ranks.worker_argv = worker_argv
"""

RUN = f"""
from kssd_bench import harness
r = harness.run({{cell!r}}, {SEED}, 1.0, False, start, device="cpu",
                require_card=False)
r["ranks_imported"] = "kssd_bench.ranks" in sys.modules
print(json.dumps(r))
"""


def _alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def _run(copy: str, tmp_path, cell: str, patch: str = "",
         fault: str = "") -> tuple[int, dict | None, str, list[int], float]:
    """(exit code, result or None, stderr, processes started, seconds)."""
    pids, kept = str(tmp_path / "pids"), str(tmp_path / "kept.sketch")
    code = RECORD.format(pids=pids, kept=kept,
                         work=os.path.join(copy, "work")) + patch
    if fault:
        code += WORKER.format(fault=fault)
    t = time.monotonic()
    rc, out, err = tiny.run_in(copy, code + RUN.format(cell=cell))
    took = time.monotonic() - t
    started = []
    if os.path.exists(pids):
        with open(pids) as f:
            started = [int(x) for x in f.read().split()]
    lines = out.strip().splitlines()
    result = json.loads(lines[-1]) if rc == 0 and lines else None
    return rc, result, err, started, took


def test_two_ranks_are_correct_and_write_the_one_rank_bytes(copy, tmp_path):
    one, two = tmp_path / "one", tmp_path / "two"
    one.mkdir()
    two.mkdir()
    rc, r1, err, started, _ = _run(copy, one, BIG)
    assert rc == 0, err[-3000:]
    assert r1["correct"] and not started
    rc, r2, err, started, _ = _run(copy, two, TWO)
    assert rc == 0, err[-3000:]
    assert r2["correct"] and r2["failed"] == 0 and r2["attempted"] >= 1
    assert r2["ranks_imported"] and len(started) == 1
    assert not any(_alive(p) for p in started)
    assert "ranks" in r2["_stages"]
    assert (one / "kept.sketch").read_bytes() == (
        two / "kept.sketch").read_bytes()
    assert set(r2["metrics"]) == set(r1["metrics"])


def test_a_cell_on_one_chip_starts_no_process(copy, tmp_path):
    rc, r, err, started, _ = _run(copy, tmp_path, ONE)
    assert rc == 0, err[-3000:]
    assert r["correct"]
    assert started == [] and r["ranks_imported"] is False
    assert "ranks" not in r["_stages"]


# a rank's command fails after the program's barrier: the others end it
FAIL_AFTER = """
import os
if os.environ["RANK"] == "1":
    from rabbitkssd_tpu_torch import cli
    _main, calls = cli.main, [0]
    def main(argv=None):
        rc = _main(argv)
        calls[0] += 1
        if calls[0] == 2:
            raise RuntimeError("planted after the barrier")
        return rc
    cli.main = main
"""


def test_a_rank_whose_command_fails_makes_the_run_incorrect(copy, tmp_path):
    rc, r, err, started, _ = _run(copy, tmp_path, TWO, fault=FAIL_AFTER)
    assert rc == 0, err[-3000:]
    assert r["correct"] is False and r["failed"] == 1
    assert any("rank 1:" in f and "planted after the barrier" in f
               for f in r["_failures"])
    assert len(started) == 1 and not any(_alive(p) for p in started)


# rank 1 dies at the start of its first timed command
KILL = """
import os, signal
if os.environ["RANK"] == "1":
    from rabbitkssd_tpu_torch import cli
    _main, calls = cli.main, [0]
    def main(argv=None):
        calls[0] += 1
        if calls[0] == 2:
            os.kill(os.getpid(), signal.SIGKILL)
        return _main(argv)
    cli.main = main
"""

# rank 1 raises before the program's first collective: rank 0 waits there
RAISE_BEFORE = KILL.replace("os.kill(os.getpid(), signal.SIGKILL)",
                            'raise RuntimeError("planted before")')
BOUND = "from kssd_bench import ranks\nranks.ANSWER_S = 5.0\n"


@pytest.mark.parametrize("fault", ["killed", "raised_inside"])
def test_a_lost_rank_ends_the_run_with_an_error_in_the_bound(
        copy, tmp_path, fault):
    rc, r, err, started, took = _run(
        copy, tmp_path, TWO, patch=BOUND,
        fault=KILL if fault == "killed" else RAISE_BEFORE)
    assert rc == 3 and r is None
    assert "kssd_bench: ranks: rank" in err
    if fault == "killed":
        assert "rank 1 exited with code -9" in err
    else:
        # rank 0 waits in the program's collective for rank 1
        assert "rank(s) [0] gave no answer for command 1" in err
        assert "planted before" in err
    # set-up and a warm-up, then the bound: far below the collective's
    # ten minutes
    assert took < 120
    assert len(started) == 1 and not any(_alive(p) for p in started)


# broken underneath on every rank (rank 0 in the harness process, the
# others before they serve): the exchange of survivors left out; rank
# 1's share of each batch left out; an answer altered where rank 0
# finalises it; every second stream step returning its state unchanged
EXCHANGE = """
import rabbitkssd_tpu_torch.engine.sketcher as sk
sk.allgather_columns = lambda x: [x]
"""
SHARE = """
import os
import rabbitkssd_tpu_torch.engine.sketcher as sk
if os.environ.get("RANK", "0") == "1":
    _local = sk.DeviceSketcher._local
    def local(self, b):
        import dataclasses
        return dataclasses.replace(_local(self, b), valid_upto=0)
    sk.DeviceSketcher._local = local
"""
ANSWER = """
import os
import rabbitkssd_tpu_torch.engine.sketcher as sk
if os.environ.get("RANK", "0") == "0":
    _finish = sk.GenomeFinalizer.finish
    def finish(self):
        out, n = _finish(self)
        out[0] = out[0][1:]
        return out, n
    sk.GenomeFinalizer.finish = finish
"""
STEPS = """
import rabbitkssd_tpu_torch.engine.sketcher as sk
_call = sk.StreamStep.__call__
calls = [0]
def call(self, words, exc, tables, bufs, count, overflow, *a):
    calls[0] += 1
    if calls[0] % 2 == 0:
        return count, overflow
    return _call(self, words, exc, tables, bufs, count, overflow, *a)
sk.StreamStep.__call__ = call
"""
FAULTS = {"exchange_left_out": EXCHANGE, "rank_share_left_out": SHARE,
          "answer_altered": ANSWER, "half_the_steps": STEPS}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_program_on_ranks_reads_incorrect(copy, tmp_path, fault):
    code = FAULTS[fault]
    rc, r, err, started, _ = _run(copy, tmp_path, TWO,
                                  patch=code, fault=code)
    assert rc == 0, err[-3000:]
    assert r["correct"] is False and r["failed"] == 0
    assert any(c["value"] > c["limit"] for c in r["checks"].values())
    assert not any(_alive(p) for p in started)


# a worker that answers at once, without the program: its peak is the
# number of commands it saw
FAKE = """
import os, sys
from multiprocessing.connection import Connection
pipe = Connection(int(sys.argv[1]))
rank = int(os.environ["RANK"])
pipe.send({"ready": rank})
k = 0
while pipe.recv()["op"] != "end":
    pipe.send({"done": k, "error": None})
    k += 1
pipe.send({"end": rank, "memory_peak": k, "leaked": []})
"""


def test_more_ranks_than_cores_answer_every_command(tmp_path, monkeypatch):
    """The control thread and the caller share the answers: with more
    workers than cores and a short switch interval, every command of
    many is answered by every worker, in order, and every worker ends."""
    import types

    import torch

    from kssd_bench import ranks

    monkeypatch.setattr(ranks, "worker_argv",
                        lambda: [sys.executable, "-c", FAKE])
    cli = types.SimpleNamespace(main=lambda argv: 0)
    n, commands = 2 * (os.cpu_count() or 1) + 1, 300
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        group = ranks.Ranks(n, "cpu", str(tmp_path / "work"))
        try:
            passes = [group.command(cli, [], "x", torch.device("cpu"))
                      for _ in range(commands)]
            peak, leaked = group.finish()
        finally:
            group.close()
    finally:
        sys.setswitchinterval(interval)
    assert all(p.error is None and p.t1 >= p.t0 for p in passes)
    assert peak == commands and leaked == []
    assert all(p.poll() == 0 for p in group.procs.values())
