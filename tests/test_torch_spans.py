"""The port's spans and budget counters inside ``sketch``, on the CPU.

The CLI's stderr is read as the benchmark reads it
(``kssd_bench.harness``: each line stamped as it arrives, ``PHASE``
matching the span lines): the spans inside the command nest as the
benchmark's idle-gap names assume, and the budget's parts stay inside
their roles.
"""

import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from kssd_bench.harness import PHASE, run_command
from rabbitkssd_tpu_torch import cli
from rabbitkssd_tpu_torch.engine import sketcher
from rabbitkssd_tpu_torch.utils import timers

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
OUTER = "computing sketches and save sketches into file"
INNER = ("keep table build", "keep table upload", "stream pipeline",
         "save sketches")
NEW = ("read shuffle file",) + INNER
NEW_KEYS = ("parse_wait", "pin", "pinned_allocs", "consumer_cpu",
            "slot_waits")
# a span's start is its printed end less its seconds: print latency
SLACK = 0.05


def _sketch_argv(out: str) -> list[str]:
    return ["--device", "cpu", "sketch", "-q", "-i", "fa.list", "-L",
            "k8s4l1.shuf", "-o", out]


@pytest.fixture(scope="module")
def cli_pass(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("spans") / "x.sketch")
    cwd = os.getcwd()
    os.chdir(GOLDEN)
    try:
        p = run_command(cli, _sketch_argv(out), out, torch.device("cpu"))
    finally:
        os.chdir(cwd)
    assert p.error is None, p.error
    return p


def check_budget(b: dict, cuda: bool = False) -> None:
    """The new keys of ``last_budget`` inside the roles they part."""
    assert set(NEW_KEYS) <= set(b)
    assert 0 <= b["parse_wait"] <= b["feed"]
    assert 0 <= b["pin"] <= b["h2d_put"]
    # the consumer's CPU time over its loop of dispatches and waits
    assert 0 <= b["consumer_cpu"] <= 1.05 * (b["dispatch"] + b["qwait"]) \
        + 0.02
    assert isinstance(b["pinned_allocs"], int) and b["pinned_allocs"] >= 0
    assert isinstance(b["slot_waits"], int)
    assert 0 <= b["slot_waits"] <= b["batches"]
    if not cuda:
        # the CPU stages through an unpinned ring whose copies have
        # ended when they return
        assert 0 <= b["pin"] <= b["h2d_put"] and b["pinned_allocs"] == 0
        assert b["slot_waits"] == 0


def test_cli_sketch_spans_nest(cli_pass):
    spans = [(n, t - s, t) for n, s, t in cli_pass.phases]
    names = [n for n, _, _ in spans]
    for n in NEW + (OUTER,):
        assert names.count(n) == 1, (n, names)
    at = {n: (a, b) for n, a, b in spans}
    outer = at[OUTER]
    assert at["read shuffle file"][1] <= outer[0] + SLACK
    for n in INNER:
        a, b = at[n]
        assert outer[0] - SLACK <= a <= b <= outer[1] + SLACK, n
    order = [at[n][0] for n in INNER]
    assert order == sorted(order)
    # the pipeline span holds the budget's wall
    assert at["stream pipeline"][1] - at["stream pipeline"][0] >= \
        cli_pass.budget["wall"] - 1e-3


def test_cli_sketch_budget_parts(cli_pass):
    check_budget(cli_pass.budget)


def test_cli_sketch_budget_keep_keys(cli_pass):
    """The keep tables' copy (bitmap, summary and kept pairs, far below
    the 2^16-entry table) and the shuffle pass's threads: the thread
    budget where the native library loads."""
    from rabbitkssd_tpu_torch.native import load_native
    from rabbitkssd_tpu_torch.parallel.multihost import thread_budget

    b = cli_pass.budget
    assert 0 < b["keep_bytes_up"] < 4 << 16
    assert b["keep_threads"] == (thread_budget() if load_native() else 0)


def _budget_of(stderr: str) -> dict:
    (line,) = [ln for ln in stderr.splitlines()
               if ln.startswith("sketch budget: ")]
    return json.loads(line[len("sketch budget: "):])


@pytest.mark.parametrize("stats,want", [({}, None),
                                        ({"num_host_alloc": 3}, 3)],
                         ids=["no count", "count"])
def test_pinned_allocs_reads_none_without_the_count(monkeypatch, stats,
                                                    want):
    """On CUDA the count is the allocator's own, and None (not 0) where
    this torch keeps none; off CUDA no block is pinned."""
    sk = object.__new__(sketcher.DeviceSketcher)
    sk.device = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "host_memory_stats", lambda: stats)
    assert sk._pinned_allocs() == want
    sk.device = torch.device("cpu")
    assert sk._pinned_allocs() == 0


@pytest.mark.cuda
def test_first_sketch_of_a_process_pins_new_blocks(tmp_path):
    """A fresh process's first sketch on the card makes pinned blocks:
    the counter reads the allocator, not a missing key's 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: nothing is pinned without one")
    argv = _sketch_argv(str(tmp_path / "x.sketch"))
    argv[1] = "cuda"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]))
    p = subprocess.run(
        [sys.executable, "-m", "rabbitkssd_tpu_torch.cli", *argv],
        cwd=GOLDEN, env=env, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    b = _budget_of(p.stderr)
    check_budget(b, cuda=True)
    assert b["batches"] >= 1 and b["pinned_allocs"] > 0, b


def test_timer_off_prints_no_span(tmp_path):
    env = dict(os.environ, KSSD_TIMER="0",
               PYTHONPATH=os.pathsep.join(
                   [ROOT, os.environ.get("PYTHONPATH", "")]))
    p = subprocess.run(
        [sys.executable, "-m", "rabbitkssd_tpu_torch.cli",
         *_sketch_argv(str(tmp_path / "x.sketch"))], cwd=GOLDEN, env=env,
        capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    lines = p.stderr.splitlines()
    assert not [ln for ln in lines if PHASE.match(ln)]
    assert any(ln.startswith("sketch budget: ") for ln in lines)


def test_parse_wait_counts_the_wait_on_a_parse(monkeypatch):
    """A parser slower than the stream: the producer's wait on it is
    part of ``feed`` and at least the parser's own delay."""
    from rabbitkssd_tpu_torch import native
    from rabbitkssd_tpu_torch.engine.sketcher import sketch_file_list
    from rabbitkssd_tpu_torch.shuffle import read_shuffle_file

    slow = native.fasta_packed

    def fasta_packed(path, least_qual):
        time.sleep(0.05)
        return slow(path, least_qual)

    monkeypatch.setattr(native, "fasta_packed", fasta_packed)
    monkeypatch.chdir(GOLDEN)
    shuf = read_shuffle_file("k8s4l1.shuf")
    got = []
    real = sketcher.DeviceSketcher.sketch_codes

    def sketch_codes(self, codes):
        out = real(self, codes)
        got.append(self.last_budget)
        return out

    monkeypatch.setattr(sketcher.DeviceSketcher, "sketch_codes",
                        sketch_codes)
    sketch_file_list("fa.list", shuf, device="cpu", threads=1,
                     n_blocks=4, block=1 << 14)
    (b,) = got
    check_budget(b)
    # one thread parses 7 genomes in turn, each after a 0.05 s delay
    assert b["parse_wait"] >= 0.2


def test_prefetch_chunks_reports_its_waits():
    def slow():
        for i in range(3):
            time.sleep(0.03)
            yield np.full(4, i, np.int8)

    waits = []
    got = list(sketcher._prefetch_chunks(
        slow(), waited=lambda t0: waits.append(time.perf_counter() - t0)))
    assert [int(c[0]) for c in got] == [0, 1, 2]
    # three items and the end
    assert len(waits) == 4
    assert sum(waits) >= 0.05 and all(math.isfinite(w) for w in waits)


def test_nested_span_records_no_trace_of_its_own(tmp_path, monkeypatch,
                                                 capsys):
    """Under ``KSSD_PROFILE_DIR`` the outermost span alone is traced;
    the spans inside it still print."""
    monkeypatch.setattr(timers, "PROFILE_DIR", str(tmp_path))
    with timers.phase("outer span"):
        with timers.phase("inner span"):
            torch.arange(10).sum()
    assert [f.split(".")[0] for f in os.listdir(tmp_path)] == ["outer_span"]
    printed = [PHASE.match(ln).group(1)
               for ln in capsys.readouterr().err.splitlines()]
    assert printed == ["inner span", "outer span"]
    with timers.phase("next span"):
        pass
    assert len(os.listdir(tmp_path)) == 2
