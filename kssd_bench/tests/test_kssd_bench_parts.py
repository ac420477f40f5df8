"""The readers of the program's spans inside a ``sketch`` command and of
the parts of its budget's roles: on recorded lines, on lines of a
program that lacks them (they read nothing), and on a command of the
program run here on the CPU."""

from __future__ import annotations

import json
import math
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
from kssd_bench import harness  # noqa: E402

CLI_SHARES = {"shuffle_read_share.sketch": "read shuffle file",
              "keep_build_share.sketch": "keep table build",
              "keep_upload_share.sketch": "keep table upload",
              "save_share.sketch": "save sketches"}
BUDGET_PARTS = ("parse_wait_share.sketch", "pin_share.sketch",
                "pinned_allocs_per_batch.sketch", "consumer_cpu_pct.sketch")
NEW = tuple(CLI_SHARES) + BUDGET_PARTS
OUTER = "computing sketches and save sketches into file"

BUDGET = {"feed": 1.0, "h2d_put": 0.5, "qwait": 0.25, "dispatch": 0.1,
          "flush_scalars": 0.05, "flush_collect": 0.1, "finalize": 0.1,
          "drain": 0.0, "wall": 2.0, "h2d_bytes": 10, "batches": 100,
          "reruns": 0, "exchange": 0.0}
PARTS = {"parse_wait": 0.4, "pin": 0.2, "pinned_allocs": 5,
         "consumer_cpu": 0.025}


def read(rec, name):
    return harness.load_module("metrics", name).read(rec)


def _span(name: str, s: float) -> str:
    return f"===================time of {name} is: {s:.6g}"


def _pass(t0: float, lines: list[str], span: float) -> harness.Pass:
    return harness.Pass("x", t0, t0 + span,
                        [(t0 + 0.1 * (i + 1), ln) for i, ln in
                         enumerate(lines)], None)


def _record(lines: list[str], span: float = 4.0) -> harness.Record:
    return harness.Record(config={}, work={}, setup_s=1.0, trace=None,
                          extras={}, passes=[_pass(0.0, lines, span),
                                             _pass(span, lines, span)])


def test_readers_on_recorded_lines():
    lines = [_span("read shuffle file", 0.2), _span("keep table build", 0.4),
             _span("keep table upload", 0.1), _span("stream pipeline", 2.0),
             "sketch budget: " + json.dumps(dict(BUDGET, **PARTS)),
             _span("save sketches", 0.08), _span(OUTER, 2.8)]
    rec = _record(lines)
    assert read(rec, "shuffle_read_share.sketch") == pytest.approx(5.0)
    assert read(rec, "keep_build_share.sketch") == pytest.approx(10.0)
    assert read(rec, "keep_upload_share.sketch") == pytest.approx(2.5)
    assert read(rec, "save_share.sketch") == pytest.approx(2.0)
    assert read(rec, "parse_wait_share.sketch") == pytest.approx(20.0)
    assert read(rec, "pin_share.sketch") == pytest.approx(10.0)
    assert read(rec, "pinned_allocs_per_batch.sketch") == pytest.approx(0.05)
    # 0.025 s of CPU over 0.1 s of dispatch and 0.25 s of waits
    assert read(rec, "consumer_cpu_pct.sketch") == pytest.approx(100 / 14)
    # the four CLI parts inside the residual they split: 19.5 of 50 %
    assert read(rec, "cli_rest_share.sketch") == pytest.approx(50.0)


@pytest.mark.parametrize("lines", [
    # a program without the new spans and keys
    [_span(OUTER, 2.8), "sketch budget: " + json.dumps(BUDGET)],
    # spans off (KSSD_TIMER=0)
    ["sketch budget: " + json.dumps(dict(BUDGET, **PARTS))],
    # no budget line at all
    [],
], ids=["older program", "spans off", "no budget"])
def test_readers_find_nothing_without_their_names(lines):
    rec = _record(lines)
    got = {n: read(rec, n) for n in NEW}
    if lines and "parse_wait" in lines[-1]:
        # the budget's parts read; the spans do not
        assert all(got[n] is None for n in CLI_SHARES)
        assert all(got[n] is not None for n in BUDGET_PARTS)
    else:
        assert all(v is None for v in got.values()), got


def test_one_command_without_a_part_reads_nothing():
    full = [_span("save sketches", 0.1),
            "sketch budget: " + json.dumps(dict(BUDGET, **PARTS))]
    rec = harness.Record(config={}, work={}, setup_s=1.0, trace=None,
                         extras={}, passes=[
                             _pass(0.0, full, 4.0),
                             _pass(4.0, ["sketch budget: "
                                         + json.dumps(BUDGET)], 4.0)])
    for n in NEW:
        assert read(rec, n) is None, n


def test_an_allocator_without_the_count_reads_nothing():
    """A torch whose allocator keeps no count of pinned blocks prints
    ``pinned_allocs`` as null: the reader reads nothing, not 0."""
    lines = ["sketch budget: "
             + json.dumps(dict(BUDGET, **PARTS) | {"pinned_allocs": None})]
    rec = _record(lines)
    assert read(rec, "pinned_allocs_per_batch.sketch") is None
    assert read(rec, "pin_share.sketch") == pytest.approx(10.0)


@pytest.fixture(scope="module")
def cpu_record(tmp_path_factory):
    """Two ``sketch -q`` commands of the golden corpus through the CLI on
    the CPU, as the harness runs them."""
    from rabbitkssd_tpu_torch import cli

    work = tmp_path_factory.mktemp("parts")
    cwd = os.getcwd()
    os.chdir(os.path.join(ROOT, "tests", "golden"))
    try:
        passes = []
        for k in range(2):
            out = str(work / f"q{k}.sketch")
            passes.append(harness.run_command(
                cli, ["--device", "cpu", "sketch", "-q", "-i", "fa.list",
                      "-L", "k8s4l1.shuf", "-o", out], out,
                torch.device("cpu")))
    finally:
        os.chdir(cwd)
    assert all(p.error is None for p in passes)
    return harness.Record(config={}, work={}, passes=passes, setup_s=0.0,
                          trace=None, extras={})


def test_readers_on_the_programs_lines(cpu_record):
    got = {n: read(cpu_record, n) for n in NEW}
    assert all(v is not None and math.isfinite(v) for v in got.values()), got
    rest = read(cpu_record, "cli_rest_share.sketch")
    assert all(0 <= got[n] <= rest for n in CLI_SHARES)
    assert sum(got[n] for n in CLI_SHARES) <= rest + 1.0
    assert got["parse_wait_share.sketch"] <= read(cpu_record,
                                                  "feed_share.sketch")
    assert got["pin_share.sketch"] <= read(cpu_record,
                                           "h2d_put_share.sketch")
    assert got["pinned_allocs_per_batch.sketch"] == 0  # no pinning here
    assert 0 <= got["consumer_cpu_pct.sketch"] <= 105
