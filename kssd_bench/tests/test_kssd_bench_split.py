"""``parse_split_share.sketch``, the reader of the chunked reader's
split counters, on recorded budget lines: with the keys, without them
(a program that lacks them), and with no byte through the reader."""

from __future__ import annotations

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)
from kssd_bench import harness  # noqa: E402

BUDGET = {"feed": 1.0, "h2d_put": 0.5, "qwait": 0.25, "dispatch": 0.1,
          "flush_scalars": 0.05, "flush_collect": 0.1, "finalize": 0.1,
          "drain": 0.0, "wall": 2.0, "h2d_bytes": 10, "batches": 100,
          "reruns": 0, "exchange": 0.0, "parse_wait": 0.4}


def read(rec):
    return harness.load_module("metrics", "parse_split_share.sketch").read(
        rec)


def _record(*budgets: dict) -> harness.Record:
    passes = [harness.Pass("x", 4.0 * k, 4.0 * (k + 1),
                           [(4.0 * k + 0.1, "sketch budget: "
                             + json.dumps(b))], None)
              for k, b in enumerate(budgets)]
    return harness.Record(config={}, work={}, setup_s=1.0, trace=None,
                          extras={}, passes=passes)


def test_reads_the_share_summed_over_the_window():
    a = dict(BUDGET, stream_bytes=1000, split_bytes=1000)
    b = dict(BUDGET, stream_bytes=1000, split_bytes=500)
    assert read(_record(a, b)) == pytest.approx(75.0)


@pytest.mark.parametrize("budgets", [
    # a program without the counters
    [BUDGET, BUDGET],
    # one command without them
    [dict(BUDGET, stream_bytes=10, split_bytes=10), BUDGET],
    # no file went through the chunked reader
    [dict(BUDGET, stream_bytes=0, split_bytes=0)],
], ids=["older program", "one command without", "nothing streamed"])
def test_reads_nothing_without_its_counters(budgets):
    assert read(_record(*budgets)) is None
