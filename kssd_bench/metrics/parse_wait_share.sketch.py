"""Percent of the pipeline's wall the producer thread blocked on the
parser: on a parse future or the chunked reader's queue (budget
``parse_wait``, a part of ``feed``)."""

from kssd_bench.parts import budget_ratio


def read(rec):
    return budget_ratio(rec, "parse_wait", "wall", scale=100.0)
