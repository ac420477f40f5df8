"""Percent of the bytes through the program's chunked reader (budget
``stream_bytes``) whose speculative parse of a byte range held (budget
``split_bytes``): whether the split parse engaged."""

from kssd_bench.parts import budget_ratio


def read(rec):
    return budget_ratio(rec, "split_bytes", "stream_bytes", scale=100.0)
