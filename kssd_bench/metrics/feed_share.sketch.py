"""Percent of the pipeline's wall the producer spent getting batches
from the parser and ``WordTapeFeeder`` (budget ``feed``)."""

from kssd_bench.readers import budget_share


def read(rec):
    return budget_share(rec, "feed")
