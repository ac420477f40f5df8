"""Percent of the pipeline's wall the stream step waited on the
producer's queue (budget ``qwait``)."""

from kssd_bench.readers import budget_share


def read(rec):
    return budget_share(rec, "qwait")
