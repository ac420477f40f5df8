"""Percent of the pipeline's wall in the all-gather of survivors between
ranks at each flush (budget ``exchange``, rank 0's)."""

from kssd_bench.readers import budget_share


def read(rec):
    return budget_share(rec, "exchange")
