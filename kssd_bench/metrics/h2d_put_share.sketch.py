"""Percent of the pipeline's wall the producer spent in
``DeviceSketcher._upload`` (budget ``h2d_put``)."""

from kssd_bench.readers import budget_share


def read(rec):
    return budget_share(rec, "h2d_put")
