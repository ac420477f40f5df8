"""Percent of the pipeline's wall the producer spent in the two
``pin_memory()`` calls of ``DeviceSketcher._upload`` (budget ``pin``, a
part of ``h2d_put``)."""

from kssd_bench.parts import budget_ratio


def read(rec):
    return budget_ratio(rec, "pin", "wall", scale=100.0)
