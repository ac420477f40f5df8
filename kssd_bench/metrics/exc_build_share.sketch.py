"""Percent of the pipeline's wall the producer spent taking each
batch's invalid positions and mapping them to the batch's flat
coordinates (budget ``exc_build``, a part of ``feed``).  None where the
program's budget has no ``exc_build``."""

from kssd_bench.parts import budget_ratio


def read(rec):
    return budget_ratio(rec, "exc_build", "wall", scale=100.0)
