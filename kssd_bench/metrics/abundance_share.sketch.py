"""Percent of the pipeline's wall the finalizer spent counting each
sample's survivors and dropping those seen fewer than ``-n`` times
(budget ``abundance``, a part of ``finalize``).  None where the
program's budget has no ``abundance``."""

from kssd_bench.parts import budget_ratio


def read(rec):
    return budget_ratio(rec, "abundance", "wall", scale=100.0)
