"""Percent of the pipeline's wall in the flusher and finalizer
(budget ``flush_scalars`` + ``flush_collect`` + ``finalize``)."""

from kssd_bench.readers import budget_share


def read(rec):
    return budget_share(rec, "flush_scalars", "flush_collect", "finalize")
