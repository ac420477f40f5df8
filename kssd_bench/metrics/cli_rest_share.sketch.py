"""Percent of the commands' host spans outside the sketch pipeline's
wall (``last_budget["wall"]``): argument parsing, the shuffle read,
``save_sketches`` and the rest of ``cli.py``."""

from kssd_bench.readers import span_share


def read(rec):
    return span_share(rec, lambda p: (p.span_s - p.budget["wall"]
                                      if p.budget else None))
