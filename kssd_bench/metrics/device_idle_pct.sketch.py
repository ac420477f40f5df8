"""Percent of the traced window in which no kernel, copy or memset ran
on the card, in the sketch cells."""

from kssd_bench.readers import idle_pct


def read(rec):
    return idle_pct(rec)
