"""Percent of the commands' host spans in which the CLI wrote the sketch
file (the `save sketches` span): a part of ``cli_rest_share.sketch``."""

from kssd_bench.parts import phase_share


def read(rec):
    return phase_share(rec, "save sketches")
