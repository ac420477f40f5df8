"""Percent of the commands' host spans in which the CLI read the shuffle
file (the program's `read shuffle file` span): a part of
``cli_rest_share.sketch``."""

from kssd_bench.parts import phase_share


def read(rec):
    return phase_share(rec, "read shuffle file")
