"""Percent of the commands' host spans in which ``ops/member.py:keep_tables``
built the keep bitmap, its summary and their concatenation on the host
(the `keep table build` span): a part of ``cli_rest_share.sketch``."""

from kssd_bench.parts import phase_share


def read(rec):
    return phase_share(rec, "keep table build")
