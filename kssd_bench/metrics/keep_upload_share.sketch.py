"""Percent of the commands' host spans in which ``keep_tables`` copied the
shuffle table and the bitmap to the device (the `keep table upload`
span, two pageable copies): a part of ``cli_rest_share.sketch``."""

from kssd_bench.parts import phase_share


def read(rec):
    return phase_share(rec, "keep table upload")
