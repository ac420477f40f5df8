"""Input bases of every timed ``sketch`` command over the window (first
command's start to last command's end), in millions a second."""

from kssd_bench.readers import rate


def read(rec):
    return rate(rec, "bases", 1e6)
