"""Invalid positions a batch carries to the card: budget ``exceptions``
(read ends, masked bases, N runs and genome-end pads, as the feeder
emits them before bucket padding) over ``batches``.  None where the
program's budget has no ``exceptions``."""

from kssd_bench.parts import budget_ratio


def read(rec):
    return budget_ratio(rec, "exceptions", "batches")
