"""Batches whose page-locked staging slot was still being copied from
when the producer came back to it, over all batches: budget
``slot_waits`` over ``batches``.  Near 0 while the card keeps up with
the ring of slots; the parent of the ring has no such key and reads
nothing."""

from kssd_bench.parts import budget_ratio


def read(rec):
    return budget_ratio(rec, "slot_waits", "batches")
