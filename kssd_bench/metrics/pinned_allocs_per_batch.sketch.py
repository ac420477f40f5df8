"""Pinned host blocks the caching host allocator made a batch: budget
``pinned_allocs`` (the change in ``torch.cuda.host_memory_stats()``'s
``num_host_alloc`` over the pipeline) over ``batches``.  Near 0 when
``pin_memory()`` reuses cached blocks."""

from kssd_bench.parts import budget_ratio


def read(rec):
    return budget_ratio(rec, "pinned_allocs", "batches")
