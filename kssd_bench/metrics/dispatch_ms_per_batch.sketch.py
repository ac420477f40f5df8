"""Host milliseconds to issue one stream step (budget ``dispatch`` over
``batches``)."""


def read(rec):
    if not rec.has_budget or rec.total("batches") <= 0:
        return None
    return 1e3 * rec.total("dispatch") / rec.total("batches")
