"""Arithmetic shared by the metric readers in ``metrics/``.  Each reader
returns None where its run holds nothing to read."""

from __future__ import annotations

from . import roofline


def rate(rec, key: str, scale: float) -> float | None:
    """Work of every command of the window over the window."""
    if key not in rec.work or not rec.passes:
        return None
    return rec.work[key] * len(rec.passes) / rec.window_s / scale


def budget_share(rec, *keys: str) -> float | None:
    """Percent of the sketch pipeline's wall that the budget fields
    ``keys`` took, summed over the window."""
    if not rec.has_budget or rec.total("wall") <= 0:
        return None
    return 100.0 * sum(rec.total(k) for k in keys) / rec.total("wall")


def span_share(rec, seconds_of_pass) -> float | None:
    """Percent of the commands' host spans that ``seconds_of_pass(p)``
    covers, summed over the window."""
    got = [seconds_of_pass(p) for p in rec.passes]
    if any(g is None for g in got):
        return None
    return 100.0 * sum(got) / sum(p.span_s for p in rec.passes)


def idle_pct(rec) -> float | None:
    if rec.trace is None or rec.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - rec.trace.busy_s / rec.trace.window_s)


def kernel_roofline(rec, kernel: str, work) -> float | None:
    """Percent: the least time the window's work needs over the
    kernel's summed device time.  ``work(rec)`` gives (bytes,
    operations) of one command."""
    if rec.trace is None:
        return None
    dev_s, launches = rec.trace.kernel_s(kernel)
    got = work(rec)
    if not launches or dev_s <= 0 or got is None:
        return None
    nbytes, ops = got
    least, _ = roofline.bound_s(nbytes * len(rec.passes),
                                ops * len(rec.passes))
    return 100.0 * least / dev_s
