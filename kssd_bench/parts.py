"""Readers of the parts of a command that the program times inside it:
its nested ``phase`` spans and the parts of the sketch budget's roles.
A commit whose program lacks a span or key reads None, not an error."""

from __future__ import annotations

from .readers import span_share


def phase_s(p, name: str) -> float | None:
    """Seconds of the program's spans called ``name`` in one command, or
    None where it printed none."""
    got = [s for n, s, _ in p.phases if n == name]
    return sum(got) if got else None


def phase_share(rec, name: str) -> float | None:
    """Percent of the commands' host spans in the spans ``name``."""
    return span_share(rec, lambda p: phase_s(p, name))


def budget_ratio(rec, part: str, *whole: str, scale: float = 1.0
                 ) -> float | None:
    """Budget field ``part`` over the sum of the fields ``whole``, each
    summed over the window, times ``scale``; None where a command's
    budget lacks ``part`` or holds no value for it."""
    if not rec.has_budget or any(p.budget.get(part) is None
                                 for p in rec.passes):
        return None
    total = sum(rec.total(k) for k in whole)
    if total <= 0:
        return None
    return scale * rec.total(part) / total
