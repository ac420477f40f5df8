"""Output checks, one module a kind of command output.

Each module has ``judge(ctx)``, which holds the files that the window's
commands wrote to the plain reference and returns ``{"readings": [(name,
value), ...], "extras": {...}}``, and ``control(ctx)``, which puts the
reference with the cell's ``control`` change in the program's place and
returns readings of the same names.  A cell file's ``limits`` gives each
reading its limit; a run is correct when no reading passes its limit.
"""

import hashlib


def digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 24), b""):
            h.update(block)
    return h.hexdigest()


def passes_differing(paths: list[str]) -> int:
    """Timed commands whose output differs from the last one's: every
    command of a window runs on the same input."""
    ds = [digest(p) for p in paths]
    return sum(d != ds[-1] for d in ds)
