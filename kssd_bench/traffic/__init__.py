"""Traffic generators, one module a kind.

Each module has ``make(root, params, seed, device) -> dict``: it writes
a cell's inputs under ``root`` from ``seed`` and the cell file's
``traffic`` parameters, and returns ``{"paths": {...}, "work": {...}}``:
the paths that fill the cell's command (``{list}``, ...) and the work
one command does (``bases``, ``genomes``).
The same seed gives the same inputs on the same kind of device.
"""
