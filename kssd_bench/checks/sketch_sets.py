"""The ``.sketch`` files of the timed ``sketch`` commands, genome by
genome against the reference's sketch of the same FASTA file.

Readings: ``genomes_differing``, the genomes of the last command's file
whose name, place or hash set is not the reference's (the binary orders
genomes by file size, largest first, ties in list order; a wrong header
makes every genome differ), and ``passes_differing``, the timed
commands whose file is not byte-equal to the last one's.
"""

from __future__ import annotations

import os

import numpy as np

from . import passes_differing
from ..reference import kssd, sketchfile


def expected_names(list_path: str) -> list[str]:
    with open(list_path) as f:
        files = [ln.strip() for ln in f if ln.strip()]
    return sorted(files, key=lambda p: -os.path.getsize(p))


def reference_sets(ctx, strand: str = "canonical") -> tuple[dict, int]:
    """({file: sorted hashes}, survivors counted with repeats)."""
    sizes = kssd.KssdSizes(**ctx.sizes)
    sets, survivors = {}, 0
    for path in expected_names(ctx.paths["list"]):
        sets[path], n = kssd.genome_sketch(path, sizes, ctx.table, strand)
        survivors += n
    return sets, survivors


def genomes_differing(head, names, hashes, ctx, ref: dict) -> int:
    s = ctx.sizes
    order = expected_names(ctx.paths["list"])
    want = ((s["half_k"] << 8) | (s["half_subk"] << 4) | s["drlevel"],
            s["half_k"], s["half_subk"], s["drlevel"], len(order))
    if tuple(head) != want:
        return len(order)
    bad = abs(len(names) - len(order))
    for name, h, exp in zip(names, hashes, order):
        bad += name != exp or not np.array_equal(h, ref[exp])
    return bad


def judge(ctx) -> dict:
    ref, survivors = reference_sets(ctx)
    head, names, hashes = sketchfile.read(ctx.outputs[-1])
    return {"readings": [
                ("genomes_differing",
                 genomes_differing(head, names, hashes, ctx, ref)),
                ("passes_differing", passes_differing(ctx.outputs))],
            "extras": {"survivors": survivors,
                       "sketch_hashes": sum(h.size for h in hashes)}}


def control(ctx) -> dict:
    ref, _ = reference_sets(ctx)
    broken, _ = reference_sets(ctx, **ctx.cell["control"])
    s = ctx.sizes
    order = expected_names(ctx.paths["list"])
    head = ((s["half_k"] << 8) | (s["half_subk"] << 4) | s["drlevel"],
            s["half_k"], s["half_subk"], s["drlevel"], len(order))
    return {"readings": [
        ("genomes_differing", genomes_differing(
            head, order, [broken[p] for p in order], ctx, ref)),
        ("passes_differing", 0)]}
