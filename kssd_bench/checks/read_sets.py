"""The ``.sketch`` files of the timed ``sketch`` commands over FASTQ read
sets, sample by sample against the reference's sketch of the same
file (``reference/fastq.py``).

The quality threshold (``-Q``) and the abundance threshold (``-n``) are
the configuration's ``filters``: the reference takes them from there,
and a cell whose command passes other values is refused before any
reading.  Readings as ``sketch_sets``: ``genomes_differing``, the
samples of the last command's file whose name, place or hash set is not
the reference's, and ``passes_differing``, the timed commands whose
file is not byte-equal to the last one's.
"""

from __future__ import annotations

from . import passes_differing
from .sketch_sets import expected_names, genomes_differing
from ..reference import fastq, kssd, sketchfile

FLAGS = {"-Q": "least_qual", "-n": "least_num_kmer"}


def filters(ctx) -> dict:
    """The configuration's filters, once the cell's command is seen to
    pass the same values."""
    want = ctx.config["filters"]
    argv = ctx.cell["argv"]
    got = {FLAGS[a]: int(v) for a, v in zip(argv, argv[1:]) if a in FLAGS}
    if got != want:
        raise ValueError(f"the command passes {got}, the configuration "
                         f"states {want}")
    return dict(want)


def reference_sets(ctx, least_qual: int, least_num_kmer: int,
                   strand: str = "canonical") -> tuple[dict, int]:
    """({file: sorted hashes}, survivors counted with repeats)."""
    sizes = kssd.KssdSizes(**ctx.sizes)
    sets, survivors = {}, 0
    for path in expected_names(ctx.paths["list"]):
        sets[path], n = fastq.sample_sketch(path, sizes, ctx.table,
                                            least_qual, least_num_kmer,
                                            strand)
        survivors += n
    return sets, survivors


def judge(ctx) -> dict:
    ref, survivors = reference_sets(ctx, **filters(ctx))
    head, names, hashes = sketchfile.read(ctx.outputs[-1])
    return {"readings": [
                ("genomes_differing",
                 genomes_differing(head, names, hashes, ctx, ref)),
                ("passes_differing", passes_differing(ctx.outputs))],
            "extras": {"survivors": survivors,
                       "sketch_hashes": sum(h.size for h in hashes)}}


def control(ctx) -> dict:
    """The reference with the cell's ``control`` (any of ``least_qual``,
    ``least_num_kmer``, ``strand``) in the program's place."""
    ref, _ = reference_sets(ctx, **filters(ctx))
    broken, _ = reference_sets(ctx, **{**filters(ctx),
                                       **ctx.cell["control"]})
    s = ctx.sizes
    order = expected_names(ctx.paths["list"])
    head = ((s["half_k"] << 8) | (s["half_subk"] << 4) | s["drlevel"],
            s["half_k"], s["half_subk"], s["drlevel"], len(order))
    return {"readings": [
        ("genomes_differing", genomes_differing(
            head, order, [broken[p] for p in order], ctx, ref)),
        ("passes_differing", 0)]}
