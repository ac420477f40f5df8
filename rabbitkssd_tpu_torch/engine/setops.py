"""Set algebra over sketches: union / sub / merge / convert / info.

Re-design of the reference producer-consumer + bitmap subcommands
(reference subCommand.cpp:307-543 union, 545-794 sub,
796-892 merge, 13-47 convert, 70-147 info).  The reference privatizes a
hash-space bitmap per consumer thread and OR-reduces; here set algebra
runs on sorted hash arrays (chunked concat-unique union / membership
subtract), streaming genome-by-genome — the per-genome arrays are tiny
compared to the 2^32-bit bitmaps the reference allocates per thread,
and sorted arrays are the canonical on-device representation.  The
port's copy of ``rabbitkssd_tpu/engine/setops.py``.
"""

from __future__ import annotations

import numpy as np

from ..formats import (
    Sketch,
    SketchInfo,
    SketchSet,
    iter_sketches,
    read_kssd_dir,
    read_sketch_header,
    read_sketches,
    save_sketches,
    write_index,
    write_kssd_dir,
)


def _streaming_union(hash_arrays, dtype, chunk_elems: int = 1 << 26
                     ) -> np.ndarray:
    """Union many sorted hash arrays: accumulate ~chunk_elems then
    np.unique — O(total log total), memory-bounded (the reference
    allocates a 2^32-bit bitmap per consumer instead,
    subCommand.cpp:338)."""
    acc = np.empty(0, dtype)
    pending: list[np.ndarray] = []
    pending_n = 0
    for h in hash_arrays:
        pending.append(h)
        pending_n += h.size
        if pending_n >= chunk_elems:
            acc = np.unique(np.concatenate([acc, *pending]))
            pending, pending_n = [], 0
    if pending:
        acc = np.unique(np.concatenate([acc, *pending]))
    return acc.astype(dtype)


def union_sketch_file(sketch_file: str, output_file: str) -> SketchSet:
    """All genomes' hash sets -> one merged sketch (command_union).

    Output name mirrors the reference: ``<input> merged sketches``
    (subCommand.cpp:360); hashes ascending (the reference enumerates its
    bitmap in hash order too, subCommand.cpp:493-525).
    """
    info, _, _ = read_sketch_header(sketch_file)
    dt = np.uint64 if info.use64 else np.uint32
    merged = _streaming_union(
        (h for _, h in iter_sketches(sketch_file)), dt
    )
    out = SketchSet(
        info=SketchInfo(info.id, info.half_k, info.half_subk, info.drlevel, 1),
        sketches=[Sketch(name=sketch_file + " merged sketches",
                         hashes=merged.astype(dt))],
    )
    save_sketches(out, output_file)
    return out


def sub_sketch_files(ref_sketch_file: str, query_sketch_file: str,
                     output_file: str) -> SketchSet:
    """Remove every hash present in the reference union from each query
    genome (command_sub).  Sketch id compatibility enforced
    (subCommand.cpp:604-607)."""
    ref_info, _, _ = read_sketch_header(ref_sketch_file)
    query_info, _, _ = read_sketch_header(query_sketch_file)
    if ref_info.id != query_info.id:
        raise ValueError(
            "the sketch infos between subtraction reference and query "
            "sketches are not same"
        )
    ref_union = _streaming_union(
        (h for _, h in iter_sketches(ref_sketch_file)),
        np.uint64 if ref_info.use64 else np.uint32,
    )

    sketches = []
    for name, h in iter_sketches(query_sketch_file):
        hs = np.unique(h)
        idx = np.searchsorted(ref_union, hs)
        idx = np.minimum(idx, max(len(ref_union) - 1, 0))
        in_ref = (ref_union[idx] == hs) if len(ref_union) else np.zeros(
            hs.shape, bool
        )
        sketches.append(Sketch(name=name, hashes=hs[~in_ref]))
    out = SketchSet(
        info=SketchInfo(query_info.id, query_info.half_k,
                        query_info.half_subk, query_info.drlevel,
                        len(sketches)),
        sketches=sketches,
    )
    save_sketches(out, output_file)
    return out


def merge_sketch_files(file_list: list[str], output_file: str) -> SketchSet:
    """Concatenate genome entries of several sketch files (command_merge)."""
    if not file_list:
        raise ValueError("empty merge list")
    base_info, _, _ = read_sketch_header(file_list[0])
    sketches: list[Sketch] = []
    for path in file_list:
        info, _, _ = read_sketch_header(path)
        if info.id != base_info.id:
            raise ValueError("mismatched sketch info")
        for name, h in iter_sketches(path):
            sketches.append(Sketch(name=name, hashes=h))
    out = SketchSet(
        info=SketchInfo(base_info.id, base_info.half_k, base_info.half_subk,
                        base_info.drlevel, len(sketches)),
        sketches=sketches,
    )
    save_sketches(out, output_file)
    return out


def convert_kssd_to_sketch(input_dir: str, output_file: str,
                           build_index: bool) -> SketchSet:
    """Kssd directory -> RabbitKSSD .sketch (+ index) (command_convert)."""
    sk = read_kssd_dir(input_dir)
    if not output_file.endswith(".sketch"):
        output_file = output_file + ".sketch"
    save_sketches(sk, output_file)
    if build_index:
        write_index(sk, output_file + ".dict", output_file + ".index")
    return sk


def convert_sketch_to_kssd(input_sketch: str, output_dir: str) -> None:
    """RabbitKSSD .sketch -> Kssd directory (command_convert --reverse)."""
    sk = read_sketches(input_sketch)
    write_kssd_dir(sk, output_dir)


def info_text(sketch_file: str, detail: bool) -> str:
    """The ``info`` dump, formatted exactly like command_info
    (subCommand.cpp:95-138): header line, per genome ``name\\tsize``, and
    with -F every hash ``%u\\t`` with a newline every 10 values plus a
    trailing newline per genome.  (Hash order here is ascending — the
    reference dumps hash-set iteration order; only set equality is
    defined across implementations.)
    """
    info, _, _ = read_sketch_header(sketch_file)
    lines = [f"the number of sketches are: {info.genome_number}\n"]
    for name, h in iter_sketches(sketch_file):
        lines.append(f"{name}\t{h.size}\n")
        if detail:
            parts = []
            for j, v in enumerate(h):
                parts.append(f"{int(v)}\t")
                if j % 10 == 9:
                    parts.append("\n")
            parts.append("\n")
            lines.append("".join(parts))
    return "".join(lines)


def write_info(sketch_file: str, detail: bool, output_file: str) -> None:
    with open(output_file, "w") as f:
        f.write(info_text(sketch_file, detail))
