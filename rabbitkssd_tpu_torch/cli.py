"""Command-line interface of the port: ``rabbit_kssd_tpu_torch``.

The flag surface is the JAX package's (:func:`build_parser` is a copy of
``rabbitkssd_tpu.cli.build_parser``, mirroring the reference
main.cpp:30-259) plus one global option, ``--device`` (default
``cuda``; ``cpu`` runs every kernel's plain version).  ``sketch``,
``alldist`` and ``dist`` (with top-N, and the legacy sorted-intersection
paths under ``KSSD_LEGACY_DIST=1``) run on the torch device; the
host-only commands (shuffle, union, sub, convert, merge, info) are
copies of the JAX package's, over the port's own host modules.  Several
ranks under ``torchrun`` run one command together (:func:`main`).
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys

import torch

from .device import resolve_device
from .parallel.multihost import (barrier, init_multihost, is_writer,
                                 shutdown, thread_budget)
from .utils.timers import phase


def _eprint(*a):
    print(*a, file=sys.stderr)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="rabbit_kssd_tpu_torch",
        description="PyTorch/CUDA Kssd-based genome distance estimation",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device for sketch/alldist/dist: cuda "
                         "(default, requires a card; cuda:LOCAL_RANK under "
                         "a multi-rank launcher) or cpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("shuffle", help="generate the shuffle file for sketching usage")
    p.add_argument("-k", "--halfk", type=int, required=True)
    p.add_argument("-s", "--subk", type=int, default=6)
    p.add_argument("-l", "--reduction", type=int, required=True)
    p.add_argument("-o", "--output", required=True)

    p = sub.add_parser("sketch", help="compute sketches for the input genome list")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-L", dest="shuf_file", default="shuf_file/L3K10.shuf")
    p.add_argument("-t", "--threads", type=int, default=0)
    p.add_argument("-n", "--leastNumKmer", type=int, default=1)
    p.add_argument("-Q", "--leastQuality", type=int, default=0)
    p.add_argument("-q", "--query", action="store_true")

    p = sub.add_parser("alldist", help="compute all-vs-all distances for one input dataset")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-D", "--maxDist", type=float, default=1.0)
    p.add_argument("-L", dest="shuf_file", default="shuf_file/L3K10.shuf")
    p.add_argument("-t", "--threads", type=int, default=0)
    p.add_argument("-M", "--metric", type=int, default=0)
    p.add_argument("-n", "--leastNumKmer", type=int, default=1)
    p.add_argument("-Q", "--leastQuality", type=int, default=0)

    p = sub.add_parser("dist", help="compute distances between reference and query datasets")
    p.add_argument("-r", "--reference", required=True)
    p.add_argument("-q", "--query", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-N", "--neighborN_max", type=int, default=None)
    p.add_argument("-D", "--maxDist", type=float, default=1.0)
    p.add_argument("-L", dest="shuf_file", default="shuf_file/L3K10.shuf")
    p.add_argument("-t", "--threads", type=int, default=0)
    p.add_argument("-M", "--metric", type=int, default=0)
    p.add_argument("-n", "--leastNumKmer", type=int, default=1)
    p.add_argument("-Q", "--leastQuality", type=int, default=0)

    p = sub.add_parser("union", help="compute the set union from multiple sketches")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-t", "--threads", type=int, default=0)

    p = sub.add_parser("sub", help="subtract the reference sketch from the query sketches")
    p.add_argument("--rs", required=True)
    p.add_argument("--qs", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-t", "--threads", type=int, default=0)

    p = sub.add_parser("convert", help="convert sketches between Kssd and RabbitKSSD formats")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-t", "--threads", type=int, default=0)
    p.add_argument("-q", "--query", action="store_true")
    p.add_argument("--reverse", action="store_true")

    p = sub.add_parser("merge", help="merge multiple sketch files into one")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-t", "--threads", type=int, default=0)

    p = sub.add_parser("info", help="get the information of the sketch file")
    p.add_argument("-i", "--input", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-F", "--Fined", action="store_true")

    return ap


def cmd_shuffle(args) -> int:
    from .shuffle import generate_shuffle, write_shuffle_file

    _eprint(f"-----generate the shuffle file: {args.output}")
    shuf = generate_shuffle(args.halfk, args.subk, args.reduction)
    write_shuffle_file(shuf, args.output)
    return 0


def cmd_union(args) -> int:
    from .engine.setops import union_sketch_file

    _eprint("-----run the subcommand: union")
    union_sketch_file(args.input, args.output)
    return 0


def cmd_sub(args) -> int:
    from .engine.setops import sub_sketch_files

    _eprint("-----run the subcommand: sub")
    sub_sketch_files(args.rs, args.qs, args.output)
    return 0


def cmd_convert(args) -> int:
    from .engine.setops import convert_kssd_to_sketch, convert_sketch_to_kssd
    from .formats import is_sketch_file

    _eprint("-----run the subcommand: convert")
    if args.reverse:
        if not is_sketch_file(args.input):
            _eprint(
                f"ERROR: convert, need input RabbitKSSD sketch file: {args.input}"
            )
            return 1
        convert_sketch_to_kssd(args.input, args.output)
    else:
        convert_kssd_to_sketch(args.input, args.output,
                               build_index=not args.query)
    return 0


def cmd_merge(args) -> int:
    from .engine.setops import merge_sketch_files
    from .formats import is_sketch_file
    from .seqio import read_list

    _eprint("-----run the subcommand: merge")
    files = read_list(args.input)
    for f in files:
        if not is_sketch_file(f):
            _eprint(
                f"ERROR: merge, the file: {f} is not a sketch file in the "
                f"list file: {args.input}"
            )
            return 1
    merge_sketch_files(files, args.output)
    return 0


def cmd_info(args) -> int:
    from .engine.setops import write_info

    _eprint("-----run the subcommand: info")
    write_info(args.input, args.Fined, args.output)
    return 0


def _load_or_sketch(list_or_sketch: str, shuf_file: str, device,
                    least_qual: int, least_num_kmer: int,
                    build_index_if_missing: bool, threads: int = 0):
    """Sketch-or-load with the reference's artifact side effects
    (subCommand.cpp:161-193)."""
    from .formats import (is_sketch_file, read_sketches, save_sketches,
                          write_index)
    from .shuffle import read_shuffle_kept

    from .engine.sketcher import sketch_file_list

    if is_sketch_file(list_or_sketch):
        with phase(f"read sketches from {list_or_sketch}"):
            sk = read_sketches(list_or_sketch)
        sketch_out = list_or_sketch
        if build_index_if_missing and is_writer():
            idx, dic = sketch_out + ".index", sketch_out + ".dict"
            if not (os.path.exists(idx) and os.path.exists(dic)):
                with phase("transSketches"):
                    write_index(sk, dic, idx)
        barrier()  # no rank reads an index still being written
        return sk, sketch_out
    with phase("read shuffle file"):
        shuf = read_shuffle_kept(shuf_file, thread_budget(max(0, threads)))
    with phase("computing sketches and save sketches into file"):
        sk = sketch_file_list(list_or_sketch, shuf, device=device,
                              least_qual=least_qual,
                              least_num_kmer=least_num_kmer,
                              threads=max(0, threads))
        sketch_out = list_or_sketch + ".sketch"
        if is_writer():
            with phase("save sketches"):
                save_sketches(sk, sketch_out)
    if build_index_if_missing and is_writer():
        with phase("transSketches"):
            write_index(sk, sketch_out + ".dict", sketch_out + ".index")
    barrier()
    return sk, sketch_out


def cmd_sketch(args) -> int:
    from .formats import (is_sketch_file, read_sketches, save_sketches,
                          write_index)
    from .shuffle import read_shuffle_kept

    from .engine.sketcher import sketch_file_list

    _eprint("-----run the subcommand: sketch")
    if is_sketch_file(args.input):
        # sketch-file input short-circuit (main.cpp:189-215): file work
        # only, done by the writing rank
        if not is_writer():
            return 0
        _eprint(
            f"input is a sketch file, rename the sketch file from: "
            f"{args.input} to: {args.output}"
        )
        if not args.query:
            sk = read_sketches(args.input)
            shutil.copy(args.input, args.output)
            write_index(sk, args.output + ".dict", args.output + ".index")
        else:
            shutil.move(args.input, args.output)
        return 0
    _eprint(f"---read the shuffle file: {args.shuf_file}")
    with phase("read shuffle file"):
        # the kept set alone, on the threads the parse gets later
        shuf = read_shuffle_kept(args.shuf_file,
                                 thread_budget(max(0, args.threads)))
    with phase("computing sketches and save sketches into file"):
        sk = sketch_file_list(args.input, shuf, device=args.device,
                              least_qual=args.leastQuality,
                              least_num_kmer=args.leastNumKmer,
                              threads=max(0, args.threads))
        out = (args.output if args.output.endswith(".sketch")
               else args.output + ".sketch")
        if not is_writer():
            return 0
        with phase("save sketches"):
            save_sketches(sk, out)
    _eprint(f"save the sketches into: {out}")
    if not args.query:
        with phase("transSketches"):
            write_index(sk, out + ".dict", out + ".index")
    return 0


def cmd_alldist(args) -> int:
    from .engine.dist_engine import run_alldist, run_alldist_legacy

    _eprint("-----run the subcommand: alldist")
    if args.maxDist < 0.0:
        _eprint("ERROR: alldist, maxDist must be > 0")
        return 1
    sk, sketch_out = _load_or_sketch(args.input, args.shuf_file,
                                     args.device, args.leastQuality,
                                     args.leastNumKmer,
                                     build_index_if_missing=True,
                                     threads=args.threads)
    if os.environ.get("KSSD_LEGACY_DIST") == "1" and not args.metric:
        # the reference's legacy sorted-intersection path (tri_dist,
        # dist.cpp:345-427) — unreachable from its CLI too
        # (subCommand.cpp:197 commented); jaccard/mash only
        # It needs no other rank, so only the writing rank runs it.
        if is_writer():
            with phase("tri_dist distance computing"):
                run_alldist_legacy(sk, args.output, max_dist=args.maxDist,
                                   device=args.device)
        return 0
    with phase("index_tridist distance computing"):
        # every rank counts (below one block, on the mesh together); only
        # the writing rank has an output file
        run_alldist(sk, args.output if is_writer() else None,
                    max_dist=args.maxDist,
                    containment=bool(args.metric), device=args.device,
                    index_path=sketch_out)
    return 0


def cmd_dist(args) -> int:
    from .engine.dist_engine import run_dist, run_dist_legacy

    _eprint("-----run the subcommand: dist")
    if args.maxDist < 0.0:
        _eprint("ERROR: dist, maxDist must be > 0")
        return 1
    ref, ref_out = _load_or_sketch(args.reference, args.shuf_file,
                                   args.device, args.leastQuality,
                                   args.leastNumKmer,
                                   build_index_if_missing=True,
                                   threads=args.threads)
    query, _ = _load_or_sketch(args.query, args.shuf_file, args.device,
                               args.leastQuality, args.leastNumKmer,
                               build_index_if_missing=False,
                               threads=args.threads)
    if ref.info.id != query.info.id:
        _eprint(
            "ERROR: dist, the sketch infos between reference and query "
            "files are not match\n"
            "try to use the same shuffle file to generate sketches of the "
            "reference and query datasets"
        )
        return 1
    if (os.environ.get("KSSD_LEGACY_DIST") == "1" and not args.metric
            and not args.neighborN_max):
        if is_writer():  # needs no other rank
            with phase("dist distance computing"):
                run_dist_legacy(ref, query, args.output,
                                max_dist=args.maxDist, device=args.device)
        return 0
    with phase("index_dist distance computing"):
        run_dist(ref, query, args.output if is_writer() else None,
                 max_dist=args.maxDist,
                 containment=bool(args.metric), device=args.device,
                 max_neighbor=args.neighborN_max or 0,
                 ref_index_path=ref_out)
    return 0


_DISPATCH = {
    "shuffle": cmd_shuffle,
    "sketch": cmd_sketch,
    "alldist": cmd_alldist,
    "dist": cmd_dist,
    "union": cmd_union,
    "sub": cmd_sub,
    "convert": cmd_convert,
    "merge": cmd_merge,
    "info": cmd_info,
}
_DEVICE_CMDS = ("sketch", "alldist", "dist")


def main(argv: list[str] | None = None) -> int:
    """Run one subcommand.  Under a multi-rank launcher (``torchrun``,
    ``WORLD_SIZE`` > 1) every rank runs it: the device commands on
    ``cuda:LOCAL_RANK`` (or the CPU), each rank computing the replicated
    result; only local rank 0 of each node writes files, and the
    host-only commands run there alone.  Every command ends at a barrier,
    so a following command never reads a file still being written."""
    args = build_parser().parse_args(argv)
    if args.cmd in _DEVICE_CMDS:
        args.device = resolve_device(args.device)
    init_multihost(cuda=str(args.device).startswith("cuda")
                   and torch.cuda.is_available())
    rc = 0
    if args.cmd in _DEVICE_CMDS or is_writer():
        rc = _DISPATCH[args.cmd](args)
    barrier()
    return rc


def _cli() -> None:
    rc = main()
    shutdown()
    sys.exit(rc)


if __name__ == "__main__":
    _cli()
