#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (rabbitkssd_tpu_torch).

    python3 chip_smoke.py        # from the repository root, one CUDA card
                                 # or several

Phases, each printing its own lines:

1. card: name, and name + power limit from nvidia-smi;
2. build: the three kernels (csrc/member.cu, csrc/stream_keep.cu,
   csrc/stream_compact.cu), one nvcc process each, all started
   together, timed;
3. kernels vs plain, on the card, for an L3 (L3K10, 4096 kept dims) and
   an L2 (L2K8, 65536 kept dims) kept set, and for the stream kernels
   also at L3K12 (K = 24, 36-bit hashes) and (16, 4, 1) (K = 32, the
   full 64-bit window); everything compared must be exactly equal;
   times taken in turns (plain, kernel, kernel, plain):
   (a) the bitmap keep test (member.cu) at the stream step's shape
   (16 x (2^17 + 32) dims plus edge values), also at the (16, 4, 1)
   kept set (dim_size 2^16, 4096 kept dims, the summary at shift 0),
   each against ``member_plain`` and ``table[d] < dim_end``; device time
   a launch from torch.profiler traces of the kernel, the plain version
   and one indexing call on a bool kept-dims table (its library time),
   beside CUDA-event times a call, and the device time of ``dims != 0``
   (the same bytes in and out, no lookup) as a yardstick; each kept
   set's device times on a line of their own.  ``python3 chip_smoke.py
   --member`` runs this part alone and prints it as one JSON line: run
   it from several checkouts in turns to compare versions of member.cu;
   (b) the stream step's kernels at its shape (16 rows x (2^17 + halo)
   windows, and 2^17 - 16 payload windows a row, where 32-window groups
   straddle rows and the keep words are no multiple of
   ``stream_compact``'s tile; and one row of 2048, less than one tile):
   ``stream_keep`` against the plain window hash + keep test + bit
   packing, ``stream_compact`` against the plain compaction in sparse
   and dense mode, under forced overflow (cap 64) and with a near-full
   buffer, and on a dense kept table (half the dims kept), so that in
   sparse mode more groups are flagged than g_cap, and with the group
   cut placed exactly on a tile boundary; 100 back-to-back
   ``stream_compact`` launches on one look-back scratch, each against
   the plain version; each kernel's device time a launch from a
   torch.profiler trace, beside CUDA-event times of a call (which
   include the host's issue); and the whole step, the new one against a
   reconstruction of the earlier eager step (window hash + member.cu,
   then this version's plain compaction);
4. main path: a synthetic bacterial corpus (256 genomes x ~2 Mb, seed
   2024) through the CLI's ``sketch`` then ``alldist -D 0.05`` at L3K10
   on the card; prints walls, Mbase/s, the sketcher's budget and the
   kernels' launch counts: the two stream kernels' must each cover every
   batch and re-run, member.cu is off the path (0 launches);
5. correctness: (a) three genomes' sketches equal the numpy oracle;
   (b) a device-counting alldist (KSSD_DIST_PATH=matmul,
   KSSD_HOST_JOIN_MAX=0) gives the same rows as the auto run; (c) the
   golden fa.list sketches and alldist rows of the reference binary,
   and its FASTQ (``fq.list -n 2 -Q 40``) and query (``-q``) sketches;
   (d) with a per-batch cap of 64 survivors, every batch of three
   corpus genomes overflows on the card, and the exact re-run gives the
   main path's hash sets (the stream kernels launch twice a batch);
6. the walk/matmul cost model's two rates: ``torch._int_mm`` int8 ops/s
   at an alldist strip shape, and the native posting walk's
   increments/s counting the corpus sketch all-vs-all;
7. profile: the CLI sketch once more, warm, under ``torch.profiler``
   (``KSSD_PROFILE_DIR``), and the sketch trace's device busy share,
   device events and ``dispatch`` per batch and device time by kernel
   (utils/trace_report.py);
8. config 2 (BASELINE.json): the phase-4 corpus split into 192 reference
   and 64 query genomes, through the CLI on the card:
   (a) ``dist -r ref.list -q query.list -L L3K10.shuf -D 0.05``, both
   sides sketched from FASTA: each stream kernel's launches equal both
   sketches' batches + re-runs, and both sketches' sets equal phase 4's;
   (b) the same dist with device counting forced (KSSD_DIST_PATH=matmul,
   KSSD_HOST_JOIN_MAX=0) on (a)'s sketches gives (a)'s rows;
   (c) ``dist -N 10 -D 1.0`` and ``-D 1.0`` on (a)'s sketches: for three
   queries the 10 rows' common counts equal np.intersect1d recounts and
   their distances are the query's 10 smallest;
   (d) the golden reference sketch against ``fa_query.list`` (k8s4l1,
   ``-D 1.0``, with and without ``-N 2``) gives the reference binary's
   rows;
   (e) legacy (KSSD_LEGACY_DIST=1): ``alldist`` on the phase-4 sketch and
   ``dist`` in both directions (192 >= 64 and 64 < 192); the sorted
   intersection's counts on the card equal the native walk's, and the
   legacy files rerun with ``--device cpu`` are byte-equal to the
   card's.  Prints each leg's wall and the legacy intersection's device
   time (CUDA events) against its CPU time;
9. several ranks (``torchrun --standalone``, this script's ``--rank``
   mode): (a) the CLI ``sketch`` then ``alldist -D 0.05`` twice, the
   second with KSSD_HOST_JOIN_MAX=0 (the ring and the vp reduction), in
   every rank: on several cards one rank per card (``--device cuda`` ->
   cuda:LOCAL_RANK, a ``cpu:gloo,cuda:nccl`` group); on one card 3 ranks
   share cuda:0 (``--device cuda:0`` in a gloo group each rank starts
   before the CLI, since NCCL refuses two ranks on one card; the CLI's
   mesh is (1, 3), so the vp reduction runs over gloo).  The sets and
   sorted rows must equal phase 4's, only rank 0 writes, and each rank's
   stream-kernel launches cover its batches; (b) 3 ranks sharing cuda:0 (gloo)
   at an explicit Mesh(3, 1): ``sharded_common_counts`` of the phase-4
   sketch through the dp ring (all-vs-all and 192 vs 64) must equal the
   forced ``_int_mm`` counts, and the sharded ``DeviceSketcher`` on the
   corpus must give phase 4's sets with each rank's stream-kernel
   launches covering its batches.  Prints walls and every rank's sketch
   budget;
10. config 4 (BASELINE.md: the mammal/metagenome scale): two 1.2 Gbase
   single-record genomes (files over 1 GiB, so the chunked reader) and
   20 x 5 Mb contigs, the scripts/config4_run.py corpus (seed 77), at
   L3K12 (K = 24, use64): (a) the CLI ``sketch`` on the card in a child
   process (its wall, Mbase/s and its own peak RSS, the ``ru_maxrss``
   of ``os.wait4`` in a small launcher process that starts it; the
   stream kernels' launches cover its batches and re-runs; 64-bit
   hashes); (b) the two genomes sketched again with the files read
   whole (``KSSD_STREAM_THRESHOLD`` above their size) give (a)'s sets;
   (c) three contigs (one lowercase) sketched as their own genomes
   equal the numpy oracle; (d) the K-step hasher of the sharded sketch
   step (``make_sharded_sketch_step``, one rank, block 2^17, cap 16,384)
   over the contigs file and the first genome, in ``pack_blocks`` rows:
   the union of its kept hashes equals (a)'s sets, a second device
   formulation of the same hash; (e) ``alldist -D 1.0`` on (a)'s
   sketch, auto and with device counting forced, gives equal sorted
   rows, and the genomes' common count equals ``np.intersect1d``.  The
   corpus is deleted when the phase ends;
11. the entry points (``rabbitkssd_tpu_torch.entry``): ``entry()``
   called twice on the card gives equal results, and
   ``dryrun_multichip(4)`` runs 4 ranks (one a card on four cards,
   else sharing cuda:0 over gloo);
12. (a) ``scripts/torch_diff_fuzz.py --against cpu --device cuda`` in a
   child process, 16 seeded trials of random configs and corpora, the
   port's CLI on the card against the same CLI on the CPU in every leg
   (sketch, alldist, dist, union, sub, merge, convert, info, knobs,
   forced overflow): no failure, every card sketch launched both stream
   kernels on every batch, and the trials hold a 64-bit config, K = 32,
   FASTQ and a genome over several batches; (b) BASELINE config 3
   (scripts/config23_run.py's chain) on the card: the phase-4 corpus
   split into halves A and B, each sketched, ``union -i A``, ``sub --rs
   A_u --qs B``, ``merge A B`` and ``alldist -D 0.05`` of the merge (auto
   and device counting), held to numpy set algebra over phase 4's sets
   and to phase 4's rows, with each step's wall.

Prints the kernels' JSON line, then as the last line
``{"ok": true, "device": {...}}``.  Catches nothing: any failure exits
non-zero.  Without a CUDA card, or outside the repository, it exits 1
before printing a result.  Imports only the port (``rabbitkssd_tpu_torch``),
which carries its own copies of the host modules it needs (its ``host``
module gathers the helpers this script uses) and imports nothing of the
JAX package.
"""

from __future__ import annotations

import contextlib
import glob
import io
import itertools
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")

N_GENOMES = 256
GENOME_LEN = 2_000_000
SEED = 2024
MAX_DIST = "0.05"
# one stream-step batch of L3K10 windows: 16 rows x (2^17 + halo 32)
STEP_DIMS = 16 * ((1 << 17) + 32)
# each kernel's source under rabbitkssd_tpu_torch/csrc
SOURCES = {"member_bitmap": "member.cu", "stream_keep": "stream_keep.cu",
           "stream_compact": "stream_compact.cu"}
# config 2: the first N_REF corpus genomes are the reference side
N_REF = 192
TOP_N = 10
# counting forced onto the device (int8 memberships, torch._int_mm)
DEVICE_COUNTING = {"KSSD_DIST_PATH": "matmul", "KSSD_HOST_JOIN_MAX": "0"}
# phase 12 (a): the fuzzer's trials and seed (its 16 trials draw 64-bit
# configs, K = 32, FASTQ and genomes over several batches)
FUZZ_TRIALS, FUZZ_SEED = 16, 5
# one H100 SXM's peak rates, for each kernel's bound (NVIDIA's data
# sheet): HBM3 at 3.35 TB/s, and 32-bit lane operations at half the 67
# TFLOP/s of float32 FMA, i.e. 132 SMs x 128 lanes x 1.98 GHz: an SM's
# four schedulers issue one 32-lane instruction a clock each, so no mix
# of 32-bit integer instructions (ALU pipe, or IMAD-class on the FMA
# pipe) runs faster
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2
# 32-bit operations a window that the keep test needs, whatever one
# design performs: with the forward and reverse-complement codes rolled
# along the row, the next base (2), the forward update (4: a 64-bit
# shift by 2, an OR, the mask), the reverse-complement update (5), the
# canonical minimum (4: a 64-bit compare and select), dim_id (2), the
# K-window validity (2: a rolled run length), the valid_upto test (1),
# the bitmap probe's word index and bit (4), the tests' AND (2)
KEEP_OPS_PER_WINDOW = 26
# of member.cu a dim (range test, word offset, shift, mask, store)
MEMBER_OPS_PER_DIM = 6
# of stream_compact a keep word (two loads, a compare, a popcount, two
# adds) and a survivor (bit scan, row and window offsets, the window
# hash as in stream_keep, table index, composition, four slot writes)
COMPACT_OPS_PER_WORD = 6
COMPACT_OPS_PER_SURVIVOR = 80


def _bound(bytes_moved: float, ops: float) -> tuple[float, str]:
    """(ms, what bounds it): the larger of bytes over HBM rate and
    32-bit operations over the 32-bit lane rate."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _die(msg: str) -> None:
    print(f"chip_smoke: {msg}", file=sys.stderr)
    sys.exit(1)


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


# --------------------------------------------------------------------------
# corpus: the bench.py recipe, reimplemented here on purpose
# --------------------------------------------------------------------------

def make_corpus(root: str, n_genomes: int, genome_len: int, seed: int
                ) -> tuple[str, list[str], int]:
    """Mutated copies of 8 ancestors: SNP rate 0.25-20 %, 4 N runs each,
    unique lengths (the reference orders genomes by file size).  Returns
    (list path, file paths, total bases)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)
    ancestors = [rng.integers(0, 4, size=int(1.3 * genome_len) + 128,
                              dtype=np.int8) for _ in range(8)]
    files, total = [], 0
    for g in range(n_genomes):
        glen = int(genome_len * (0.7 + 0.6 * g / max(n_genomes - 1, 1)))
        glen -= glen % 100
        anc = ancestors[g % 8][:glen]
        rate = 10 ** rng.uniform(-2.6, -0.7)
        n_mut = int(len(anc) * rate)
        seq = anc.copy()
        pos = rng.integers(0, len(anc), size=n_mut)
        seq[pos] = (seq[pos] + rng.integers(1, 4, size=n_mut)) % 4
        ascii_seq = bases[seq]
        for _ in range(4):
            st = int(rng.integers(0, len(anc) - 50))
            ascii_seq[st : st + int(rng.integers(1, 30))] = ord("N")
        path = os.path.join(root, f"g{g:05d}.fna")
        with open(path, "wb") as f:
            f.write(b">g%d synthetic\n" % g)
            rows = ascii_seq.reshape(-1, 100)
            nl = np.full((rows.shape[0], 1), ord("\n"), np.uint8)
            f.write(np.hstack([rows, nl]).tobytes())
        files.append(path)
        total += glen
    list_path = os.path.join(root, "bacteria.list")
    with open(list_path, "w") as f:
        f.write("\n".join(files) + "\n")
    return list_path, files, total


def _write_fasta(path: str, records: list[tuple[str, np.ndarray, bytes]],
                 rows_a_piece: int = 100_000) -> None:
    """FASTA of 100-base lines from (name, codes 0..4, alphabet) records:
    code c is written as byte c of the record's alphabet, a piece at a
    time (a few MB of temporaries whatever the record's length)."""
    with open(path, "wb") as f:
        for name, seq, alphabet in records:
            lut = np.frombuffer(alphabet, np.uint8)
            f.write(b">" + name.encode() + b"\n")
            full = len(seq) - len(seq) % 100
            for lo in range(0, full, 100 * rows_a_piece):
                hi = min(full, lo + 100 * rows_a_piece)
                out = np.empty(((hi - lo) // 100, 101), np.uint8)
                out[:, :100] = lut[seq[lo:hi]].reshape(-1, 100)
                out[:, 100] = ord("\n")
                f.write(out.tobytes())
            if full < len(seq):
                f.write(lut[seq[full:]].tobytes() + b"\n")


def make_config4_corpus(root: str, genome_len: int,
                        contig_len: int = 5_000_000, n_contigs: int = 20,
                        seed: int = 77) -> tuple[str, list[str], int]:
    """BASELINE config 4's corpus, the scripts/config4_run.py recipe with
    the same random stream: two single-record genomes of ``genome_len``
    and ``genome_len - 1024`` bases (one ancestor, 1 % of bases mutated,
    16 N runs each) and ``contigs.fna``, ``n_contigs`` contigs of
    ``contig_len`` bases, every third lowercase.  Returns (list path,
    file paths, total bases)."""
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    anc = rng.integers(0, 4, size=genome_len + 64, dtype=np.int8)
    files, total = [], 0
    for g in range(2):
        seq = anc[: genome_len - g * 1024].copy()
        n_mut = genome_len // 100
        pos = rng.integers(0, len(seq), size=n_mut)
        seq[pos] = (seq[pos] + rng.integers(1, 4, size=n_mut)) % 4
        for _ in range(16):  # N runs: code 4
            st = int(rng.integers(0, len(seq) - 200))
            seq[st: st + int(rng.integers(1, 120))] = 4
        path = os.path.join(root, f"mammal{g}.fna")
        _write_fasta(path, [(f"chr{g}", seq, b"ACGTN")])
        files.append(path)
        total += len(seq)
        del seq
    del anc
    contigs = []
    for r in range(n_contigs):
        seq = rng.integers(0, 4, size=contig_len, dtype=np.int8)
        contigs.append((f"contig{r}", seq, b"acgtn" if r % 3 == 0
                        else b"ACGTN"))
        total += contig_len
    path = os.path.join(root, "contigs.fna")
    _write_fasta(path, contigs)
    files.append(path)
    list_path = os.path.join(root, "mammal.list")
    with open(list_path, "w") as f:
        f.write("\n".join(files) + "\n")
    return list_path, files, total


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def _events_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# the host ranges of _trace_ms: the launches it times, and the one small
# launch before them
TIMED_RANGE, PRIMER_RANGE = "kssd_timed", "kssd_primer"
# _device_ms's traces that missed device records, and what each
# measurement then used; printed in phase 3
TRACE_RETRIES: list[dict] = []
# traces taken, and of those the traces with no record of the primer
TRACE_PRIMER = {"traces": 0, "primer_unrecorded": 0}


def _trace_ms(fn, reps: int) -> dict:
    """Device time a call of ``fn`` over ``reps`` calls, from a
    torch.profiler trace (utils/trace_report.py): the device's busy time
    and each kernel's or copy's summed time, by name, of the work those
    calls launched (matched to their launch calls by correlation id),
    the count of their launch calls, and of those the trace holds no
    device record of.  On an H100, traces after the first few in a
    process lost the device record of their first launch, so one small
    launch goes first, outside the timed range; ``TRACE_PRIMER`` counts
    the traces that lost its record."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from rabbitkssd_tpu_torch.utils.trace_report import summarize

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with record_function(PRIMER_RANGE):
            torch.ones(1, device="cuda")
            torch.cuda.synchronize()
        with record_function(TIMED_RANGE):
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="kssd_trace_") as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        rep = summarize(path, top=1 << 20, within=TIMED_RANGE)
        primer = summarize(path, top=0, within=PRIMER_RANGE)
    TRACE_PRIMER["traces"] += 1
    TRACE_PRIMER["primer_unrecorded"] += int(primer["unrecorded"] > 0)
    return {"busy_ms": rep["device_busy_ms"] / reps,
            "launches": rep["launches"], "unrecorded": rep["unrecorded"],
            "by_name": {t["name"]: t["ms"] / reps for t in rep["top"]},
            "count_by_name": {t["name"]: t["count"] for t in rep["top"]}}


def _device_ms(fn, reps: int, kernel: str | None = None,
               tries: int = 5) -> float:
    """Device time a call of ``fn`` from a torch.profiler trace: the
    summed time of the kernels whose name holds ``kernel`` (``reps``
    launches of them), else the device's busy time.  A trace is whole
    when it holds a device record of every launch the calls made; trace
    again, up to ``tries`` times, until one is.  Else the kernel's time
    is the mean of its launches that the fullest trace holds, and the
    busy time (which a partial trace understates) the CUDA-event time of
    ``reps`` calls, an upper bound; each retry and fallback is recorded
    in ``TRACE_RETRIES``."""
    seen, fullest = [], (-1, 0.0)
    for _ in range(tries):
        t = _trace_ms(fn, reps)
        names = [k for k in t["by_name"] if kernel and kernel in k]
        n = sum(t["count_by_name"][k] for k in names)
        ms = (t["busy_ms"] if kernel is None else
              sum(t["by_name"][k] for k in names) * reps / max(n, 1))
        seen.append([t["launches"], t["unrecorded"]])
        if t["launches"] and not t["unrecorded"]:
            if kernel is not None and n != reps:
                raise RuntimeError(f"{kernel}: {n} launches in a whole "
                                   f"trace of {reps} calls")
            if len(seen) > 1:
                TRACE_RETRIES.append({"what": kernel or "busy",
                                      "launches_unrecorded": seen,
                                      "used": "trace"})
            return ms
        fullest = max(fullest, (n, ms))
    if kernel is not None and fullest[0] > 0:
        TRACE_RETRIES.append({"what": kernel, "launches_unrecorded": seen,
                              "used": "mean of the launches traced"})
        return fullest[1]
    TRACE_RETRIES.append({"what": kernel or "busy",
                          "launches_unrecorded": seen,
                          "used": "cuda events"})
    return _events_ms(fn, reps)


# phase 3 (a)'s kept sets: (half_k, half_subk, drlevel) and a seed each
MEMBER_CONFIGS = {"L3": ((10, 6, 3), 1), "L2": ((8, 6, 2), 2),
                  "16,4,1": ((16, 4, 1), 7)}


def kernel_vs_plain(device, half_k: int, half_subk: int, drlevel: int,
                    seed: int, reps: int = 50) -> dict:
    """Kernel vs plain keep test on one kept set; exact equality.  The
    library time is ``kept_lut[dims]`` on the in-range dims (all but the
    5 edge values), one indexing call on a bool table of dim_size.

    ``ms``, ``plain_ms`` and ``library_ms`` are device time a call from
    torch.profiler traces (the kernel's own entries; the device's busy
    time for the plain version and the library call), taken in turns
    plain, kernel, kernel, plain, then library; ``*call_ms`` are
    CUDA-event times a call over ``reps`` back-to-back calls, which
    include the host's issue of each call."""
    import torch

    from rabbitkssd_tpu_torch.host import generate_shuffle
    from rabbitkssd_tpu_torch.ops.member import (keep_tables, member,
                                                 member_plain)

    shuf = generate_shuffle(half_k, half_subk, drlevel)
    dim_size = shuf.dim_size
    dim_end = 1 << (4 * (half_subk - drlevel))
    _, bitmap = keep_tables(shuf.shuffled_dim, dim_end, device)
    rng = np.random.default_rng(seed)
    d = rng.integers(0, dim_size, size=STEP_DIMS + 5).astype(np.int32)
    d[:5] = [-2, -1, dim_size, dim_size - 1, 2**31 - 1]
    dims = torch.from_numpy(d).to(device)
    got = member(dims, bitmap, dim_size)
    want = member_plain(dims, bitmap, dim_size)
    table = shuf.shuffled_dim
    inside = (d >= 0) & (d < dim_size)
    oracle = inside & (table[np.clip(d, 0, dim_size - 1)] < dim_end)
    err = int((got.to(torch.int32) - want.to(torch.int32)).abs().max())
    _require(torch.equal(got, want), "kernel mask != plain mask")
    _require(np.array_equal(got.cpu().numpy(), oracle),
             "kernel mask != table[d] < dim_end")
    kept = (table >= 0) & (table < dim_end)
    n_kept = int(kept.sum())
    if device.type != "cuda":
        return {"kept": n_kept, "max_abs_err": err}
    lut = torch.from_numpy(kept).to(device)
    inside_dims = dims[5:].long()
    _require(torch.equal(lut[inside_dims], want[5:]), "kept_lut[d] != plain")

    def kern():
        member(dims, bitmap, dim_size)

    def plain():
        member_plain(dims, bitmap, dim_size)

    def lib():
        lut[inside_dims]

    def same_bytes():
        torch.ne(dims, 0)

    for _ in range(10):  # warm up (and the clocks)
        kern()
        plain()
        lib()
    turns = [(plain, None), (kern, "member_bitmap_kernel"),
             (kern, "member_bitmap_kernel"), (plain, None), (lib, None)]
    dev = [_device_ms(fn, reps, name) for fn, name in turns]
    call = [_events_ms(fn, reps) for fn, _ in turns]
    # a yardstick, not the same function: one elementwise PyTorch kernel
    # that reads the same dims and writes a bool mask of their size
    same_bytes()
    same_ms = _device_ms(same_bytes, reps)
    # dims in, mask out, the bitmap read once
    bound, by = _bound(5 * d.size + bitmap.numel() * 4,
                       MEMBER_OPS_PER_DIM * d.size)
    return {"kept": n_kept, "n": int(d.size), "max_abs_err": err,
            "ms": (dev[1] + dev[2]) / 2, "plain_ms": (dev[0] + dev[3]) / 2,
            "library_ms": dev[4], "bound_ms": bound, "bound_by": by,
            "call_ms": (call[1] + call[2]) / 2,
            "plain_call_ms": (call[0] + call[3]) / 2,
            "library_call_ms": call[4],
            "ms_turns": dev, "call_ms_turns": call,
            "same_bytes_ms": same_ms}


def _step_batch(params, block: int, seed: int, nb: int = 16):
    """One stream-step batch, by default at the main path's shape: ``nb``
    word rows of ``block`` payload + halo random bases with ~0.5 % N
    runs, its exception list and its valid mask (numpy seed)."""
    import torch

    from rabbitkssd_tpu_torch.engine.sketcher import aligned_halo
    from rabbitkssd_tpu_torch.ops.kmer import pack_words_np, pad_exceptions

    rng = np.random.default_rng(seed)
    L = block + aligned_halo(params)
    codes = rng.integers(0, 4, size=nb * L, dtype=np.int8)
    for st in rng.integers(0, nb * L - 64, size=nb * L // 4000):
        codes[st: st + int(rng.integers(1, 40))] = -1
    flat, _, exc = pack_words_np(codes)
    words = np.concatenate([flat.reshape(nb, L // 16),
                            np.zeros((nb, 2), np.uint32)], axis=1)
    exc = torch.from_numpy(pad_exceptions(exc, nb * L).astype(np.int64))
    valid = torch.ones(nb * L + 1, dtype=torch.bool)
    valid.index_fill_(0, exc, False)
    return torch.from_numpy(words.view(np.int32)), exc, valid


def stream_kernels_vs_plain(device, half_k: int, half_subk: int,
                            drlevel: int, seed: int, reps: int = 30
                            ) -> dict:
    """Phase 3 (b): stream_keep and stream_compact against their plain
    versions at the stream step's shape, bit for bit, and their times;
    the whole step, new against a reconstruction of the earlier eager
    step."""
    import torch

    from rabbitkssd_tpu_torch.engine.sketcher import DeviceSketcher
    from rabbitkssd_tpu_torch.host import KssdParams, generate_shuffle
    from rabbitkssd_tpu_torch.ops.member import (bitmap_summary,
                                                 keep_tables, member)
    from rabbitkssd_tpu_torch.ops.stream import (compact_append,
                                                 compact_append_plain,
                                                 compact_tile_words,
                                                 keep_words,
                                                 keep_words_plain,
                                                 pack_bits, unpack_bits)

    params = KssdParams(half_k, half_subk, drlevel)
    shuf = generate_shuffle(half_k, half_subk, drlevel)
    sk = DeviceSketcher(params, shuf.shuffled_dim, device)
    table, bitmap = sk.tables
    step = sk.step
    h, halo, cap, buf_cap = step.hasher, step.halo, sk.cap, sk.buf_cap
    on_card = device.type == "cuda"
    # a dense kept table (about half the dims kept): in sparse mode far
    # more 32-window groups are flagged than g_cap, so the group cut runs
    dense = keep_tables(np.random.default_rng(seed).integers(
        0, 2 * params.dim_end, size=params.dim_size).astype(np.int32),
        params.dim_end, device)
    # (cap, buf_cap, starting count) a kept set: the main path's, forced
    # overflow, a near-full buffer; on the dense table a cap above the
    # survivors of the first g_cap groups, so that only the cut overflows
    cases = {"shuffled": ((cap, buf_cap, 777), (64, 1 << 12, 0),
                          (cap, buf_cap, buf_cap - cap + 9)),
             "dense": ((1 << 17, 1 << 19, 5), (cap, buf_cap, 777))}
    # stream_compact's tile (keep words); the plain version has none
    tile = compact_tile_words() if on_card else 1024
    out = {"cap": cap, "buf_cap": buf_cap, "tile_words": tile, "cases": []}

    def compare(kw, words, tab, c, bc, c0, mode, what):
        """compact_append against its plain version from zeroed buffers;
        returns (count, overflow)."""
        res = []
        for fn in (compact_append, compact_append_plain):
            bufs = tuple(torch.zeros(bc, dtype=torch.int32, device=device)
                         for _ in range(4))
            cnt, ofl = fn(kw, words, tab, bufs,
                          torch.tensor(c0, dtype=torch.int32, device=device),
                          torch.zeros((), dtype=torch.bool, device=device),
                          3, h, halo, c, bc, mode)
            k = int(cnt)
            res.append((k, bool(ofl), [b[:k].cpu() for b in bufs]))
        (kc, ko, kb), (pc, po, pb) = res
        _require((kc, ko) == (pc, po) and all(
            torch.equal(x, y) for x, y in zip(kb, pb)),
            f"stream_compact != plain ({what}, g_cap {mode}, cap {c}, "
            f"count {c0}): {(kc, ko)} vs {(pc, po)}")
        return kc, ko

    # the main path's shape; 2^17 - 16 payload windows a row, where
    # 32-window groups straddle rows and G is no multiple of the tile;
    # one row of 2048, a grid below one tile
    variants = {}
    for nb, block in ((16, 1 << 17), (16, (1 << 17) - 16), (1, 2048)):
        words, exc, valid = _step_batch(params, block, seed + block, nb)
        words, exc, valid = (t.to(device) for t in (words, exc, valid))
        n = nb * block
        upto = n - 12345 if nb > 1 else n - 123  # a tape tail
        g_cap = (min(n // 32, max(4096, 4 * (n >> 4 * drlevel) // 32))
                 if drlevel >= 3 and n % 32 == 0 else None)
        for kept, (tab, bm) in (("shuffled", (table, bitmap)),
                                ("dense", dense)):
            kw = keep_words(words, valid, upto, h, halo, bm)
            kw_plain = keep_words_plain(words, valid, upto, h, halo, bm)
            _require(torch.equal(kw, kw_plain), f"stream_keep != plain "
                     f"({nb} x {block}, {kept} kept set)")
            survivors = int(unpack_bits(kw, n).sum())
            flags = (kw != 0).cpu()
            n_sel = int(flags.sum())
            _require(kept == "shuffled" or g_cap is None or nb == 1
                     or n_sel > g_cap,
                     f"dense kept set flags {n_sel} groups, g_cap {g_cap}")
            modes = [g_cap] + ([None] if g_cap is not None else [])
            if kept == "dense" and g_cap is not None:
                # the group cut exactly on a tile boundary (all flagged
                # groups of the first three tiles, or of the only one)
                modes.append(int(flags[:3 * tile].sum()))
            for mode in modes:
                for c, bc, c0 in cases[kept]:
                    kc, ko = compare(kw, words, tab, c, bc, c0, mode,
                                     f"{nb} x {block}, {kept} kept set")
                    out["cases"].append({
                        "rows": nb, "block": block, "kept": kept,
                        "g_cap": mode, "flagged_groups": n_sel,
                        "survivors": survivors, "cap": c, "count0": c0,
                        "count": kc, "overflow": ko})
            variants[(nb, block, kept)] = (kw, words, tab, g_cap)

    # back-to-back launches on one stream, so on one look-back scratch:
    # grids of 64, 64 and 1 tiles in turn, sparse and dense; every
    # launch's count and overflow, and the last one's buffers, against
    # the plain version
    cycle = [variants[(16, 1 << 17, "shuffled")],
             variants[(16, (1 << 17) - 16, "dense")],
             variants[(1, 2048, "dense")]]
    want = [compare(kw, words, tab, cap, buf_cap, 777, mode, "reuse")
            for kw, words, tab, mode in cycle]
    bufs = tuple(torch.zeros(buf_cap, dtype=torch.int32, device=device)
                 for _ in range(4))
    got = []
    launches = 100 if on_card else 4  # plain on a CPU rehearsal
    for i in range(launches):
        kw, words, tab, mode = cycle[i % 3]
        got.append(compact_append(
            kw, words, tab, bufs,
            torch.tensor(777, dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.bool, device=device), 3, h, halo,
            cap, buf_cap, mode))
    got = [(int(c), bool(o)) for c, o in got]
    _require(got == [want[i % 3] for i in range(launches)],
             "back-to-back stream_compact launches != plain")
    # the last launch wrote [777, count) over the earlier ones' slots
    kw, words, tab, mode = cycle[(launches - 1) % 3]
    plain_bufs = tuple(torch.zeros(buf_cap, dtype=torch.int32,
                                   device=device) for _ in range(4))
    compact_append_plain(
        kw, words, tab, plain_bufs,
        torch.tensor(777, dtype=torch.int32, device=device),
        torch.zeros((), dtype=torch.bool, device=device), 3, h, halo, cap,
        buf_cap, mode)
    k = got[-1][0]
    _require(all(torch.equal(x[:k], y[:k]) for x, y in zip(bufs, plain_bufs)),
             "the last back-to-back stream_compact launch != plain")
    out["back_to_back"] = {"launches": launches,
                           "counts": sorted(set(got))}
    out["max_abs_err"] = 0  # every comparison above is exact equality
    if not on_card:
        return out

    # times at the main path's shape (block 2^17, its cap and mode)
    words, exc, valid = (t.to(device) for t in
                         _step_batch(params, 1 << 17, seed))
    n = words.shape[0] * (1 << 17)
    g_cap = (min(n // 32, max(4096, 4 * (n >> 4 * drlevel) // 32))
             if drlevel >= 3 else None)
    bufs = tuple(torch.zeros(buf_cap, dtype=torch.int32, device=device)
                 for _ in range(4))
    count = torch.zeros((), dtype=torch.int32, device=device)
    oflow = torch.zeros((), dtype=torch.bool, device=device)
    kw = keep_words(words, valid, n, h, halo, bitmap)
    survivors = int(unpack_bits(kw, n).sum())

    def keep_k():
        keep_words(words, valid, n, h, halo, bitmap)

    def keep_p():
        keep_words_plain(words, valid, n, h, halo, bitmap)

    def comp_k():
        compact_append(kw, words, table, bufs, count, oflow, 0, h, halo,
                       cap, buf_cap, g_cap)

    def comp_p():
        compact_append_plain(kw, words, table, bufs, count, oflow, 0, h,
                             halo, cap, buf_cap, g_cap)

    def step_new():
        step(words, exc, sk.tables, bufs, count, oflow, 0, n)

    nb, nw = words.shape
    L = 16 * (nw - 2)
    coord = (torch.arange(nb, device=device)[:, None] * (1 << 17)
             + torch.arange(L, device=device)[None, :] - halo)

    def step_old():
        # a reconstruction of the earlier eager step: the valid mask, the
        # window hash and member.cu as it ran them, then the keep bits
        # packed and this version's plain compaction, whose unpacking
        # and per-survivor window gathers it did not run (it compacted
        # the bool mask and gathered codes hashed for every window).
        # scripts/torch_ab_sketch.py runs the earlier step itself.
        v = torch.ones(valid.numel(), dtype=torch.bool, device=device)
        v.index_fill_(0, exc, False)
        v = v[: nb * L].view(nb, L) & (coord < n)
        _, _, dim_id, ok = h.windows(words, v)
        hit = member(dim_id, bitmap, h.dimsize_mask + 1)
        k = pack_bits((ok & hit)[:, halo:].reshape(-1))
        compact_append_plain(k, words, table, bufs, count, oflow, 0, h,
                             halo, cap, buf_cap, g_cap)

    # "ms": device time a call from a torch.profiler trace (the kernel's
    # own entries, or the step's busy time); events time a call, in
    # turns, includes the host's issue of each call, which the kernels
    # now run faster than
    times = {}
    for name, kern, plain in (("stream_keep", keep_k, keep_p),
                              ("stream_compact", comp_k, comp_p),
                              ("step", step_new, step_old)):
        for _ in range(5):
            kern()
            plain()
        p1 = _events_ms(plain, reps)
        k1 = _events_ms(kern, reps)
        k2 = _events_ms(kern, reps)
        p2 = _events_ms(plain, reps)
        times[name] = {
            "ms": _device_ms(kern, reps,
                             None if name == "step" else f"{name}_kernel"),
            "events_ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "plain_device_ms": _device_ms(plain, reps),
            "ms_turns": [p1, k1, k2, p2]}
    # the host's time to issue one step (no other thread running)
    for key, fn in (("host_ms", step_new), ("plain_host_ms", step_old)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        times["step"][key] = (time.perf_counter() - t0) / reps * 1e3
        torch.cuda.synchronize()
    G = kw.numel()
    # stream_keep: words, valid mask, bitmap and its summary in, keep
    # words out
    summary, _ = bitmap_summary(bitmap, params.dim_size)
    times["stream_keep"]["bound_ms"], times["stream_keep"]["bound_by"] = \
        _bound(words.numel() * 4 + nb * (nw - 2) * 16 + bitmap.numel() * 4
               + summary.numel() * 4
               + G * 4, KEEP_OPS_PER_WINDOW * n)
    # stream_compact: keep words in; a survivor's three words and table
    # entry in, four slots out (this batch's survivors, up to cap)
    wrote = min(survivors, cap)
    times["stream_compact"]["bound_ms"], \
        times["stream_compact"]["bound_by"] = _bound(
            G * 4 + wrote * (12 + 4 + 16) + 10,
            COMPACT_OPS_PER_WORD * G + COMPACT_OPS_PER_SURVIVOR * wrote)
    out.update({"timed_survivors": survivors, "g_cap": g_cap,
                "times": times})
    return out


def run_cli(argv: list[str]) -> tuple[float, str]:
    """The port's CLI main, in process; returns (wall s, its stderr),
    echoing the stderr."""
    import torch

    from rabbitkssd_tpu_torch.cli import main

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(buf):
        rc = main(argv)
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sys.stderr.write(buf.getvalue())
    _require(rc == 0, f"CLI {argv[:3]} exited {rc}")
    return wall, buf.getvalue()


def _sorted_rows(path: str) -> list[str]:
    with open(path) as f:
        lines = f.readlines()
    return lines[:1] + sorted(lines[1:])


def _sets(path: str) -> dict:
    from rabbitkssd_tpu_torch.host import read_sketches

    return {s.name: np.sort(s.hashes) for s in read_sketches(path).sketches}


def _budgets(stderr: str) -> list[dict]:
    """The sketcher's ``sketch budget:`` JSON lines from the CLI stderr,
    one per sketched list."""
    return [json.loads(part.splitlines()[0])
            for part in stderr.split("sketch budget: ")[1:]]


@contextlib.contextmanager
def _env(**kw: str):
    """Set environment variables for the duration of a block."""
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v


def _reset_launches() -> None:
    from rabbitkssd_tpu_torch.ops.member import member
    from rabbitkssd_tpu_torch.ops.stream import compact_append, keep_words

    member.launches = keep_words.launches = compact_append.launches = 0


def _launches() -> dict:
    """Each kernel wrapper's launches since :func:`_reset_launches`."""
    from rabbitkssd_tpu_torch.ops.member import member
    from rabbitkssd_tpu_torch.ops.stream import compact_append, keep_words

    return {"member_bitmap": member.launches,
            "stream_keep": keep_words.launches,
            "stream_compact": compact_append.launches}


def _launches_cover(budgets: list[dict], launches: dict, on_card: bool,
                    what: str) -> None:
    """On the card each stream kernel launches once a batch and once a
    re-run, and member.cu (off the path) never; a CPU rehearsal runs the
    plain versions instead."""
    runs = sum(b["batches"] + b["reruns"] for b in budgets)
    want = runs if on_card else 0
    _require(launches["stream_keep"] == want
             and launches["stream_compact"] == want
             and launches["member_bitmap"] == 0
             and min(b["batches"] for b in budgets) > 0,
             f"{what}: launches {launches} for {runs} batches + re-runs")


def main_path(device, work: str, n_genomes: int, genome_len: int
              ) -> tuple[dict, dict]:
    """Phase 4 + 5a/5b: corpus -> CLI sketch -> CLI alldist, then the
    oracle and device-counting checks.  Returns (the numbers to print,
    the paths and sets later phases reuse)."""
    from rabbitkssd_tpu_torch.host import (KssdParams, generate_shuffle,
                                           oracle_hashes_numpy,
                                           read_records, write_shuffle_file)

    t0 = time.perf_counter()
    list_path, files, total = make_corpus(os.path.join(work, "corpus"),
                                          n_genomes, genome_len, SEED)
    shuf = generate_shuffle(10, 6, 3)
    shuf_path = os.path.join(work, "L3K10.shuf")
    write_shuffle_file(shuf, shuf_path)
    setup_s = time.perf_counter() - t0
    dev = ["--device", str(device)]
    sketch_path = os.path.join(work, "bact.sketch")
    dist_path = os.path.join(work, "bact.alldist")

    _reset_launches()
    sketch_s, err = run_cli(dev + ["sketch", "-i", list_path, "-o",
                                   sketch_path, "-L", shuf_path])
    alldist_s, _ = run_cli(dev + ["alldist", "-i", sketch_path, "-o",
                                  dist_path, "-D", MAX_DIST])
    launches = _launches()
    (budget,) = _budgets(err)
    _launches_cover([budget], launches, device.type == "cuda", "main path")
    _require(budget["batches"] >= -(-total // (16 << 17)),
             f"{budget['batches']} batches cannot cover {total} bases")
    params = KssdParams(10, 6, 3)

    # (a) oracle: first, middle and last genome
    got = _sets(sketch_path)
    for path in (files[0], files[len(files) // 2], files[-1]):
        recs = read_records(path)
        want = np.unique(np.concatenate(
            [oracle_hashes_numpy(r.seq, params, shuf.shuffled_dim)
             for r in recs])).astype(np.uint32)
        _require(np.array_equal(got[path], want),
                 f"sketch of {path} != oracle")
    # (b) device counting gives the same rows
    dist2 = os.path.join(work, "bact.matmul.alldist")
    with _env(**DEVICE_COUNTING):
        matmul_s, _ = run_cli(dev + ["alldist", "-i", sketch_path, "-o",
                                     dist2, "-D", MAX_DIST])
    rows = _sorted_rows(dist_path)
    _require(rows == _sorted_rows(dist2), "matmul alldist rows != auto rows")
    nums = {"genomes": len(files), "bases": total, "setup_s": setup_s,
            "sketch_s": sketch_s, "alldist_s": alldist_s,
            "alldist_matmul_s": matmul_s,
            "sketch_mbase_per_s": total / 1e6 / sketch_s,
            "rows": len(rows) - 1, "launches": launches, "budget": budget}
    ctx = {"files": files, "list": list_path, "shuf": shuf,
           "shuf_path": shuf_path, "sketch": sketch_path, "sets": got,
           "rows": rows}
    return nums, ctx


def forced_overflow(device, ctx: dict) -> dict:
    """Phase 5d: the three largest corpus genomes with a per-batch cap
    of 64 survivors (an L3K10 batch holds ~500), so every flush window
    overflows and re-runs batch by batch at full capacity on the card;
    the hash sets must equal the main path's."""
    from rabbitkssd_tpu_torch.engine.sketcher import (DeviceSketcher,
                                                      StreamStep)
    from rabbitkssd_tpu_torch.host import KssdParams

    params = KssdParams(10, 6, 3)
    sk = DeviceSketcher(params, ctx["shuf"].shuffled_dim, device)
    sk.cap = 64
    sk.step = StreamStep(params, sk.cap, sk.buf_cap)
    files = ctx["files"][-3:]
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        out = sk.sketch_files(files)
    wall = time.perf_counter() - t0
    b = sk.last_budget
    _require(b["batches"] > 0 and b["reruns"] == b["batches"],
             f"forced overflow: {b['reruns']} re-runs of {b['batches']} "
             "batches")
    launches = _launches()
    _launches_cover([b], launches, device.type == "cuda", "forced overflow")
    for s in out.sketches:
        _require(np.array_equal(s.hashes, ctx["sets"][s.name]),
                 f"forced-overflow sketch of {s.name} != main path")
    return {"genomes": len(files), "wall_s": wall, "launches": launches,
            "budget": b}


def walk_rate(ctx: dict, copies: int = 1, reps: int = 20) -> dict:
    """Increments/s of the native posting walk counting the corpus
    sketch all-vs-all on the host (the cost model's WALK_RATE): the
    join size over the median wall of ``reps`` walks.  ``copies`` > 1
    repeats every sketch, for a join ``copies**2`` times larger."""
    from rabbitkssd_tpu_torch.engine.dist_engine import _CsrIndex
    from rabbitkssd_tpu_torch.host import read_sketches

    hashes = [s.hashes for s in read_sketches(ctx["sketch"]).sketches]
    hashes = hashes * copies
    n = len(hashes)
    csr = _CsrIndex.from_hashes(hashes)
    lp = csr.walk_layout(csr.side_pairs(0, n))
    join = int(lp[1][-1])
    common = np.empty((n, n), np.int32)
    csr.walk(common, lp)  # warm
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        csr.walk(common, lp)
        walls.append(time.perf_counter() - t0)
    s = float(np.median(walls))
    return {"genomes": n, "join": join, "median_s": s,
            "increments_per_s": join / s}


def profile_sketch(device, ctx: dict, work: str, unprofiled: dict) -> dict:
    """Phase 7: the CLI sketch of the corpus again, warm, with each CLI
    phase traced by torch.profiler under ``work``; summarizes the
    sketch phase's trace."""
    from rabbitkssd_tpu_torch.utils import timers
    from rabbitkssd_tpu_torch.utils.trace_report import summarize

    trace_dir = os.path.join(work, "traces")
    stem = "computing_sketches_and_save_sketches_into_file"
    saved = timers.PROFILE_DIR
    timers.PROFILE_DIR = trace_dir
    try:
        wall, err = run_cli(["--device", str(device), "sketch", "-i",
                             ctx["list"], "-o", ctx["sketch"], "-L",
                             ctx["shuf_path"]])
    finally:
        timers.PROFILE_DIR = saved
    (b,) = _budgets(err)
    (trace,) = glob.glob(os.path.join(trace_dir, f"{stem}.*.json"))
    rep = summarize(trace, top=1 << 20)
    kernel_ms = {k: sum(t["ms"] for t in rep["top"]
                        if f"{k}_kernel" in t["name"])
                 for k in ("stream_keep", "stream_compact",
                           "member_bitmap")}
    dev_ms = sum(t["ms"] for t in rep["top"])
    return {"trace": os.path.basename(trace), "cli_wall_s": wall,
            "pipeline_wall_s": b["wall"],
            "unprofiled_pipeline_wall_s": unprofiled["wall"],
            "span_ms": rep["span_ms"], "device_busy_ms": rep["device_busy_ms"],
            "busy_share": rep["busy_share"],
            "device_events": rep["device_events"], "batches": b["batches"],
            "device_busy_ms_per_batch": rep["device_busy_ms"] / b["batches"],
            "device_events_per_batch": rep["device_events"] / b["batches"],
            "dispatch_s": b["dispatch"],
            "dispatch_ms_per_batch": 1e3 * b["dispatch"] / b["batches"],
            "unprofiled_dispatch_ms_per_batch":
                1e3 * unprofiled["dispatch"] / unprofiled["batches"],
            "kernel_ms": kernel_ms,
            "kernel_share_of_device_ms": {
                k: v / dev_ms if dev_ms else 0.0
                for k, v in kernel_ms.items()},
            "top": [{"ms": t["ms"], "count": t["count"], "cat": t["cat"],
                     "name": t["name"][:90]} for t in rep["top"][:15]]}


def golden_checks(device, work: str) -> list[str]:
    """Phase 5c: the port's CLI on tests/golden equals the reference
    binary's sketches (as sets) and alldist rows (sorted)."""
    root = os.path.join(work, "golden")
    os.makedirs(root)
    shutil.copytree(os.path.join(GOLDEN, "genomes"),
                    os.path.join(root, "genomes"))
    shutil.copy(os.path.join(GOLDEN, "fa.list"), root)
    dev = ["--device", str(device)]
    done = []
    cwd = os.getcwd()
    os.chdir(root)  # the list and the goldens name genomes relatively
    try:
        for k, cases in ((5, [("1.0", [], "alldist")]),
                         (8, [("1.0", [], "alldist"),
                              ("1.0", ["-M", "1"], "allcont")]),
                         (10, [("0.5", [], "alldist")])):
            stem = f"fa_k{k}s4l1"
            run_cli(dev + ["sketch", "-i", "fa.list", "-o", f"{stem}.sketch",
                           "-L", os.path.join(GOLDEN, f"k{k}s4l1.shuf")])
            got = _sets(f"{stem}.sketch")
            want = _sets(os.path.join(GOLDEN, f"{stem}.sketch"))
            _require(got.keys() == want.keys() and all(
                np.array_equal(got[n], want[n]) for n in got),
                f"{stem}.sketch != golden")
            for dmax, extra, kind in cases:
                out = f"{stem}.{kind}"
                run_cli(dev + ["alldist", "-i", f"{stem}.sketch", "-o", out,
                               "-D", dmax] + extra)
                _require(_sorted_rows(out) == _sorted_rows(
                    os.path.join(GOLDEN, out)), f"{out} != golden")
                done.append(out)
        # FASTQ with the abundance and quality filters, and a query
        # sketch (no index), as tests/golden/gen_golden.py made them
        for lst, extra, stem in (("fq.list", ["-n", "2", "-Q", "40"],
                                  "fq_k8s4l1"),
                                 ("fa_query.list", ["-q"], "faq_k8s4l1")):
            shutil.copy(os.path.join(GOLDEN, lst), root)
            run_cli(dev + ["sketch", "-i", lst, "-o", f"{stem}.sketch", "-L",
                           os.path.join(GOLDEN, "k8s4l1.shuf")] + extra)
            got = _sets(f"{stem}.sketch")
            want = _sets(os.path.join(GOLDEN, f"{stem}.sketch"))
            _require(got.keys() == want.keys() and all(
                np.array_equal(got[n], want[n]) for n in got),
                f"{stem}.sketch != golden")
            done.append(f"{stem}.sketch")
    finally:
        os.chdir(cwd)
    return done


def _rows_by_query(path: str) -> dict:
    """dist rows grouped by query: {query: [(ref, common, dist text)]}."""
    out: dict = {}
    with open(path) as f:
        next(f)
        for line in f:
            q, r, counts, _, d = line.rstrip("\n").split("\t")
            out.setdefault(q, []).append((r, int(counts.split("|")[0]), d))
    return out


def config2(device, work: str, ctx: dict) -> dict:
    """Phase 8 (a)-(d): BASELINE config 2 through the CLI ``dist``."""
    root = os.path.join(work, "config2")
    os.makedirs(root)
    files = ctx["files"]
    lists = {}
    for side, part in (("ref", files[:N_REF]), ("query", files[N_REF:])):
        lists[side] = os.path.join(root, f"{side}.list")
        with open(lists[side], "w") as f:
            f.write("\n".join(part) + "\n")
    ref_sk, q_sk = lists["ref"] + ".sketch", lists["query"] + ".sketch"
    dev = ["--device", str(device)]
    walls = {}

    # (a) both sides sketched from FASTA on the card
    out_a = os.path.join(root, "c2.dist")
    _reset_launches()
    walls["a_dist_from_fasta_s"], err = run_cli(
        dev + ["dist", "-r", lists["ref"], "-q", lists["query"], "-L",
               ctx["shuf_path"], "-D", MAX_DIST, "-o", out_a])
    launches = _launches()
    budgets = _budgets(err)
    _require(len(budgets) == 2, f"{len(budgets)} sketch budgets, not 2")
    _launches_cover(budgets, launches, device.type == "cuda", "config 2")
    for path, part in ((ref_sk, files[:N_REF]), (q_sk, files[N_REF:])):
        got = _sets(path)
        _require(sorted(got) == sorted(part), f"{path}: genome names")
        for name, h in got.items():
            _require(np.array_equal(h, ctx["sets"][name]),
                     f"config 2 sketch of {name} != phase 4")
    rows_a = _sorted_rows(out_a)
    _require(len(rows_a) > 1, "config 2 dist wrote no rows")

    # (b) device counting gives the same rows
    out_b = os.path.join(root, "c2.matmul.dist")
    with _env(**DEVICE_COUNTING):
        walls["b_dist_matmul_s"], _ = run_cli(
            dev + ["dist", "-r", ref_sk, "-q", q_sk, "-D", MAX_DIST, "-o",
                   out_b])
    _require(_sorted_rows(out_b) == rows_a, "matmul dist rows != auto rows")

    # (c) top-N against recounts and the full rows
    out_n = os.path.join(root, "c2.top.dist")
    out_full = os.path.join(root, "c2.full.dist")
    walls["c_dist_top_n_s"], _ = run_cli(
        dev + ["dist", "-r", ref_sk, "-q", q_sk, "-N", str(TOP_N), "-D",
               "1.0", "-o", out_n])
    walls["c_dist_full_s"], _ = run_cli(
        dev + ["dist", "-r", ref_sk, "-q", q_sk, "-D", "1.0", "-o",
               out_full])
    top, full = _rows_by_query(out_n), _rows_by_query(out_full)
    queries = files[N_REF:]
    _require(sorted(top) == sorted(queries) and all(
        len(top[q]) == TOP_N for q in queries), "top-N rows per query")
    _require(all(len(full[q]) == N_REF for q in queries),
             "-D 1.0 rows per query")
    sets = ctx["sets"]
    for q in (queries[0], queries[len(queries) // 2], queries[-1]):
        for r, c, _ in top[q]:
            _require(c == np.intersect1d(sets[q], sets[r]).size,
                     f"top-N common of {q} vs {r} != recount")
        _require(sorted(float(d) for _, _, d in top[q])
                 == sorted(float(d) for _, _, d in full[q])[:TOP_N],
                 f"top-N distances of {q} are not its {TOP_N} smallest")

    # (d) the reference binary's dist goldens
    gdir = os.path.join(work, "golden_dist")
    shutil.copytree(os.path.join(GOLDEN, "genomes"),
                    os.path.join(gdir, "genomes"))
    for name in ("fa_query.list", "fa_k8s4l1.sketch"):
        shutil.copy(os.path.join(GOLDEN, name), gdir)
    cwd = os.getcwd()
    os.chdir(gdir)  # the list names genomes relatively
    try:
        for extra, golden in (([], "fa_k8s4l1.dist"),
                              (["-N", "2"], "fa_k8s4l1.distN2")):
            walls[f"d_{golden}_s"], _ = run_cli(
                dev + ["dist", "-r", "fa_k8s4l1.sketch", "-q",
                       "fa_query.list", "-L",
                       os.path.join(GOLDEN, "k8s4l1.shuf"), "-D", "1.0",
                       "-o", golden] + extra)
            _require(_sorted_rows(golden) == _sorted_rows(
                os.path.join(GOLDEN, golden)), f"{golden} != golden")
    finally:
        os.chdir(cwd)
    return {"ref": N_REF, "query": len(queries), "launches": launches,
            "batches": [b["batches"] for b in budgets],
            "rows": len(rows_a) - 1, "walls": walls,
            "ref_sketch": ref_sk, "query_sketch": q_sk}


def _walk_counts(rows_hashes, cols_hashes) -> np.ndarray:
    """The native posting walk's [rows, cols] intersection counts."""
    from rabbitkssd_tpu_torch.engine.dist_engine import _CsrIndex

    csr = _CsrIndex.from_hashes(cols_hashes)
    lp = csr.walk_layout(csr.query_pairs(rows_hashes))
    out = np.empty((len(rows_hashes), len(cols_hashes)), np.int32)
    csr.walk(out, lp)
    return out


def legacy(device, work: str, ctx: dict, c2: dict, reps: int = 10) -> dict:
    """Phase 8 (e): the legacy sorted-intersection paths on the card,
    their counts against the walk's, and their files against a CPU run."""
    import torch

    from rabbitkssd_tpu_torch.host import read_sketches
    from rabbitkssd_tpu_torch.ops.intersect import (_ordered_int64,
                                                    _pair_common,
                                                    common_counts_sorted,
                                                    default_chunk,
                                                    pad_sketch_matrix)

    root = os.path.join(work, "legacy")
    os.makedirs(root)
    ref_sk, q_sk = c2["ref_sketch"], c2["query_sketch"]
    legs = {"alldist": ["alldist", "-i", ctx["sketch"], "-D", MAX_DIST],
            "dist_ref_ge_query": ["dist", "-r", ref_sk, "-q", q_sk, "-D",
                                  MAX_DIST],
            "dist_ref_lt_query": ["dist", "-r", q_sk, "-q", ref_sk, "-D",
                                  MAX_DIST]}
    walls, rows = {}, {}
    with _env(KSSD_LEGACY_DIST="1"):
        for tag, dev in (("card", str(device)), ("cpu", "cpu")):
            for leg, argv in legs.items():
                walls[f"{leg}_{tag}_s"], _ = run_cli(
                    ["--device", dev] + argv
                    + ["-o", os.path.join(root, f"{leg}.{tag}")])
    for leg in legs:
        with open(os.path.join(root, f"{leg}.card"), "rb") as f:
            card = f.read()
        with open(os.path.join(root, f"{leg}.cpu"), "rb") as f:
            _require(f.read() == card, f"legacy {leg}: cpu file != card file")
        _require(card.startswith(b" "), f"legacy {leg}: header")
        rows[leg] = card.count(b"\n") - 1

    # counts on the card against the walk's
    allh = [np.sort(s.hashes) for s in read_sketches(ctx["sketch"]).sketches]
    rh = [np.sort(s.hashes) for s in read_sketches(ref_sk).sketches]
    qh = [np.sort(s.hashes) for s in read_sketches(q_sk).sketches]
    _require(np.array_equal(common_counts_sorted(allh, None, device),
                            _walk_counts(allh, allh)),
             "sorted intersection (all vs all) on the card != walk")
    _require(np.array_equal(common_counts_sorted(rh, qh, device),
                            _walk_counts(qh, rh).T),
             "sorted intersection (ref vs query) on the card != walk")

    # the all-vs-all intersection's time: card (CUDA events) and CPU
    a, sizes = pad_sketch_matrix(allh)
    sizes = torch.from_numpy(sizes.astype(np.int64))
    args = {}
    for tag, dev in (("card", device), ("cpu", torch.device("cpu"))):
        rows_t = _ordered_int64(a, dev)
        args[tag] = (rows_t, sizes.to(dev), rows_t, sizes.to(dev),
                     default_chunk(dev, a.size))
    t0 = time.perf_counter()
    for _ in range(2):
        _pair_common(*args["cpu"])
    nums = {"rows": rows, "walls": walls, "shape": list(a.shape),
            "chunk": {k: v[-1] for k, v in args.items()},
            "intersect_cpu_ms": (time.perf_counter() - t0) / 2 * 1e3,
            "cpu_threads": torch.get_num_threads()}
    if device.type == "cuda":
        _pair_common(*args["card"])  # warm
        nums["intersect_card_ms"] = _events_ms(
            lambda: _pair_common(*args["card"]), reps)
    return nums


# --------------------------------------------------------------------------
# phase 9: several ranks under torchrun
# --------------------------------------------------------------------------

def torchrun(nproc: int, root: str, mode: str, timeout: float = 600
             ) -> tuple[float, list[dict]]:
    """This script's ``--rank <mode>`` under ``torchrun --standalone``
    with ``nproc`` ranks, each reading ``root/<mode>.json`` and writing
    ``root/<mode>.rank<r>.json``.  Returns (wall s, the reports in rank
    order).  Any rank's failure fails it; on the deadline the launcher
    and its ranks are killed."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={nproc}", os.path.abspath(__file__), "--rank",
           mode, root]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        log, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"torchrun {mode}: no end in {timeout} s") from None
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        sys.stderr.write(log[-8000:])
        raise RuntimeError(f"torchrun {mode}: exit {proc.returncode}")
    reports = []
    for r in range(nproc):
        with open(os.path.join(root, f"{mode}.rank{r}.json")) as f:
            reports.append(json.load(f))
    return wall, reports


def rank_cli(spec: dict) -> dict:
    """Phase 9 (a), one rank: the CLI chain, the kernels' launches
    counted from 0 around each command.  Ranks that share a device start
    their gloo group first; the CLI then keeps it."""
    from rabbitkssd_tpu_torch.parallel.multihost import init_multihost
    from rabbitkssd_tpu_torch.parallel.sharded import make_mesh

    if spec["shared"]:
        _require(init_multihost(cuda=False), "no process group")
    steps = []
    for step in spec["chain"]:
        _reset_launches()
        with _env(**step["env"]):
            wall, err = run_cli(step["argv"])
        steps.append({"name": step["name"], "wall_s": wall,
                      "launches": _launches(), "budgets": _budgets(err),
                      "saved": "save the sketches into" in err})
    mesh = make_mesh()
    return {"mesh": [mesh.dp, mesh.vp], "steps": steps}


def rank_mesh(spec: dict, root: str) -> dict:
    """Phase 9 (b), one of 3 ranks sharing one card (gloo only: NCCL
    refuses two ranks on one card): the ring counts and the sharded
    sketch at an explicit Mesh(3, 1)."""
    import torch

    from rabbitkssd_tpu_torch import resolve_device
    from rabbitkssd_tpu_torch.engine.sketcher import sketch_file_list
    from rabbitkssd_tpu_torch.host import read_shuffle_file
    from rabbitkssd_tpu_torch.parallel.multihost import init_multihost, rank
    from rabbitkssd_tpu_torch.parallel.sharded import (Mesh,
                                                       sharded_common_counts)

    _require(init_multihost(cuda=False), "no process group")
    device = resolve_device(spec["device"])
    torch.ones(1, device=device).sum().item()  # the context, untimed
    mesh = Mesh(3, 1)
    hashes = _sketch_hashes(spec["sketch"])
    n_ref = spec["n_ref"]
    with _env(KSSD_HOST_JOIN_MAX="0"):  # the ring, not the host walk
        t0 = time.perf_counter()
        sym = sharded_common_counts(hashes, None, mesh, device)
        ring_s = time.perf_counter() - t0
        rq = sharded_common_counts(hashes[:n_ref], hashes[n_ref:], mesh,
                                   device)
    err = io.StringIO()
    _reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        sk = sketch_file_list(spec["list"], read_shuffle_file(spec["shuf"]),
                              device=device, mesh=mesh)
    sketch_s = time.perf_counter() - t0
    launches = _launches()
    np.savez(os.path.join(root, f"mesh.rank{rank()}.npz"), sym=sym, rq=rq,
             **{f"g{i}": s.hashes for i, s in enumerate(sk.sketches)})
    (budget,) = _budgets(err.getvalue())
    return {"mesh": [mesh.dp, mesh.vp], "coords": list(mesh.coords),
            "ring_s": ring_s, "sketch_s": sketch_s, "launches": launches,
            "budget": budget, "names": [s.name for s in sk.sketches]}


def rank_main(mode: str, root: str) -> None:
    """Entry of one phase-9 rank (``chip_smoke.py --rank <mode> <root>``,
    started by :func:`torchrun`)."""
    sys.path.insert(0, HERE)
    from rabbitkssd_tpu_torch.parallel.multihost import shutdown

    with open(os.path.join(root, f"{mode}.json")) as f:
        spec = json.load(f)
    report = rank_cli(spec) if mode == "cli" else rank_mesh(spec, root)
    with open(os.path.join(root, f"{mode}.rank{os.environ['RANK']}.json"),
              "w") as f:
        json.dump(report, f)
    shutdown()


def ranks_cli(device, work: str, ctx: dict) -> dict:
    """Phase 9 (a): the CLI sketch + alldist under torchrun, one rank per
    card on several cards, else 3 ranks sharing cuda:0 (a CPU rehearsal:
    the CPU) in a gloo group."""
    import torch

    root = os.path.join(work, "ranks_cli")
    os.makedirs(root)
    on_card = device.type == "cuda"
    n_cards = torch.cuda.device_count() if on_card else 0
    shared = n_cards < 2
    nproc = 3 if shared else n_cards
    dev = ["--device", "cpu" if not on_card
           else "cuda:0" if shared else "cuda"]
    sk = os.path.join(root, "p9.sketch")
    outs = {"alldist": os.path.join(root, "p9.alldist"),
            "alldist_ring": os.path.join(root, "p9.ring.alldist")}
    chain = [{"name": "sketch", "env": {},
              "argv": dev + ["sketch", "-i", ctx["list"], "-o", sk, "-L",
                             ctx["shuf_path"]]}]
    for name, out in outs.items():
        chain.append({"name": name, "argv": dev + [
            "alldist", "-i", sk, "-o", out, "-D", MAX_DIST],
            "env": {"KSSD_HOST_JOIN_MAX": "0"} if name == "alldist_ring"
            else {}})
    with open(os.path.join(root, "cli.json"), "w") as f:
        json.dump({"chain": chain, "shared": shared}, f)
    wall_a, reps_a = torchrun(nproc, root, "cli")
    _require(sorted(os.listdir(root)) == sorted(
        ["cli.json", "p9.sketch", "p9.sketch.dict", "p9.sketch.index",
         *(os.path.basename(o) for o in outs.values()),
         *(f"cli.rank{r}.json" for r in range(nproc))]),
        f"(a) files: {sorted(os.listdir(root))}")
    _require([rep["steps"][0]["saved"] for rep in reps_a]
             == [r == 0 for r in range(nproc)], "(a) a rank > 0 saved")
    got = _sets(sk)
    _require(got.keys() == ctx["sets"].keys() and all(
        np.array_equal(got[k], ctx["sets"][k]) for k in got),
        "torchrun sketch sets != phase 4")
    for name, out in outs.items():
        _require(_sorted_rows(out) == ctx["rows"],
                 f"torchrun {name} rows != phase 4")
    for r, rep in enumerate(reps_a):
        (budget,) = rep["steps"][0]["budgets"]
        _launches_cover([budget], rep["steps"][0]["launches"], on_card,
                        f"(a) rank {r} sketch")
    return {"ranks": nproc, "device": dev[1], "mesh": reps_a[0]["mesh"],
            "group": "gloo" if shared else "cpu:gloo,cuda:nccl",
            "wall_s": wall_a, "steps": [rep["steps"] for rep in reps_a]}


def ranks_mesh(device, work: str, ctx: dict) -> dict:
    """Phase 9 (b): 3 ranks sharing cuda:0 (a CPU rehearsal: the CPU) at
    Mesh(3, 1): the ring counts and the sharded sketch."""
    from rabbitkssd_tpu_torch.ops.distance import common_counts

    root = os.path.join(work, "ranks_mesh")
    os.makedirs(root)
    on_card = device.type == "cuda"
    with open(os.path.join(root, "mesh.json"), "w") as f:
        json.dump({"device": "cuda:0" if on_card else "cpu",
                   "sketch": ctx["sketch"],
                   "list": ctx["list"], "shuf": ctx["shuf_path"],
                   "n_ref": N_REF}, f)
    wall_b, reps_b = torchrun(3, root, "mesh")
    hashes = _sketch_hashes(ctx["sketch"])
    with _env(**DEVICE_COUNTING):
        want = {"sym": common_counts(hashes, None, device),
                "rq": common_counts(hashes[:N_REF], hashes[N_REF:], device)}
    for r, rep in enumerate(reps_b):
        z = np.load(os.path.join(root, f"mesh.rank{r}.npz"))
        for k, v in want.items():
            _require(np.array_equal(z[k], v),
                     f"(b) rank {r} ring {k} counts != forced _int_mm")
        _require(sorted(rep["names"]) == sorted(ctx["files"]),
                 f"(b) rank {r} genome names")
        for i, name in enumerate(rep["names"]):
            _require(np.array_equal(z[f"g{i}"], ctx["sets"][name]),
                     f"(b) rank {r} sketch of {name} != phase 4")
        _launches_cover([rep["budget"]], rep["launches"], on_card,
                        f"(b) rank {r}")
    return {"ranks": 3, "wall_s": wall_b,
            "per_rank": [{k: rep[k] for k in ("coords", "ring_s", "sketch_s",
                                              "launches", "budget")}
                         for rep in reps_b]}


def _sketch_hashes(path: str) -> list[np.ndarray]:
    from rabbitkssd_tpu_torch.host import read_sketches

    return [s.hashes for s in read_sketches(path).sketches]


# --------------------------------------------------------------------------
# phase 10: BASELINE config 4
# --------------------------------------------------------------------------

def child_main(spec_path: str) -> None:
    """Entry of phase 10 (a)'s child (``chip_smoke.py --child <spec>``):
    one CLI command with the kernels' launches counted from 0; writes
    the wall, launches, sketch budgets, its peak RSS before the command
    (torch imported, the device's context made) and the device's peak
    allocation to the spec's report path."""
    import resource

    import torch

    sys.path.insert(0, HERE)
    from rabbitkssd_tpu_torch.host import load_native

    with open(spec_path) as f:
        spec = json.load(f)
    device = spec["argv"][spec["argv"].index("--device") + 1]
    torch.zeros(1, device=device).sum().item()
    before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
    _reset_launches()
    with _env(**spec["env"]):
        wall, err = run_cli(spec["argv"])
    with open(spec["report"], "w") as f:
        json.dump({"wall_s": wall, "launches": _launches(),
                   "budgets": _budgets(err),
                   "native": load_native() is not None,
                   "peak_rss_before_cli_bytes": before,
                   "device_peak_bytes": (torch.cuda.max_memory_allocated()
                                         if device.startswith("cuda")
                                         else None)}, f)


# Starts one command and prints its exit code and the ru_maxrss (KiB) of
# os.wait4.  A process's ru_maxrss starts from the high-water mark of the
# process it was forked from (Linux carries it across the exec), so the
# command is started from this small process, not from the smoke.
_LAUNCHER = """
import json, os, subprocess, sys
p = subprocess.Popen(json.loads(sys.argv[1]), stdout=sys.stderr)
_, status, usage = os.wait4(p.pid, 0)
print(json.dumps([os.waitstatus_to_exitcode(status), usage.ru_maxrss]))
"""


def _child_cli(argv: list[str], env: dict, root: str, timeout: float = 900
               ) -> tuple[dict, int]:
    """:func:`child_main` in a child process: (its report, its own peak
    RSS in bytes, the ``ru_maxrss`` of ``os.wait4``)."""
    spec = os.path.join(root, "child.json")
    report = os.path.join(root, "child.report.json")
    with open(spec, "w") as f:
        json.dump({"argv": argv, "env": env, "report": report}, f)
    cmd = [sys.executable, os.path.abspath(__file__), "--child", spec]
    proc = subprocess.Popen([sys.executable, "-c", _LAUNCHER,
                             json.dumps(cmd)], cwd=HERE,
                            stdout=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"child {argv[2:4]}: no end in {timeout} s"
                           ) from None
    rc, maxrss = json.loads(out.strip().splitlines()[-1])
    _require(proc.returncode == 0 and rc == 0,
             f"child {argv[2:4]} exited {rc}")
    with open(report) as f:
        return json.load(f), maxrss * 1024  # KiB on Linux


def _write_record(path: str, name: str, seq: bytes) -> None:
    """One FASTA record in 100-base lines."""
    with open(path, "wb") as f:
        f.write(b">" + name.encode() + b"\n")
        for lo in range(0, len(seq), 100):
            f.write(seq[lo: lo + 100] + b"\n")


def _encode_pieces(records, piece: int = 1 << 26) -> np.ndarray:
    """``encode_concat`` of (seq, None) records, a piece of each record at
    a time (its lookup makes a temporary of 8 bytes a base)."""
    from rabbitkssd_tpu_torch.ops.kmer import encode_concat

    parts = []
    for i, (seq, _) in enumerate(records):
        if i:
            parts.append(np.full(1, -1, np.int8))
        parts += [encode_concat([(seq[o: o + piece], None)])
                  for o in range(0, len(seq), piece)]
    return np.concatenate(parts)


def config4(device, work: str, genome_len: int = 1_200_000_000,
            contig_len: int = 5_000_000, threshold: int | None = None,
            rows: int = 128) -> dict:
    """Phase 10: BASELINE config 4 through the port on ``device``.
    ``threshold``: ``KSSD_STREAM_THRESHOLD`` for (a) (None: the default,
    1 GiB); ``rows``: blocks a call of (d)'s step.  A CPU rehearsal
    lowers all three with ``genome_len``."""
    import torch

    from rabbitkssd_tpu_torch.host import (KssdParams, generate_shuffle,
                                           oracle_hashes_numpy,
                                           read_records, read_sketches,
                                           write_shuffle_file)
    from rabbitkssd_tpu_torch.ops.kmer import combine_hash_words, pack_blocks
    from rabbitkssd_tpu_torch.parallel.sharded import (
        Mesh, make_sharded_sketch_step)

    t_phase = time.perf_counter()
    root = os.path.join(work, "config4")
    on_card = device.type == "cuda"
    dev = ["--device", str(device)]
    params = KssdParams(12, 6, 3)
    nums: dict = {}
    try:
        t0 = time.perf_counter()
        list_path, files, total = make_config4_corpus(root, genome_len,
                                                      contig_len)
        shuf = generate_shuffle(12, 6, 3)
        shuf_path = os.path.join(root, "L3K12.shuf")
        write_shuffle_file(shuf, shuf_path)
        sizes = [os.path.getsize(f) for f in files]
        limit = (1 << 30) if threshold is None else threshold
        _require(min(sizes[:2]) > limit > sizes[2],
                 f"file sizes {sizes} against the threshold {limit}")
        nums.update(bases=total, file_bytes=sizes,
                    corpus_s=time.perf_counter() - t0)

        # (a) the CLI sketch in a child process, for its own peak RSS
        sk = os.path.join(root, "c4.sketch")
        env = {} if threshold is None else {
            "KSSD_STREAM_THRESHOLD": str(threshold)}
        rep, maxrss = _child_cli(dev + ["sketch", "-i", list_path, "-o",
                                        sk, "-L", shuf_path], env, root)
        (budget,) = rep["budgets"]
        _launches_cover([budget], rep["launches"], on_card, "config 4 (a)")
        _require(rep["native"], "no native reader, so no chunked reader")
        sset = read_sketches(sk)
        sets = {s.name: np.sort(s.hashes) for s in sset.sketches}
        _require(sorted(sets) == sorted(files), "config 4 genome names")
        _require(params.use64 and sset.info.id == params.sketch_id and all(
            h.dtype == np.uint64 for h in sets.values()) and max(
            int(h.max()) for h in sets.values()) >= 1 << 32,
            "config 4: no 64-bit hashes")
        nums["a"] = {"cli_wall_s": rep["wall_s"],
                     "mbase_per_s": total / 1e6 / rep["wall_s"],
                     "peak_rss_bytes": maxrss,
                     "peak_rss_before_cli_bytes":
                         rep["peak_rss_before_cli_bytes"],
                     "device_peak_bytes": rep["device_peak_bytes"],
                     "launches": rep["launches"],
                     "budget": budget,
                     "hashes": {os.path.basename(k): int(v.size)
                                for k, v in sets.items()}}

        # (b) the two genomes read whole
        big = os.path.join(root, "big.list")
        with open(big, "w") as f:
            f.write("\n".join(files[:2]) + "\n")
        sk_b = os.path.join(root, "whole.sketch")
        _reset_launches()
        with _env(KSSD_STREAM_THRESHOLD=str(max(sizes) + 1)):
            wall_b, err = run_cli(dev + ["sketch", "-i", big, "-o", sk_b,
                                         "-L", shuf_path, "-q"])
        (budget_b,) = _budgets(err)
        _launches_cover([budget_b], _launches(), on_card, "config 4 (b)")
        for name, h in _sets(sk_b).items():
            _require(np.array_equal(h, sets[name]),
                     f"{name} read whole != chunked")
        nums["b_whole_files_s"] = wall_b

        # (c) three contigs (contig0 lowercase) as genomes of their own
        records = list(itertools.islice(read_records(files[2]), 3))
        c_files = []
        for rec in records:
            c_files.append(os.path.join(root, f"{rec.name}.fna"))
            _write_record(c_files[-1], rec.name, rec.seq)
        _require(records[0].seq.islower(), "contig0 is not lowercase")
        c_list = os.path.join(root, "contigs3.list")
        with open(c_list, "w") as f:
            f.write("\n".join(c_files) + "\n")
        sk_c = os.path.join(root, "contigs3.sketch")
        run_cli(dev + ["sketch", "-i", c_list, "-o", sk_c, "-L", shuf_path,
                       "-q"])
        got_c = _sets(sk_c)
        for path, rec in zip(c_files, records):
            want = np.unique(oracle_hashes_numpy(rec.seq, params,
                                                 shuf.shuffled_dim))
            _require(np.array_equal(got_c[path], want),
                     f"{rec.name} != oracle")
            _require(np.isin(want, sets[files[2]]).all(),
                     f"{rec.name} not in the contigs file's set")

        # (d) the K-step hasher of the sharded sketch step, one rank
        block, cap = 1 << 17, 16_384
        halo = params.kmer_size - 1
        step = make_sharded_sketch_step(params, Mesh(1, 1), rows, block, cap)
        table = torch.from_numpy(shuf.shuffled_dim.astype(np.int32)).to(
            device)
        d = {"rows": rows, "block": block, "cap": cap, "host_s": 0.0,
             "step_s": 0.0, "bases": 0, "calls": 0}
        for path in (files[2], files[0]):
            t0 = time.perf_counter()
            codes = _encode_pieces([(r.seq, None)
                                    for r in read_records(path)])
            blocks, _ = pack_blocks(codes, block, params.kmer_size)
            d["bases"] += len(codes)
            del codes
            d["host_s"] += time.perf_counter() - t0
            found = []
            t0 = time.perf_counter()
            for lo in range(0, len(blocks), rows):
                chunk = blocks[lo: lo + rows]
                if len(chunk) < rows:
                    chunk = np.concatenate([chunk, np.full(
                        (rows - len(chunk), block + halo), -1, np.int8)])
                h_lo, h_hi, _, tot = step(chunk, table)
                n = int(tot[0])
                _require(n <= cap, f"(d) {n} survivors > cap {cap}")
                found.append(combine_hash_words(
                    h_lo[0, :n], h_hi[0, :n], np.ones(n, bool), True))
                d["calls"] += 1
            d["step_s"] += time.perf_counter() - t0
            del blocks
            _require(np.array_equal(np.unique(np.concatenate(found)),
                                    sets[path]),
                     f"(d) K-step hashes of {path} != (a)'s set")
        d["mbase_per_s"] = d["bases"] / 1e6 / d["step_s"]
        nums["d"] = d

        # (e) alldist on the use64 sketch, auto and device counting
        outs = {}
        for tag, extra in (("auto", {}), ("matmul", DEVICE_COUNTING)):
            outs[tag] = os.path.join(root, f"c4.{tag}.alldist")
            with _env(**extra):
                nums[f"e_alldist_{tag}_s"], _ = run_cli(
                    dev + ["alldist", "-i", sk, "-o", outs[tag], "-D",
                           "1.0"])
        rows_e = _sorted_rows(outs["auto"])
        _require(rows_e == _sorted_rows(outs["matmul"]),
                 "config 4 matmul alldist rows != auto rows")
        pair = [c for q, hits in _rows_by_query(outs["auto"]).items()
                for r, c, _ in hits if {q, r} == set(files[:2])]
        want = np.intersect1d(sets[files[0]], sets[files[1]]).size
        _require(pair == [want], f"genomes' common count {pair} != {want}")
        nums["e_rows"] = len(rows_e) - 1
        nums["e_genomes_common"] = want
    finally:
        shutil.rmtree(root, ignore_errors=True)
    nums["phase_s"] = time.perf_counter() - t_phase
    return nums


def entry_points(device) -> dict:
    """Phase 11: ``entry()`` twice and ``dryrun_multichip(4)``."""
    import torch

    from rabbitkssd_tpu_torch.entry import dryrun_multichip, entry

    fn, args = entry(device)
    _reset_launches()
    first, second = fn(*args), fn(*args)
    launches = _launches()
    _require(all(torch.equal(x, y) for x, y in zip(first, second)),
             "two entry() calls differ")
    _require(int(first[4]) > 0 and not bool(first[5]),
             f"entry(): count {int(first[4])}, overflow {bool(first[5])}")
    t0 = time.perf_counter()
    reports = dryrun_multichip(4, device)
    return {"entry": {"count": int(first[4]), "launches": launches},
            "dryrun": {"wall_s": time.perf_counter() - t0,
                       "ranks": reports}}


# --------------------------------------------------------------------------
# phase 12: the differential fuzzer, and BASELINE config 3
# --------------------------------------------------------------------------

def fuzz(device, work: str, trials: int = FUZZ_TRIALS, seed: int = FUZZ_SEED,
         timeout: float = 600) -> dict:
    """Phase 12 (a): ``scripts/torch_diff_fuzz.py --against cpu`` in a
    child process, the port on ``device`` against the port on the CPU;
    its JSON line, which must show no failure and, among the trials, a
    64-bit config, K = 32, FASTQ and a genome over several batches."""
    root = os.path.join(work, "fuzz")
    cmd = [sys.executable, os.path.join(HERE, "scripts", "torch_diff_fuzz.py"),
           "--against", "cpu", "--device", str(device), "--trials",
           str(trials), "--seed", str(seed), "--root", root]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (HERE, os.environ.get("PYTHONPATH")) if p))
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=HERE, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise RuntimeError(f"fuzzer: no end in {timeout} s") from None
    wall = time.perf_counter() - t0
    sys.stderr.write(err[-6000:])
    lines = out.strip().splitlines()
    _require(bool(lines), f"fuzzer exited {proc.returncode} with no result")
    rep = json.loads(lines[-1])
    _require(proc.returncode == 0 and not rep["failures"]
             and rep["passed"] == trials,
             f"fuzzer exited {proc.returncode}: {json.dumps(rep['failures'])}")
    cov = rep["coverage"]
    _require(all(cov[k] > 0 for k in ("use64", "k32", "fastq", "multi_batch")),
             f"fuzzer coverage {cov}: a 64-bit config, K = 32, FASTQ and a "
             "multi-batch genome each needed")
    _require(device.type != "cuda" or (rep["launches"]["stream_keep"] > 0
                                       and rep["launches"]["stream_compact"]
                                       > 0), "fuzzer: no stream kernel ran")
    _require(rep["jax_modules_loaded"] == 0, "the fuzzer loaded jax")
    rep["phase_s"] = wall
    return rep


def config3(device, work: str, ctx: dict) -> dict:
    """Phase 12 (b): BASELINE config 3 (scripts/config23_run.py's chain)
    through the port's CLI on ``device``: the phase-4 corpus split into
    A, the larger half, and B, sketched apart at L3K10; ``union -i A``,
    ``sub --rs A_u --qs B``, ``merge A B`` and ``alldist -D 0.05`` of the
    merged sketch (auto, then with device counting forced), each held to
    numpy set algebra over phase 4's sets and to phase 4's rows.  A is
    the larger half so that the merged sketch keeps phase 4's genome
    order (the largest first), which fixes each row's orientation."""
    from rabbitkssd_tpu_torch.host import read_sketches

    root = os.path.join(work, "config3")
    os.makedirs(root)
    files, sets = ctx["files"], ctx["sets"]
    half = len(files) // 2
    parts = {"A": files[half:], "B": files[:half]}  # files grow with g
    dev = ["--device", str(device)]
    walls, launches = {}, {}
    for name, part in parts.items():
        lst = os.path.join(root, f"{name}.list")
        with open(lst, "w") as f:
            f.write("\n".join(part) + "\n")
        _reset_launches()
        walls[f"sketch_{name}_s"], err = run_cli(
            dev + ["sketch", "-i", lst, "-o", os.path.join(root, name),
                   "-L", ctx["shuf_path"]])
        launches[name] = _launches()
        _launches_cover(_budgets(err), launches[name],
                        device.type == "cuda", f"config 3 sketch {name}")
        got = _sets(os.path.join(root, f"{name}.sketch"))
        _require(sorted(got) == sorted(part) and all(
            np.array_equal(h, sets[g]) for g, h in got.items()),
            f"config 3: {name}'s sets != phase 4")
    a_sk, b_sk = (os.path.join(root, f"{n}.sketch") for n in "AB")
    a_u, b_sub, merged = (os.path.join(root, n) for n in
                          ("A_u.sketch", "B_sub.sketch", "AB.sketch"))
    walls["union_s"], _ = run_cli(dev + ["union", "-i", a_sk, "-o", a_u])
    union = _sets(a_u)
    want_u = np.unique(np.concatenate([sets[g] for g in parts["A"]]))
    _require(len(union) == 1 and np.array_equal(
        next(iter(union.values())), want_u), "config 3: union != union1d")
    walls["sub_s"], _ = run_cli(dev + ["sub", "--rs", a_u, "--qs", b_sk,
                                       "-o", b_sub])
    subbed = _sets(b_sub)
    _require(sorted(subbed) == sorted(parts["B"]) and all(
        np.array_equal(h, np.setdiff1d(sets[g], want_u))
        for g, h in subbed.items()), "config 3: sub != setdiff1d")
    mlist = os.path.join(root, "merge.list")
    with open(mlist, "w") as f:
        f.write(f"{a_sk}\n{b_sk}\n")
    walls["merge_s"], _ = run_cli(dev + ["merge", "-i", mlist, "-o", merged])
    names = [s.name for s in read_sketches(merged).sketches]
    got = _sets(merged)
    _require(names == [s.name for s in read_sketches(a_sk).sketches]
             + [s.name for s in read_sketches(b_sk).sketches]
             and all(np.array_equal(h, sets[g]) for g, h in got.items()),
             "config 3: merge is not A then B with equal sets")
    rows = {}
    for tag, extra in (("auto", {}), ("matmul", DEVICE_COUNTING)):
        out = os.path.join(root, f"AB.{tag}.alldist")
        with _env(**extra):
            walls[f"alldist_{tag}_s"], _ = run_cli(
                dev + ["alldist", "-i", merged, "-o", out, "-D", MAX_DIST])
        rows[tag] = _sorted_rows(out)
        _require(rows[tag] == ctx["rows"],
                 f"config 3: merged alldist ({tag}) rows != phase 4's")
    return {"A": len(parts["A"]), "B": len(parts["B"]),
            "union_hashes": int(want_u.size),
            "sub_hashes": int(sum(h.size for h in subbed.values())),
            "rows": len(rows["auto"]) - 1, "launches": launches,
            "walls": walls}


def int_mm_rate(device, rows: int = 8192, width: int = 32768,
                reps: int = 10) -> dict:
    """int8 ops/s of torch._int_mm at a [rows, width] x [width, rows]
    alldist strip tile (0/1 memberships, as the counting path builds)."""
    import torch

    g = torch.Generator(device=device).manual_seed(SEED)
    m0 = torch.randint(0, 2, (rows, width), dtype=torch.int8, device=device,
                       generator=g)
    m1 = torch.randint(0, 2, (rows, width), dtype=torch.int8, device=device,
                       generator=g)
    for _ in range(2):
        torch._int_mm(m0, m1.t())
    ms = _events_ms(lambda: torch._int_mm(m0, m1.t()), reps)
    return {"shape": [rows, width, rows], "ms": ms,
            "ops_per_s": 2.0 * rows * rows * width / (ms / 1e3)}


# --------------------------------------------------------------------------

def main() -> None:
    import torch

    if not torch.cuda.is_available():
        _die("torch.cuda.is_available() is False: this smoke needs a card")
    if not all(os.path.isfile(os.path.join(HERE, "rabbitkssd_tpu_torch",
                                           "csrc", src))
               for src in SOURCES.values()):
        _die(f"run from a checkout of the repository ({HERE} lacks "
             "rabbitkssd_tpu_torch/csrc/*.cu)")
    sys.path.insert(0, HERE)
    import rabbitkssd_tpu_torch
    from rabbitkssd_tpu_torch.host import load_native
    from rabbitkssd_tpu_torch.ops._build import load_cuda_libs

    if not os.path.abspath(rabbitkssd_tpu_torch.__file__).startswith(HERE):
        _die(f"imported the port from {rabbitkssd_tpu_torch.__file__}, "
             f"not from {HERE}")
    device = rabbitkssd_tpu_torch.resolve_device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[1 card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {name} count {torch.cuda.device_count()}")
    print(smi)
    print(f"[1 card] native host library loaded: {load_native() is not None}")

    t0 = time.perf_counter()
    load_cuda_libs(list(SOURCES.values()))
    print(f"[2 build] {', '.join(SOURCES.values())} -> sm_90a (three nvcc "
          f"at once) in {time.perf_counter() - t0:.3f} s")

    mb = {}
    for cfg, (shape, seed) in MEMBER_CONFIGS.items():
        r = mb[cfg] = kernel_vs_plain(device, *shape, seed=seed)
        print(f"[3 kernel] member_bitmap, {cfg} kept set: {json.dumps(r)}")
        print(f"[3 kernel] member_bitmap {cfg} ({r['kept']} kept dims, "
              f"{r['n']} dims), device ms a launch ({smi}): kernel "
              f"{r['ms']:.5f}, plain {r['plain_ms']:.5f}, kept_lut[d] "
              f"{r['library_ms']:.5f}, bound {r['bound_ms']:.5f} "
              f"({r['bound_by']}), dims != 0 {r['same_bytes_ms']:.5f}; "
              f"call ms: kernel {r['call_ms']:.5f}")
    s3 = stream_kernels_vs_plain(device, 10, 6, 3, seed=3)
    print(f"[3 kernel] stream_keep + stream_compact, L3K10: {json.dumps(s3)}")
    s2 = stream_kernels_vs_plain(device, 8, 6, 2, seed=4)
    print(f"[3 kernel] stream_keep + stream_compact, L2K8: {json.dumps(s2)}")
    # K = 24 (a 36-bit hash) and K = 32 (the full 64-bit window)
    s12 = stream_kernels_vs_plain(device, 12, 6, 3, seed=5)
    print(f"[3 kernel] stream_keep + stream_compact, L3K12: "
          f"{json.dumps(s12)}")
    s32 = stream_kernels_vs_plain(device, 16, 4, 1, seed=6)
    print(f"[3 kernel] stream_keep + stream_compact, (16, 4, 1): "
          f"{json.dumps(s32)}")
    print("[3 kernel] equal to the plain versions bit for bit: keep words, "
          "and count, overflow and buffers[:count] in every case")
    print(f"[3 trace] {json.dumps(TRACE_PRIMER)}; traces that missed "
          f"timed device records (launch calls and those unrecorded, each "
          f"try; what was used): {json.dumps(TRACE_RETRIES)}")

    with tempfile.TemporaryDirectory(prefix="kssd_smoke_") as work:
        mp, ctx = main_path(device, work, N_GENOMES, GENOME_LEN)
        print(f"[4 main path] {json.dumps(mp)}")
        print("[5 correctness] oracle (3 genomes) and matmul-vs-auto "
              "alldist rows: equal")
        done = golden_checks(device, work)
        print(f"[5 correctness] goldens equal: {', '.join(done)}")
        ov = forced_overflow(device, ctx)
        print(f"[5 correctness] forced overflow, re-runs equal the main "
              f"path: {json.dumps(ov)}")
        for copies in (1, 8):
            print(f"[6 walk] {json.dumps(walk_rate(ctx, copies))}")
        prof = profile_sketch(device, ctx, work, mp["budget"])
        print(f"[7 profile] {json.dumps(prof)}")
        c2 = config2(device, work, ctx)
        print(f"[8 config 2] {json.dumps(c2)}")
        print("[8 config 2] launches cover both sketches, sets equal "
              "phase 4, matmul rows equal auto rows, top-N equals "
              "recounts and the smallest distances, goldens equal")
        lg = legacy(device, work, ctx, c2)
        print(f"[8 legacy] {json.dumps(lg)}")
        print("[8 legacy] card counts equal the walk's, card files equal "
              "the cpu files")
        p9a = ranks_cli(device, work, ctx)
        print(f"[9 ranks] (a) {json.dumps(p9a)}")
        p9b = ranks_mesh(device, work, ctx)
        print(f"[9 ranks] (b) {json.dumps(p9b)}")
        print(f"[9 ranks] (a) torchrun x {p9a['ranks']} on {p9a['device']} "
              f"({p9a['group']}, mesh {p9a['mesh']}): sets and rows (auto "
              "and KSSD_HOST_JOIN_MAX=0) equal phase 4, one writer; (b) 3 ranks "
              "on cuda:0 at Mesh(3, 1): ring counts equal the forced "
              "_int_mm counts, sets equal phase 4; every rank launched both "
              "stream kernels on every batch")
        c4 = config4(device, work)
        print(f"[10 config 4] {smi}: {json.dumps(c4)}")
        print(f"[10 config 4] (a) CLI sketch {c4['a']['cli_wall_s']:.3f} s = "
              f"{c4['a']['mbase_per_s']:.1f} Mbase/s, peak RSS "
              f"{c4['a']['peak_rss_bytes'] / 2**30:.2f} GiB; (d) K-step "
              f"sharded step {c4['d']['mbase_per_s']:.1f} Mbase/s; phase "
              f"{c4['phase_s']:.1f} s. The chunked sets equal the whole-file "
              "sets, three contigs equal the oracle, the K-step hashes equal "
              "(a)'s sets, matmul rows equal auto rows")
        ep = entry_points(device)
        print(f"[11 entry] entry() twice, equal: {json.dumps(ep['entry'])}")
        print(f"[11 dryrun] dryrun_multichip(4): {json.dumps(ep['dryrun'])}")
        fz = fuzz(device, work)
        print(f"[12 fuzz] (a) {json.dumps(fz)}")
        print(f"[12 fuzz] (a) {smi}: {fz['passed']} of {fz['trials']} trials "
              f"(seed {fz['seed']}), {fz['legs']} legs, cuda against cpu, "
              f"no failure; coverage {json.dumps(fz['coverage'])}; knobs "
              f"{', '.join(fz['knobs'])}; launches "
              f"{json.dumps(fz['launches'])}; fuzzer wall {fz['wall_s']:.1f} "
              f"s, phase {fz['phase_s']:.1f} s")
        c3 = config3(device, work, ctx)
        print(f"[12 config 3] (b) {smi}: {json.dumps(c3)}")
        print("[12 config 3] (b) A and B equal phase 4's sets, union equals "
              "union1d, sub equals setdiff1d, merge is A then B, the merged "
              "alldist rows (auto and device counting) equal phase 4's")

    rate = int_mm_rate(device)
    print(f"[6 int_mm] {json.dumps(rate)}")

    # times at the main path's shape and kept set (L3K10); member.cu is
    # off the main path (0 launches there) and keeps its phase-3 check
    timed = ("ms", "plain_ms", "bound_ms", "bound_by")
    mtimed = timed + ("library_ms", "call_ms")
    kernels = [{
        "name": "member_bitmap",
        "route": "cuda",
        "source": f"rabbitkssd_tpu_torch/csrc/{SOURCES['member_bitmap']}",
        "replaces": "rabbitkssd_tpu/ops/pallas_member.py:78",
        "launches": mp["launches"]["member_bitmap"],
        "max_abs_err": max(r["max_abs_err"] for r in mb.values()),
        **{k: mb["L3"][k] for k in mtimed},
        "by_config": {cfg: {k: r[k] for k in mtimed}
                      for cfg, r in mb.items() if cfg != "L3"},
    }]
    for kname, replaces in (
            ("stream_keep", "rabbitkssd_tpu/ops/pallas_member.py:78"),
            ("stream_compact", "rabbitkssd_tpu/engine/sketcher.py:218")):
        t = s3["times"][kname]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"rabbitkssd_tpu_torch/csrc/{SOURCES[kname]}",
            "replaces": replaces, "launches": mp["launches"][kname],
            "max_abs_err": max(s["max_abs_err"] for s in (s3, s2, s12, s32)),
            **{k: t[k] for k in timed}, "library_ms": None,
            # the same kernel at the other phase-3 (b) configurations
            "by_config": {cfg: {k: s["times"][kname][k] for k in timed}
                          for cfg, s in (("L2K8", s2), ("L3K12", s12),
                                         ("16,4,1", s32))}})
    _require(all(mp["launches"][k["name"]] > 0 for k in kernels[1:]),
             "a stream kernel never launched on the main path")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def member_main() -> None:
    """``--member``: phase 3 (a) alone, every kept set, as one JSON line
    with the card's name and power limit.  Run it from several checkouts
    in turns (A, B, B, A; an earlier one unpacked with ``git archive``
    into a git-ignored directory) to compare two versions of member.cu
    within one call."""
    import torch

    if not torch.cuda.is_available():
        _die("torch.cuda.is_available() is False: this mode needs a card")
    sys.path.insert(0, HERE)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    device = torch.device("cuda")
    out = {"root": HERE, "card": smi}
    for cfg, (shape, seed) in MEMBER_CONFIGS.items():
        out[cfg] = kernel_vs_plain(device, *shape, seed=seed)
    out["trace_retries"] = TRACE_RETRIES
    out["trace_primer"] = TRACE_PRIMER
    print(json.dumps(out))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        rank_main(*sys.argv[2:4])
    elif sys.argv[1:2] == ["--child"]:
        child_main(sys.argv[2])
    elif sys.argv[1:2] == ["--member"]:
        member_main()
    else:
        main()
