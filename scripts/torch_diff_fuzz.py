#!/usr/bin/env python
"""Randomized differential testing of the PyTorch/CUDA port.

Each trial draws a random valid sketch config and a random small corpus,
runs the port's CLI (``rabbitkssd_tpu_torch.cli.main``) on two sides
through the same legs, and asserts that every output agrees exactly.
Two referees:

  --against jax                the port on the CPU (``--device cpu``)
                               against the JAX package's CLI
                               (``rabbitkssd_tpu.cli.main``) under
                               JAX_PLATFORMS=cpu;
  --against cpu --device cuda  the port on the card against the same CLI
                               with ``--device cpu`` (every kernel's
                               plain version).  This mode imports neither
                               jax nor ``rabbitkssd_tpu``; ``--device
                               cuda`` without a card raises.

A trial:

1. draws (half_k, half_subk, drlevel): (s, l) from the space both
   implementations sketch (``scripts/diff_fuzz.py``'s ``SL``) and k from
   s + 1 to 16, so 64-bit hashes and K = 32 occur; k - l = 8 never (a
   32-bit index of 16^(k-l) u32 counts is 16 GiB there) and k - l = 7
   only under ``--slow`` (1 GiB).  The shuffle file is the port's own
   ``shuffle`` command (byte-equal to the JAX package's in jax mode);
2. draws a corpus: 3-7 genomes mutated from 1-3 ancestors, unique
   sizes, N runs, IUPAC letters and lowercase stretches; multi-record
   FASTA with varied line widths, or FASTQ reads at 2-3x coverage with
   low-quality stretches and random ``-Q``/``-n`` (a trial whose sketch
   holds no hash fails: its legs would compare nothing).
   A trial with a blocked-strip knob (below) takes 150-170 small genomes
   instead, so that ``KSSD_DIST_BLOCK=128`` makes two strips; in cpu
   mode a third of the trials add one genome of 3-6 Mbase, which spans
   several stream-step batches;
3. runs the legs on both sides, in a directory each (as its working
   directory, so that names written into files are equal), and compares:
   ``sketch`` (per-genome hash sets, then ``.sketch``/``.index``/``.dict``
   bytes), ``sketch -q``, ``alldist`` at a random ``-D`` and ``-M``
   (sorted rows), ``dist -r/-q`` with an optional ``-N`` (the sketches
   it makes, and sorted rows), ``union`` of the reference side, ``sub``
   of it from the query side and ``merge`` of both, ``convert --reverse``
   and back (with and without ``-q``), ``info -F``; at the end every
   file of the two directories (distance files by sorted rows, the rest
   by bytes).  Every second trial reruns one leg under a knob, the
   knobs in turn:
   KSSD_DIST_BLOCK=128 with KSSD_STRIP_MODE dense or sparse,
   KSSD_DIST_PATH=matmul with KSSD_HOST_JOIN_MAX=0 (``_int_mm`` on the
   card), KSSD_USE_INDEX=0 or 1, KSSD_LEGACY_DIST=1 (alldist and dist),
   or a small KSSD_STREAM_THRESHOLD (the sketch through the chunked
   reader, in the port in chunks of a few thousand bases); its output
   must also equal the leg's without the knob (the legacy format aside).
   In cpu mode one more leg sketches the corpus with a ``DeviceSketcher``
   whose per-batch cap is 64 survivors and whose flush window is 3
   batches (forced overflow and exact re-runs); its sets must equal the
   cpu side's;
4. counts the kernels' launches on the port sides: on a card every
   sketch launches ``stream_keep`` and ``stream_compact`` once a batch
   and once a re-run, and ``member_bitmap`` never; on the CPU nothing
   launches.  Anything else fails the trial.

A failing trial keeps its directory and prints its seed, trial and
config; a passing one deletes its directory.  Prints one JSON line at
the end (trials, configs, legs, launches, coverage, failures, wall, the
jax/``rabbitkssd_tpu`` modules loaded); exit 1 on any failure.

  python scripts/torch_diff_fuzz.py --against jax [--trials 25] [--seed 0]
  python scripts/torch_diff_fuzz.py --against cpu --device cuda --trials 16
  python scripts/torch_diff_fuzz.py --against cpu --device cpu --trials 1
  ... --seed S --only T        # rerun trial T of seed S alone
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

# the valid (s, l) space both sides accept for sketching
SL = [(4, 1), (5, 1), (5, 2), (6, 1), (6, 2), (6, 3)]
IUPAC = b"NRYSWKMBDHV"
MAX_D = (0.05, 0.2, 0.5, 1.0)
# the forced-overflow leg's per-batch cap and carry buffer (a flush
# window of buf_cap // cap - 1 = 3 batches)
OVERFLOW_CAP = 64
OVERFLOW_BUF = 4 * OVERFLOW_CAP
# the knobs a leg reruns under: (name, environment, leg)
KNOBS = [
    ("block128-dense", {"KSSD_DIST_BLOCK": "128",
                        "KSSD_STRIP_MODE": "dense"}, "alldist"),
    ("block128-sparse", {"KSSD_DIST_BLOCK": "128",
                         "KSSD_STRIP_MODE": "sparse"}, "alldist"),
    ("matmul", {"KSSD_DIST_PATH": "matmul", "KSSD_HOST_JOIN_MAX": "0"},
     "alldist+dist"),
    ("use-index-0", {"KSSD_USE_INDEX": "0"}, "alldist+dist"),
    ("use-index-1", {"KSSD_USE_INDEX": "1"}, "alldist+dist"),
    ("legacy", {"KSSD_LEGACY_DIST": "1"}, "alldist+dist"),
    ("stream-threshold", {"KSSD_STREAM_THRESHOLD": "1"}, "sketch"),
]


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


class Mismatch(AssertionError):
    """Two sides disagree, or a side broke a launch rule."""


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise Mismatch(msg)


@contextlib.contextmanager
def _env(kw: dict):
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


@contextlib.contextmanager
def _cwd(path: str):
    old = os.getcwd()
    os.chdir(path)
    try:
        yield
    finally:
        os.chdir(old)


# --------------------------------------------------------------------------
# the kernels' launch counters (the wrappers count their launches)
# --------------------------------------------------------------------------

def reset_launches() -> None:
    from rabbitkssd_tpu_torch.ops.member import member
    from rabbitkssd_tpu_torch.ops.stream import compact_append, keep_words

    member.launches = keep_words.launches = compact_append.launches = 0


def launches() -> dict:
    from rabbitkssd_tpu_torch.ops.member import member
    from rabbitkssd_tpu_torch.ops.stream import compact_append, keep_words

    return {"member_bitmap": member.launches,
            "stream_keep": keep_words.launches,
            "stream_compact": compact_append.launches}


def budgets(stderr: str) -> list[dict]:
    """The port sketcher's ``sketch budget:`` JSON lines, one a list."""
    return [json.loads(part.splitlines()[0])
            for part in stderr.split("sketch budget: ")[1:]]


def check_launches(got: dict, bud: list[dict], on_card: bool,
                   what: str) -> None:
    """On a card each stream kernel launches once a batch and once a
    re-run, member.cu never; on the CPU nothing launches."""
    runs = sum(b["batches"] + b["reruns"] for b in bud)
    want = runs if on_card else 0
    _require(got["stream_keep"] == want and got["stream_compact"] == want
             and got["member_bitmap"] == 0
             and all(b["batches"] > 0 for b in bud),
             f"{what}: launches {got} for {runs} batches + re-runs")


# --------------------------------------------------------------------------
# sides
# --------------------------------------------------------------------------

class Side:
    """One CLI in its own working directory.  ``device`` is None for the
    JAX CLI, else the port's torch device."""

    def __init__(self, name: str, root: str, device=None):
        self.name, self.device = name, device
        self.dir = os.path.join(root, name)
        os.makedirs(self.dir)
        if device is None:
            from rabbitkssd_tpu.cli import main
            self.main, self.argv0 = main, []
        else:
            from rabbitkssd_tpu_torch.cli import main
            self.main, self.argv0 = main, ["--device", str(device)]
        self.launches = {"member_bitmap": 0, "stream_keep": 0,
                         "stream_compact": 0}
        self.batches = []  # each port sketch's batches

    @property
    def on_card(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def path(self, name: str) -> str:
        return os.path.join(self.dir, name)

    def run(self, argv: list[str], env: dict | None = None) -> str:
        """One CLI command in this side's directory; returns its stderr.
        A port side's launches must match its sketches' batches."""
        out, err = io.StringIO(), io.StringIO()
        if self.device is not None:
            reset_launches()
        with _env(env or {}), _cwd(self.dir), \
                contextlib.redirect_stdout(out), \
                contextlib.redirect_stderr(err):
            rc = self.main(self.argv0 + argv)
        text = err.getvalue()
        _require(rc == 0, f"{self.name} {argv[0]} exited {rc}: "
                 f"{text[-1500:]}")
        if self.device is not None:
            got, bud = launches(), budgets(text)
            check_launches(got, bud, self.on_card,
                           f"{self.name} {' '.join(argv[:1])}")
            for k, v in got.items():
                self.launches[k] += v
            self.batches += [b["batches"] for b in bud]
        return text


# --------------------------------------------------------------------------
# comparisons
# --------------------------------------------------------------------------

def _read(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def _sorted_rows(path: str) -> list[bytes]:
    lines = _read(path).split(b"\n")
    return lines[:1] + sorted(lines[1:])


def sketch_sets(path: str) -> dict:
    from rabbitkssd_tpu_torch.formats import read_sketches

    sk = read_sketches(path)
    return {"id": sk.info.id,
            "sets": [(s.name, np.sort(s.hashes).tolist())
                     for s in sk.sketches]}


def same_sketch(a: Side, b: Side, name: str, what: str,
                index: bool = True) -> None:
    """Per-genome hash sets, and its index files on both sides or on
    neither (their bytes: :func:`same_trees`)."""
    pa, pb = a.path(name), b.path(name)
    _require(sketch_sets(pa) == sketch_sets(pb),
             f"{what}: {name} hash sets differ ({a.name} vs {b.name})")
    for ext in (".index", ".dict"):
        ea, eb = os.path.exists(pa + ext), os.path.exists(pb + ext)
        _require(ea == eb == index, f"{what}: {name}{ext} exists on "
                 f"{a.name}: {ea}, {b.name}: {eb}")


def same_rows(a: Side, b: Side, name: str, what: str) -> None:
    rows = _sorted_rows(a.path(name))
    _require(rows == _sorted_rows(b.path(name)),
             f"{what}: {name} rows differ ({a.name} vs {b.name})")


def same_trees(a: Side, b: Side) -> int:
    """Every file of the two directories: distance files by sorted rows,
    the rest by bytes.  Returns the number of files."""
    def files(root):
        out = []
        for d, _, names in os.walk(root):
            out += [os.path.relpath(os.path.join(d, n), root) for n in names]
        return sorted(out)

    fa, fb = files(a.dir), files(b.dir)
    _require(fa == fb, f"files differ: {sorted(set(fa) ^ set(fb))}")
    for rel in fa:
        pa, pb = a.path(rel), b.path(rel)
        if rel.endswith((".alldist", ".dist")):
            _require(_sorted_rows(pa) == _sorted_rows(pb),
                     f"{rel}: rows differ")
        else:
            _require(_read(pa) == _read(pb), f"{rel}: bytes differ")
    return len(fa)


# --------------------------------------------------------------------------
# draws
# --------------------------------------------------------------------------

def draw_config(rng, slow: bool = False) -> tuple[int, int, int]:
    """(half_k, half_subk, drlevel): k - l in 3..6 or 9..15 (7 under
    ``slow``), the 32-bit index at most 1 GiB."""
    while True:
        s, l = SL[int(rng.integers(0, len(SL)))]
        k = int(rng.integers(s + 1, 17))
        if 3 <= k - l <= 6 or 9 <= k - l <= 15 or (slow and k - l == 7):
            return k, s, l


def _write_fasta(path: str, name: str, seq: np.ndarray, rng) -> None:
    """Multi-record FASTA: 1-3 records, a random line width a file."""
    cuts = np.sort(rng.integers(1, len(seq), size=int(rng.integers(0, 3))))
    width = int(rng.choice([50, 60, 61, 80, 100, 1000]))
    with open(path, "wb") as f:
        for r, part in enumerate(np.split(seq, cuts)):
            f.write(b">%s_r%d fuzz\n" % (name.encode(), r))
            for pos in range(0, len(part), width):
                f.write(part[pos: pos + width].tobytes() + b"\n")


def _write_fastq(path: str, name: str, seq: np.ndarray, rng,
                 coverage: int) -> None:
    """Reads of 200-1200 bases tiling the genome ``coverage`` times from
    random offsets (so ``-n 2`` keeps k-mers), high qualities with 0-2
    low-quality stretches a read (so ``-Q`` cuts some windows)."""
    with open(path, "wb") as f:
        r = 0
        for _ in range(coverage):
            pos = -int(rng.integers(0, 600))
            while pos < len(seq):
                lo, pos = pos, pos + int(rng.integers(200, 1200))
                if pos <= 0:  # the first read starts before the genome
                    continue
                read = seq[max(lo, 0): pos]
                qual = rng.integers(53, 74, size=read.size).astype(np.uint8)
                for _ in range(int(rng.integers(0, 3))):
                    st = int(rng.integers(0, read.size))
                    qual[st: st + int(rng.integers(5, 40))] = rng.integers(
                        33, 45)
                f.write(b"@%s_r%d\n" % (name.encode(), r) + read.tobytes()
                        + b"\n+\n" + qual.tobytes() + b"\n")
                r += 1


def make_corpus(rng, root: str, fastq: bool, many: bool, big: bool,
                drlevel: int) -> tuple[list[str], int]:
    """Genome files under ``root``: 3-7 (``many``: 150-170 small ones)
    genomes mutated from 1-3 ancestors at 0.1-20 %, unique sizes (4x
    longer at drlevel 3, which keeps 1 window in 4096), with N runs,
    IUPAC letters and lowercase stretches; FASTQ at 2-3x coverage.
    ``big`` adds one genome of 3-6 Mbase (FASTQ at 1x).  Returns (files,
    bases)."""
    os.makedirs(root)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    scale = 4 if drlevel >= 3 else 1
    if many:
        n = int(rng.integers(150, 171))
        lens = [scale * (1500 + 13 * g) + int(rng.integers(0, 13))
                for g in range(n)]
    else:
        n = int(rng.integers(3, 8))
        lens = [scale * (4000 + 700 * g) + int(rng.integers(0, 500))
                for g in range(n)]
    ancestors = [rng.integers(0, 4, size=max(lens), dtype=np.int8)
                 for _ in range(int(rng.integers(1, 4)))]
    files, total = [], 0
    for g, glen in enumerate(lens):
        codes = ancestors[g % len(ancestors)][:glen].copy()
        pos = rng.integers(0, glen, size=int(glen * 10 ** rng.uniform(-3,
                                                                       -0.7)))
        codes[pos] = (codes[pos] + rng.integers(1, 4, size=pos.size)) % 4
        seq = acgt[codes]
        for _ in range(int(rng.integers(0, 4))):
            st = int(rng.integers(0, glen - 30))
            seq[st: st + int(rng.integers(1, 25))] = IUPAC[
                int(rng.integers(0, len(IUPAC)))]
        for _ in range(int(rng.integers(0, 3))):
            st = int(rng.integers(0, glen - 60))
            seq[st: st + int(rng.integers(5, 50))] |= 0x20
        path = os.path.join(root, f"g{g}.{'fq' if fastq else 'fna'}")
        if fastq:
            _write_fastq(path, f"g{g}", seq, rng, int(rng.integers(2, 4)))
        else:
            _write_fasta(path, f"g{g}", seq, rng)
        files.append(path)
        total += glen
    if big:
        glen = int(rng.integers(3_000_000, 6_000_001))
        seq = acgt[rng.integers(0, 4, size=glen, dtype=np.int8)]
        for _ in range(8):
            st = int(rng.integers(0, glen - 200))
            seq[st: st + int(rng.integers(1, 120))] = ord("N")
        st = int(rng.integers(0, glen - 10_000))
        seq[st: st + 10_000] |= 0x20
        path = os.path.join(root, f"big.{'fq' if fastq else 'fna'}")
        if fastq:
            _write_fastq(path, "big", seq, rng, 1)
        else:
            with open(path, "wb") as f:
                f.write(b">big fuzz\n")
                full = glen - glen % 100
                rows = seq[:full].reshape(-1, 100)
                nl = np.full((rows.shape[0], 1), ord("\n"), np.uint8)
                f.write(np.hstack([rows, nl]).tobytes())
                f.write(seq[full:].tobytes() + b"\n")
        files.append(path)
        total += glen
    return files, total


def _write_list(side: Side, name: str, files: list[str]) -> None:
    with open(side.path(name), "w") as f:
        f.write("\n".join(files) + "\n")


# --------------------------------------------------------------------------
# one trial
# --------------------------------------------------------------------------

def trial_rng(seed: int, t: int):
    return np.random.default_rng(seed * 100003 + t)


@contextlib.contextmanager
def _chunked_port_reader(chunk: int):
    """Make the port's chunked reader cut files into ``chunk`` bases, and
    parse them in byte ranges of ``chunk + 1`` bytes, so that a file
    spans many ranges."""
    from rabbitkssd_tpu_torch import native

    whole = native.fasta_packed_chunks
    native.fasta_packed_chunks = (
        lambda path, least_qual=0, threads=1: native.PackedChunks(
            path, least_qual, chunk, threads, range_bytes=chunk + 1))
    try:
        yield
    finally:
        native.fasta_packed_chunks = whole


def draw_trial(seed: int, t: int, against: str, slow: bool = False):
    """Trial ``t``'s draws (the same in both modes, but that only cpu mode
    adds the big genome) and the generator that then draws its corpus.
    Odd trials take the knobs in turn."""
    rng = trial_rng(seed, t)
    k, s, l = draw_config(rng, slow)
    fastq = bool(rng.integers(0, 2))
    qflags = []
    if fastq:
        if rng.integers(0, 2):
            qflags += ["-Q", str(int(rng.integers(33, 50)))]
        if rng.integers(0, 2):
            qflags += ["-n", str(int(rng.integers(1, 3)))]
    big = bool(rng.random() < 1 / 3)
    nflags = [] if rng.integers(0, 2) else ["-N", str(int(rng.integers(1,
                                                                     4)))]
    knob = KNOBS[(seed + t // 2) % len(KNOBS)] if t % 2 == 1 else None
    cfg = {"k": k, "s": s, "l": l, "K": 2 * k, "use64": 4 * (k - l) > 32,
           "fastq": fastq, "qflags": qflags, "big": big and against == "cpu",
           "D": str(float(rng.choice(MAX_D))),
           "M": str(int(rng.integers(0, 2))), "nflags": nflags,
           "chunk": 16 * int(rng.integers(64, 1024)),
           "knob": knob[0] if knob else None}
    return cfg, knob, rng


def run_trial(seed: int, t: int, against: str, device: str, root: str,
              slow: bool = False) -> dict:
    """Trial ``t`` of ``seed`` under ``root/t<t>``; returns its record
    (config, legs, launches).  Raises :class:`Mismatch` (or the error a
    side raised) on a fault; the caller keeps or deletes the directory."""
    import torch

    from rabbitkssd_tpu_torch import resolve_device
    from rabbitkssd_tpu_torch.params import KssdParams

    t0 = time.perf_counter()
    cfg, knob, rng = draw_trial(seed, t, against, slow)
    k, s, l = cfg["k"], cfg["s"], cfg["l"]
    params = KssdParams(k, s, l)
    fastq, big, qflags = cfg["fastq"], cfg["big"], cfg["qflags"]
    max_d, metric, nflags = cfg["D"], cfg["M"], cfg["nflags"]
    many = knob is not None and knob[0].startswith("block")
    d = os.path.join(root, f"t{t}")
    files, bases = make_corpus(rng, os.path.join(d, "genomes"), fastq,
                               many, big, l)
    cfg.update(genomes=len(files), bases=bases)
    tag = (f"L{l}K{k}S{s} K={2 * k} {'64' if params.use64 else '32'}-bit "
           f"{' '.join(['fq'] + qflags) if fastq else 'fa'} "
           f"{len(files)} genomes{' +big' if big else ''}")

    dev = resolve_device(device)
    if against == "jax":
        os.environ.setdefault("JAX_PLATFORMS", "cpu")
        a, b = Side("port", d, dev), Side("jax", d, None)
    else:
        a, b = Side(str(dev.type), d, dev), Side("cpu-ref", d,
                                                 torch.device("cpu"))
    sides = (a, b)
    legs = []

    # 1. the shuffle file: the port's own command
    shuf = os.path.join(d, f"L{l}K{k}S{s}.shuf")
    a.run(["shuffle", "-k", str(k), "-s", str(s), "-l", str(l), "-o", shuf])
    if against == "jax":
        from rabbitkssd_tpu.shuffle import generate_shuffle, \
            write_shuffle_file

        write_shuffle_file(generate_shuffle(k, s, l), shuf + ".jax")
        _require(_read(shuf) == _read(shuf + ".jax"),
                 "shuffle file differs from the JAX package's")
        os.remove(shuf + ".jax")
    legs.append("shuffle")

    cut = len(files) // 2
    for side in sides:
        _write_list(side, "corpus.list", files)
        _write_list(side, "r.list", files[:cut])
        _write_list(side, "q.list", files[cut:])

    # 2. sketch, and a query sketch (no index)
    for side in sides:
        side.run(["sketch", "-L", shuf, "-i", "corpus.list", "-o",
                  "x.sketch"] + qflags)
    same_sketch(a, b, "x.sketch", "sketch")
    sketch_batches = a.batches[-1] if a.batches else 0
    cfg["hashes"] = sum(len(h) for _, h in
                        sketch_sets(a.path("x.sketch"))["sets"])
    # an empty sketch would make every later leg vacuous
    _require(cfg["hashes"] > 0, "the corpus left no hash in any genome")
    legs.append("sketch")
    for side in sides:
        side.run(["sketch", "-q", "-L", shuf, "-i", "corpus.list", "-o",
                  "xq.sketch"] + qflags)
    same_sketch(a, b, "xq.sketch", "sketch -q", index=False)
    legs.append("sketch -q")

    # 3. alldist and dist
    def alldist(out, env=None):
        for side in sides:
            side.run(["alldist", "-i", "x.sketch", "-o", out, "-D", max_d,
                      "-M", metric], env)
        same_rows(a, b, out, f"alldist D={max_d} M={metric}")

    def dist(out, env=None):
        for side in sides:
            side.run(["dist", "-r", "r.list", "-q", "q.list", "-L", shuf,
                      "-o", out, "-D", max_d, "-M", metric] + nflags
                     + qflags, env)
        same_rows(a, b, out, f"dist D={max_d} M={metric} {nflags}")

    alldist("x.alldist")
    legs.append(f"alldist D={max_d} M={metric}")
    dist("x.dist")
    same_sketch(a, b, "r.list.sketch", "dist reference sketch")
    same_sketch(a, b, "q.list.sketch", "dist query sketch", index=False)
    legs.append(f"dist D={max_d} M={metric}{' N=' + nflags[1] if nflags else ''}")

    # 4. set algebra: union of the reference side, the query side minus
    # it, both merged
    for side in sides:
        side.run(["union", "-i", "r.list.sketch", "-o", "ru.sketch"])
        side.run(["sub", "--rs", "ru.sketch", "--qs", "q.list.sketch",
                  "-o", "qs.sketch"])
        _write_list(side, "merge.list", ["r.list.sketch", "q.list.sketch"])
        side.run(["merge", "-i", "merge.list", "-o", "m.sketch"])
    for name in ("ru.sketch", "qs.sketch", "m.sketch"):
        same_sketch(a, b, name, "union/sub/merge", index=False)
    legs.append("union+sub+merge")

    # 5. convert both ways, info -F
    for side in sides:
        side.run(["convert", "-i", "x.sketch", "-o", "kdir", "--reverse"])
        side.run(["convert", "-i", "kdir", "-o", "xc.sketch"])
        side.run(["convert", "-i", "kdir", "-o", "xcq.sketch", "-q"])
        side.run(["info", "-i", "x.sketch", "-o", "x.info", "-F"])
    same_sketch(a, b, "xc.sketch", "convert")
    same_sketch(a, b, "xcq.sketch", "convert -q", index=False)
    legs += ["convert x2", "info -F"]  # info's bytes: same_trees

    # 6. a knob
    if knob is not None:
        name, env, leg = knob
        if leg == "sketch":
            with _chunked_port_reader(cfg["chunk"]):
                for side in sides:
                    side.run(["sketch", "-L", shuf, "-i", "corpus.list",
                              "-o", "xt.sketch"] + qflags, env)
            same_sketch(a, b, "xt.sketch", f"sketch under {name}")
            for side in sides:
                for ext in ("", ".index", ".dict"):
                    _require(_read(side.path("xt.sketch" + ext))
                             == _read(side.path("x.sketch" + ext)),
                             f"{side.name}: sketch{ext} under {name} "
                             "differs from the sketch")
        else:
            alldist(f"{name}.alldist", env)
            if "dist" in leg.split("+"):
                dist(f"{name}.dist", env)
            if name != "legacy":  # the legacy paths write their own format
                for side in sides:
                    for out, ref in ((f"{name}.alldist", "x.alldist"),
                                     (f"{name}.dist", "x.dist")):
                        if os.path.exists(side.path(out)):
                            _require(_sorted_rows(side.path(out))
                                     == _sorted_rows(side.path(ref)),
                                     f"{side.name}: {out} under {name} "
                                     f"differs from {ref}")
        legs.append(f"knob {name}")

    # 7. forced overflow on the device side (cpu mode)
    overflow = None
    if against == "cpu":
        overflow = forced_overflow(a, params, shuf, files, qflags,
                                   b.path("x.sketch"))
        legs.append("forced overflow")

    n_files = same_trees(a, b)
    cfg["multi_batch"] = big and sketch_batches >= 2
    return {"trial": t, "seed": seed, "config": cfg, "tag": tag,
            "legs": legs, "files_compared": n_files,
            "sketch_batches": sketch_batches, "overflow": overflow,
            "launches": {s.name: s.launches for s in sides
                         if s.device is not None},
            "wall_s": time.perf_counter() - t0}


def forced_overflow(side: Side, params, shuf: str, files: list[str],
                    qflags: list[str], want_path: str) -> dict:
    """The corpus through a ``DeviceSketcher`` on ``side``'s device with a
    per-batch cap of 64 survivors and a flush window of 3 batches: windows
    overflow and re-run exactly; the sets must equal ``want_path``'s."""
    from rabbitkssd_tpu_torch.engine.sketcher import (DeviceSketcher,
                                                      StreamStep)
    from rabbitkssd_tpu_torch.shuffle import read_shuffle_file

    qual = int(qflags[qflags.index("-Q") + 1]) if "-Q" in qflags else 0
    least = int(qflags[qflags.index("-n") + 1]) if "-n" in qflags else 1
    sk = DeviceSketcher(params, read_shuffle_file(shuf).shuffled_dim,
                        side.device, least_qual=qual, least_num_kmer=least)
    sk.cap, sk.buf_cap = OVERFLOW_CAP, OVERFLOW_BUF
    sk.step = StreamStep(params, sk.cap, sk.buf_cap)
    reset_launches()
    with contextlib.redirect_stderr(io.StringIO()):
        out = sk.sketch_files(files)
    b = sk.last_budget
    got = launches()
    check_launches(got, [b], side.on_card, f"{side.name} forced overflow")
    for k, v in got.items():
        side.launches[k] += v
    want = {name: h for name, h in sketch_sets(want_path)["sets"]}
    _require({s.name: np.sort(s.hashes).tolist() for s in out.sketches}
             == want, "forced-overflow sets differ from the cpu side's")
    # more distinct hashes than the batches could hold: some re-ran
    held = sum(len(h) for h in want.values())
    _require(b["reruns"] > 0 or held <= OVERFLOW_CAP * b["batches"],
             f"forced overflow: {held} hashes in {b['batches']} batches "
             "of cap 64 and no re-run")
    return {"batches": b["batches"], "reruns": b["reruns"]}


# --------------------------------------------------------------------------

def _loaded_jax_modules() -> list[str]:
    return sorted(m for m in sys.modules
                  if m in ("jax", "rabbitkssd_tpu")
                  or m.startswith(("jax.", "rabbitkssd_tpu.")))


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", choices=("jax", "cpu"), required=True)
    ap.add_argument("--device", default=None,
                    help="the port's device: cpu (jax mode, the default "
                         "there) or cuda (cpu mode's default)")
    ap.add_argument("--trials", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", type=int, default=None,
                    help="run trial ONLY of --seed alone")
    ap.add_argument("--slow", action="store_true",
                    help="also draw k - l = 7 (a 1 GiB 32-bit index)")
    ap.add_argument("--root", default=None,
                    help="trial directories (default: a new temporary one)")
    args = ap.parse_args(argv)
    device = args.device or ("cpu" if args.against == "jax" else "cuda")
    if args.against == "jax" and device != "cpu":
        ap.error("--against jax runs the port on the cpu device")
    from rabbitkssd_tpu_torch import resolve_device

    resolve_device(device)  # a cuda request without a card raises here

    root = args.root or tempfile.mkdtemp(prefix="kssd_torch_fuzz_")
    os.makedirs(root, exist_ok=True)
    trials = ([args.only] if args.only is not None
              else list(range(args.trials)))
    t0 = time.perf_counter()
    records, failures = [], []
    for t in trials:
        try:
            rec = run_trial(args.seed, t, args.against, device, root,
                            args.slow)
        except Exception as e:  # a fault of either side: keep the trial
            cfg = draw_trial(args.seed, t, args.against, args.slow)[0]
            failures.append({
                "trial": t, "seed": args.seed, "config": cfg,
                "err": f"{type(e).__name__}: {e}"[-2000:],
                "dir": os.path.join(root, f"t{t}"),
                "repro": f"python scripts/torch_diff_fuzz.py --against "
                         f"{args.against} --device {device} --seed "
                         f"{args.seed} --only {t}"})
            log(f"trial {t} (seed {args.seed}, {json.dumps(cfg)}): FAIL {e}")
            if not isinstance(e, Mismatch):
                log(traceback.format_exc()[-3000:])
            continue
        records.append(rec)
        shutil.rmtree(os.path.join(root, f"t{t}"), ignore_errors=True)
        log(f"trial {t}: OK {rec['tag']}, {rec['config']['hashes']} hashes "
            f"({rec['wall_s']:.1f} s): "
            f"{'; '.join(rec['legs'])}")
    if not failures and args.root is None:
        shutil.rmtree(root, ignore_errors=True)
    totals: dict = {}
    for rec in records:
        for side in rec["launches"].values():
            for k, v in side.items():
                totals[k] = totals.get(k, 0) + v
    cfgs = [r["config"] for r in records]
    print(json.dumps({
        "against": args.against, "device": device, "seed": args.seed,
        "trials": len(trials), "passed": len(records),
        "legs": sum(len(r["legs"]) for r in records),
        "configs": [r["tag"] for r in records],
        "trial_legs": [r["legs"] for r in records],
        "trial_hashes": [r["config"]["hashes"] for r in records],
        "knobs": sorted({c["knob"] for c in cfgs if c["knob"]}),
        "coverage": {"use64": sum(c["use64"] for c in cfgs),
                     "k32": sum(c["K"] == 32 for c in cfgs),
                     "fastq": sum(c["fastq"] for c in cfgs),
                     "multi_batch": sum(c["multi_batch"] for c in cfgs)},
        "launches": totals,
        "trial_walls_s": [round(r["wall_s"], 3) for r in records],
        "failures": failures,
        "wall_s": round(time.perf_counter() - t0, 3),
        # how many jax and rabbitkssd_tpu modules this process loaded
        "jax_modules_loaded": len(_loaded_jax_modules()),
    }))
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
