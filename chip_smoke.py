#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (rabbitkssd_tpu_torch).

    python3 chip_smoke.py        # from the repository root, one CUDA card

Phases, each printing its own lines:

1. card: name, and name + power limit from nvidia-smi;
2. build: the keep-test kernel (csrc/member.cu) with nvcc, timed;
3. kernel vs plain: the bitmap keep test against its plain PyTorch
   version on the card at the stream step's shape (16 x (2^17 + 32)
   dims plus edge values), for an L3 (4096 kept dims) and an L2 (65536
   kept dims) kept set: masks must be exactly equal; CUDA-event times
   taken in turns (plain, kernel, kernel, plain);
4. main path: a synthetic bacterial corpus (256 genomes x ~2 Mb, seed
   2024) through the CLI's ``sketch`` then ``alldist -D 0.05`` at L3K10
   on the card; prints walls, Mbase/s, the sketcher's budget and the
   kernel's launch count, which must cover every batch;
5. correctness: (a) three genomes' sketches equal the numpy oracle;
   (b) a device-counting alldist (KSSD_DIST_PATH=matmul,
   KSSD_HOST_JOIN_MAX=0) gives the same rows as the auto run; (c) the
   golden fa.list sketches and alldist rows of the reference binary;
   (d) with a per-batch cap of 64 survivors, every batch of three
   corpus genomes overflows on the card, and the exact re-run gives the
   main path's hash sets;
6. the walk/matmul cost model's two rates: ``torch._int_mm`` int8 ops/s
   at an alldist strip shape, and the native posting walk's
   increments/s counting the corpus sketch all-vs-all;
7. profile: the CLI sketch once more, warm, under ``torch.profiler``
   (``KSSD_PROFILE_DIR``), and the sketch trace's device busy share and
   device time by kernel (utils/trace_report.py).

Prints the kernels' JSON line, then as the last line
``{"ok": true, "device": {...}}``.  Catches nothing: any failure exits
non-zero.  Without a CUDA card, or outside the repository, it exits 1
before printing a result.  Imports only the port (``rabbitkssd_tpu_torch``;
its ``host`` module carries the host helpers shared with the JAX package).
"""

from __future__ import annotations

import contextlib
import glob
import io
import json
import os
import shutil
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


def kernel_vs_plain(device, half_k: int, half_subk: int, drlevel: int,
                    seed: int, reps: int = 50) -> dict:
    """Kernel vs plain keep test on one kept set; exact equality."""
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
    n_kept = int(((table >= 0) & (table < dim_end)).sum())
    if device.type != "cuda":
        return {"kept": n_kept, "max_abs_err": err}
    for _ in range(10):  # warm up both (and the clocks)
        member(dims, bitmap, dim_size)
        member_plain(dims, bitmap, dim_size)
    p1 = _events_ms(lambda: member_plain(dims, bitmap, dim_size), reps)
    k1 = _events_ms(lambda: member(dims, bitmap, dim_size), reps)
    k2 = _events_ms(lambda: member(dims, bitmap, dim_size), reps)
    p2 = _events_ms(lambda: member_plain(dims, bitmap, dim_size), reps)
    return {"kept": n_kept, "n": int(d.size), "max_abs_err": err,
            "ms": (k1 + k2) / 2, "plain_ms": (p1 + p2) / 2,
            "ms_turns": [p1, k1, k2, p2]}


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


def _budget(stderr: str) -> dict:
    """The sketcher's ``sketch budget:`` JSON line from the CLI stderr."""
    return json.loads(stderr.split("sketch budget: ", 1)[1].splitlines()[0])


def main_path(device, work: str, n_genomes: int, genome_len: int
              ) -> tuple[dict, dict]:
    """Phase 4 + 5a/5b: corpus -> CLI sketch -> CLI alldist, then the
    oracle and device-counting checks.  Returns (the numbers to print,
    the paths and sets later phases reuse)."""
    from rabbitkssd_tpu_torch.host import (KssdParams, generate_shuffle,
                                           oracle_hashes_numpy,
                                           read_records, write_shuffle_file)
    from rabbitkssd_tpu_torch.ops.member import member

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

    member.launches = 0
    sketch_s, err = run_cli(dev + ["sketch", "-i", list_path, "-o",
                                   sketch_path, "-L", shuf_path])
    alldist_s, _ = run_cli(dev + ["alldist", "-i", sketch_path, "-o",
                                  dist_path, "-D", MAX_DIST])
    launches = member.launches
    budget = _budget(err)
    # on the card every batch launches the kernel once (an overflow
    # re-run once more); a CPU rehearsal runs the plain version instead
    _require(launches == (budget["batches"] + budget["reruns"]
                          if device.type == "cuda" else 0),
             f"launches {launches} != batches {budget['batches']} + "
             f"reruns {budget['reruns']}")
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
    env = {"KSSD_DIST_PATH": "matmul", "KSSD_HOST_JOIN_MAX": "0"}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        matmul_s, _ = run_cli(dev + ["alldist", "-i", sketch_path, "-o",
                                     dist2, "-D", MAX_DIST])
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k)
            else:
                os.environ[k] = v
    rows = _sorted_rows(dist_path)
    _require(rows == _sorted_rows(dist2), "matmul alldist rows != auto rows")
    nums = {"genomes": len(files), "bases": total, "setup_s": setup_s,
            "sketch_s": sketch_s, "alldist_s": alldist_s,
            "alldist_matmul_s": matmul_s,
            "sketch_mbase_per_s": total / 1e6 / sketch_s,
            "rows": len(rows) - 1, "launches": launches, "budget": budget}
    ctx = {"files": files, "list": list_path, "shuf": shuf,
           "shuf_path": shuf_path, "sketch": sketch_path, "sets": got}
    return nums, ctx


def forced_overflow(device, ctx: dict) -> dict:
    """Phase 5d: the three largest corpus genomes with a per-batch cap
    of 64 survivors (an L3K10 batch holds ~500), so every flush window
    overflows and re-runs batch by batch at full capacity on the card;
    the hash sets must equal the main path's."""
    from rabbitkssd_tpu_torch.engine.sketcher import (DeviceSketcher,
                                                      StreamStep)
    from rabbitkssd_tpu_torch.host import KssdParams
    from rabbitkssd_tpu_torch.ops.member import member

    params = KssdParams(10, 6, 3)
    sk = DeviceSketcher(params, ctx["shuf"].shuffled_dim, device)
    sk.cap = 64
    sk.step = StreamStep(params, sk.cap, sk.buf_cap)
    files = ctx["files"][-3:]
    member.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(io.StringIO()):
        out = sk.sketch_files(files)
    wall = time.perf_counter() - t0
    b = sk.last_budget
    _require(b["batches"] > 0 and b["reruns"] == b["batches"],
             f"forced overflow: {b['reruns']} re-runs of {b['batches']} "
             "batches")
    _require(member.launches == (2 * b["batches"]
                                 if device.type == "cuda" else 0),
             f"forced overflow: {member.launches} launches for "
             f"{b['batches']} batches + {b['reruns']} re-runs")
    for s in out.sketches:
        _require(np.array_equal(s.hashes, ctx["sets"][s.name]),
                 f"forced-overflow sketch of {s.name} != main path")
    return {"genomes": len(files), "wall_s": wall, "budget": b}


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
    b = _budget(err)
    (trace,) = glob.glob(os.path.join(trace_dir, f"{stem}.*.json"))
    rep = summarize(trace, top=1 << 20)
    keep_ms = sum(t["ms"] for t in rep["top"]
                  if "member_bitmap_kernel" in t["name"])
    dev_ms = sum(t["ms"] for t in rep["top"])
    return {"trace": os.path.basename(trace), "cli_wall_s": wall,
            "pipeline_wall_s": b["wall"],
            "unprofiled_pipeline_wall_s": unprofiled["wall"],
            "span_ms": rep["span_ms"], "device_busy_ms": rep["device_busy_ms"],
            "busy_share": rep["busy_share"],
            "device_events": rep["device_events"], "batches": b["batches"],
            "device_busy_ms_per_batch": rep["device_busy_ms"] / b["batches"],
            "device_events_per_batch": rep["device_events"] / b["batches"],
            "keep_kernel_ms": keep_ms,
            "keep_share_of_device_ms": keep_ms / dev_ms if dev_ms else 0.0,
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
    finally:
        os.chdir(cwd)
    return done


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
    if not os.path.isfile(os.path.join(HERE, "rabbitkssd_tpu_torch",
                                       "csrc", "member.cu")):
        _die(f"run from a checkout of the repository ({HERE} has no "
             "rabbitkssd_tpu_torch/csrc/member.cu)")
    sys.path.insert(0, HERE)
    import rabbitkssd_tpu_torch
    from rabbitkssd_tpu_torch.host import load_native
    from rabbitkssd_tpu_torch.ops._build import load_cuda_lib

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
    load_cuda_lib("member.cu")
    print(f"[2 build] csrc/member.cu -> sm_90a in "
          f"{time.perf_counter() - t0:.3f} s")

    l3 = kernel_vs_plain(device, 10, 6, 3, seed=1)
    print(f"[3 kernel] L3 kept set: {json.dumps(l3)}")
    l2 = kernel_vs_plain(device, 8, 6, 2, seed=2)
    print(f"[3 kernel] L2 kept set: {json.dumps(l2)}")

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

    rate = int_mm_rate(device)
    print(f"[6 int_mm] {json.dumps(rate)}")

    kernels = [{
        "name": "member_bitmap",
        "route": "cuda",
        "source": "rabbitkssd_tpu_torch/csrc/member.cu",
        "replaces": "rabbitkssd_tpu/ops/pallas_member.py:78",
        "launches": mp["launches"],
        "max_abs_err": max(l3["max_abs_err"], l2["max_abs_err"]),
        "ms": l3["ms"],
        "plain_ms": l3["plain_ms"],
    }]
    _require(mp["launches"] > 0, "kernel never launched")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
