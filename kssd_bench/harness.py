"""Run one cell of the benchmark once (see ``kssd_bench/__init__.py``).

Set-up: make the cell's inputs from the seed (``traffic/<kind>.py``),
the shuffle file (the reference's, cached in ``cache/``), and run the
cell's command once to warm up.  Window: run the command back to back,
each in this process through ``rabbitkssd_tpu_torch.cli.main``, until
``--seconds`` have passed; the last command ends the window.  A cell
on ``chips`` C > 1 runs every command on C ranks, one a card: this
process rank 0 and C - 1 worker processes (``ranks.py``).  With
``--trace 1`` a ``torch.profiler`` trace covers the window.  Then the
outputs of every timed command go to the cell's check, the metrics that
``BENCHMARK.json`` gives the cell are read (``metrics/<name>.py``), and
one JSON line ends standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import dataclasses
import gc
import importlib.util
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import types

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(HERE, "cache")
# top-level module names that no run may load
FORBIDDEN = {"jax", "jaxlib", "flax", "rabbitkssd_tpu"}
PHASE = re.compile(r"^=+time of (.*) is: ([0-9.eE+-]+)\s*$")
BUDGET = "sketch budget: "


# --------------------------------------------------------------------------
# what lives under this directory, found by name
# --------------------------------------------------------------------------

def names(kind: str, ext: str) -> list[str]:
    d = os.path.join(HERE, kind)
    return sorted(f[: -len(ext)] for f in os.listdir(d)
                  if f.endswith(ext) and not f.startswith("_"))


def load_json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, f"{name}.json")) as f:
        return json.load(f)


def load_module(kind: str, name: str) -> types.ModuleType:
    """``kind/name.py``; a name may hold dots (metric names do)."""
    path = os.path.join(HERE, kind, f"{name}.py")
    mod_name = f"kssd_bench.{kind}.{name.replace('.', '__')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics, or with ``trace`` its per-layer
    ones: those that list it, or that list no cell and move one of its
    end-to-end metrics."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]


def forbidden_loaded() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


# --------------------------------------------------------------------------
# one command
# --------------------------------------------------------------------------

class Tap(io.TextIOBase):
    """A text stream that keeps each line with the time it was ended."""

    def __init__(self):
        self.lines: list[tuple[float, str]] = []
        self._buf = ""
        self._lock = threading.Lock()

    def writable(self) -> bool:
        return True

    def write(self, s: str) -> int:
        with self._lock:
            self._buf += s
            while "\n" in self._buf:
                line, self._buf = self._buf.split("\n", 1)
                self.lines.append((time.perf_counter(), line))
        return len(s)


@dataclasses.dataclass
class Pass:
    """One command: its host span, what it printed, how it ended."""

    out: str
    t0: float
    t1: float
    lines: list[tuple[float, str]]
    error: str | None
    wall0: float = 0.0  # time.time() at t0

    def wall(self, t: float) -> float:
        """A ``perf_counter`` time of this command as wall-clock time."""
        return self.wall0 + (t - self.t0)

    @property
    def span_s(self) -> float:
        return self.t1 - self.t0

    @property
    def budget(self) -> dict | None:
        for _, ln in self.lines:
            if ln.startswith(BUDGET):
                return json.loads(ln[len(BUDGET):])
        return None

    @property
    def phases(self) -> list[tuple[str, float, float]]:
        """The program's spans: (name, seconds, host time it ended)."""
        out = []
        for t, ln in self.lines:
            m = PHASE.match(ln)
            if m:
                out.append((m.group(1), float(m.group(2)), t))
        return out



def run_command(cli, argv: list[str], out: str, device) -> Pass:
    """Run one command."""
    import torch

    tap = Tap()
    error = None
    wall0, t0 = time.time(), time.perf_counter()
    with contextlib.redirect_stderr(tap), contextlib.redirect_stdout(tap):
        try:
            rc = cli.main(argv)
            if rc:
                error = f"exit code {rc}"
        except Exception:  # a failed command is counted, not fatal
            error = traceback.format_exc()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    return Pass(out, t0, time.perf_counter(), tap.lines, error, wall0)


def fill(argv: list[str], values: dict) -> list[str]:
    return [a.format(**values) for a in argv]


# --------------------------------------------------------------------------
# a run
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Record:
    """What a metric reader reads."""

    config: dict
    work: dict
    passes: list[Pass]
    setup_s: float
    trace: object | None  # trace.TraceSummary
    extras: dict

    @property
    def window_s(self) -> float:
        return self.passes[-1].t1 - self.passes[0].t0

    def total(self, key: str) -> float:
        """Sum over the window of one ``sketch budget`` field."""
        return sum(p.budget[key] for p in self.passes if p.budget)

    @property
    def has_budget(self) -> bool:
        return all(p.budget for p in self.passes)


def _environment(cell: dict) -> None:
    """Caches of the program inside this checkout, at fixed paths, and
    the program's spans on; set before the program is imported."""
    os.environ["RABBITKSSD_TPU_TORCH_NATIVE_DIR"] = os.path.join(CACHE,
                                                                 "native")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE,
                                                      "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["KSSD_TIMER"] = "1"
    os.environ.pop("KSSD_PROFILE_DIR", None)
    os.environ.update(cell.get("env", {}))


def _flush_c_stdio() -> None:
    with contextlib.suppress(OSError, AttributeError):
        ctypes.CDLL(None).fflush(None)


def prepare(cell: dict, config: dict, seed: int, dev, work: str
            ) -> tuple[dict, dict, float]:
    """Write the cell's inputs under ``work``; (the traffic's return,
    the values that fill the cell's command, seconds spent making the
    reference's shuffle file)."""
    inputs = os.path.join(work, "in")
    os.makedirs(inputs)
    mix = load_json("traffic", cell["traffic"])
    gen = load_module("traffic", mix["generator"])
    traffic = gen.make(inputs, {**config["sizes"], **mix}, seed, dev)
    values, made_s = dict(traffic["paths"]), 0.0
    if any("{shuf}" in a for a in cell["argv"]):
        values["shuf"], made_s = shuffle_file(config["sizes"], dev)
    return traffic, values, made_s


def shuffle_file(sizes: dict, dev) -> tuple[str, float]:
    """The reference's ``.shuf`` file for ``sizes``, cached in this
    checkout, and the seconds spent making it (0 when found).  A missing
    one is made in a child process on ``dev``: host work done in this
    process before the first command can change how fast the program's
    own host threads run (PERF.md, PR 14: a sketch ran 2.5x faster after
    a parallel torch operation here), and no run may differ from the
    others by whether it found the file."""
    from .reference import shuffle as ref_shuffle

    cache = os.path.join(CACHE, "shuffle")
    path = ref_shuffle.cache_path(cache, **sizes)
    if os.path.exists(path):
        return path, 0.0
    t = time.perf_counter()
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "from kssd_bench.reference import shuffle; "
            f"shuffle.cached_shuffle({cache!r}, device={str(dev)!r}, "
            f"**{sizes!r})")
    subprocess.run([sys.executable, "-c", code], check=True)
    return path, time.perf_counter() - t


def check_context(cell: dict, config: dict, traffic: dict, values: dict,
                  dev, outputs: list[str]) -> types.SimpleNamespace:
    """What a check reads: the outputs judged, the inputs, the sizes, the
    shuffle table (as the reference made it) on the device."""
    import torch

    from .reference import shuffle as ref_shuffle

    table = None
    if "shuf" in values:
        table = torch.from_numpy(ref_shuffle.read_table(values["shuf"])
                                 ).to(dev)
    return types.SimpleNamespace(
        outputs=outputs, paths=traffic["paths"], sizes=config["sizes"],
        table=table, device=dev, cell=cell, config=config)


def run(workload: str, seed: int, seconds: float, trace: bool,
        start: float, device: str = "cuda", require_card: bool = True
        ) -> dict:
    """Run the cell once; the result line as a dict, or a dict holding
    only ``error`` where the run must print no result."""
    cell = load_json("cells", workload)
    config = load_json("configs", cell["config"])
    metrics = cell_metrics(benchmark(), workload, trace)
    _environment(cell)
    n_ranks = cell["chips"]
    if n_ranks > 1:
        from . import ranks

        ranks.environment(n_ranks)
    import torch

    if require_card and (not torch.cuda.is_available()
                         or torch.cuda.device_count() < cell["chips"]):
        raise SystemExit(f"kssd_bench: {cell['chips']} CUDA card(s) needed, "
                         f"{torch.cuda.device_count()} visible")
    if not os.path.isdir(os.path.join(ROOT, "rabbitkssd_tpu_torch")):
        raise SystemExit(f"kssd_bench: no rabbitkssd_tpu_torch in {ROOT}")
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    from rabbitkssd_tpu_torch import cli

    from .trace import summarize

    stages = {"imports": time.perf_counter() - start}

    work = tempfile.mkdtemp(prefix="kssd_bench.")
    group, step = None, run_command
    try:
        outs = os.path.join(work, "out")
        os.makedirs(outs)
        t = time.perf_counter()
        traffic, values, shuffle_s = prepare(cell, config, seed, dev, work)
        values["device"] = device
        # the reference's shuffle file is the check's, not the program's
        stages["reference shuffle"] = shuffle_s
        stages["inputs"] = time.perf_counter() - t - shuffle_s
        if n_ranks > 1:
            t = time.perf_counter()
            group = ranks.Ranks(n_ranks, device, work)
            step = group.command
            stages["ranks"] = time.perf_counter() - t
        t = time.perf_counter()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        out_pat = os.path.join(outs, cell["out"])
        out = out_pat.format(n="w")
        p = step(cli, fill(cell["argv"], dict(values, out=out)), out, dev)
        if p.error:
            raise RuntimeError(f"warm-up command failed: {p.error}")
        os.remove(out)
        stages["warm-up"] = time.perf_counter() - t
        setup_s = time.perf_counter() - start - shuffle_s

        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile

            # device activity (kernels, copies, runtime calls) alone on a
            # card: the commands are host-bound, and recording every torch
            # operation would add host work to what is measured
            prof = profile(activities=[ProfilerActivity.CUDA
                                       if dev.type == "cuda"
                                       else ProfilerActivity.CPU])
            prof.start()
        passes: list[Pass] = []
        t_w0 = time.perf_counter()
        while not passes or time.perf_counter() - t_w0 < seconds:
            out = out_pat.format(n=len(passes))
            passes.append(step(
                cli, fill(cell["argv"], dict(values, out=out)), out, dev))
        summary = None
        if prof is not None:
            prof.stop()
            path = os.path.join(work, "trace.json")
            prof.export_chrome_trace(path)
            del prof
            spans = [(n, p.wall(t) - s, p.wall(t)) for p in passes
                     for n, s, t in p.phases]
            summary = summarize(path, (passes[0].wall0,
                                       passes[-1].wall(passes[-1].t1)),
                                spans)
            os.remove(path)
        memory_peak = (torch.cuda.max_memory_allocated(dev)
                       if dev.type == "cuda" else 0)
        if group is not None:
            # the fullest card; every rank leaves the process group
            peak, leaked_by_workers = group.finish()
            memory_peak = max(memory_peak, peak)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

        t_check = time.perf_counter()
        failed = [p for p in passes if p.error]
        good = [p.out for p in passes if not p.error]
        readings, extras = [], {}
        if good:
            ctx = check_context(cell, config, traffic, values, dev, good)
            verdict = load_module("checks", cell["check"]).judge(ctx)
            extras = verdict["extras"]
            limits = cell["limits"]
            readings = [(n, v, limits[n]) for n, v in verdict["readings"]]
        correct = bool(good) and not failed and all(
            v <= lim for _, v, lim in readings)
        rec = Record(config, traffic["work"], passes, setup_s, summary,
                     extras)
        values_out = {}
        for m in metrics:
            v = load_module("metrics", m["name"]).read(rec)
            if v is not None:
                values_out[m["name"]] = {"value": v, "unit": m["unit"]}
        result = {
            "correct": correct,
            "attempted": len(passes),
            "failed": len(failed),
            "metrics": values_out,
            "device": {
                "platform": "gpu" if dev.type == "cuda" else dev.type,
                "kind": (torch.cuda.get_device_name(dev)
                         if dev.type == "cuda" else "cpu"),
                "count": cell["chips"],
                "memory_peak_bytes": memory_peak,
            },
        }
        if summary is not None:
            result["device"]["busy_s"] = summary.busy_s
            result["device"]["window_s"] = summary.window_s
            top = sorted(summary.by_name.items(), key=lambda kv: -kv[1][0])
            result["breakdown"] = {
                "device_ops": [[k, v[0] / 1e6] for k, v in top[:10]],
                "idle_gaps": [[k, us / 1e6] for k, us in summary.gaps],
            }
        result["checks"] = {n: {"value": v, "limit": lim}
                            for n, v, lim in readings}
        result["_failures"] = [p.error[-2000:] for p in failed[:3]]
        result["_stages"] = dict(stages, check=time.perf_counter() - t_check)
        result["_commands"] = [
            f"{p.span_s:.3f} s: " + ", ".join(
                f"{n} {v:.3f}" for n, v, _ in p.phases)
            for p in passes]
        leaked = forbidden_loaded()
        if group is not None:
            leaked += leaked_by_workers
        if leaked:
            return {"error": f"modules loaded: {', '.join(leaked)}"}
        return result
    finally:
        if group is not None:
            group.close()
        shutil.rmtree(work, ignore_errors=True)


def main(argv: list[str] | None = None, start: float | None = None) -> int:
    start = time.perf_counter() if start is None else start
    ap = argparse.ArgumentParser(prog="kssd_bench/run.py",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, choices=names("cells",
                                                                ".json"))
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 start)
    _flush_c_stdio()
    if "error" in result:
        print(f"kssd_bench: {result['error']}", file=sys.stderr)
        return 3
    for err in result.pop("_failures"):
        print(f"kssd_bench: a timed command failed:\n{err}", file=sys.stderr)
    for k, line in enumerate(result.pop("_commands")):
        print(f"kssd_bench: command {k}: {line}", file=sys.stderr)
    stages = result.pop("_stages")
    print("kssd_bench: seconds of " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
