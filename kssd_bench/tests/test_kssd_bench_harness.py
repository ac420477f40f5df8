"""The harness on the CPU: discovery by name, repeatable traffic, the
metric readers on recorded fixtures, refusal without a card, the plain
reference against the program's ``--device cpu`` on tiny cells, and
correct turning false when the program is broken underneath."""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import kssd_bench_tiny as tiny  # noqa: E402

sys.path.insert(0, tiny.ROOT)
from kssd_bench import harness, roofline, trace  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.fixture(scope="module")
def copy(tmp_path_factory):
    return tiny.bench_copy(str(tmp_path_factory.mktemp("bench")))


# -- discovery --------------------------------------------------------------

def test_every_cell_resolves_by_name():
    bench = harness.benchmark()
    cells = harness.names("cells", ".json")
    assert sorted(w["name"] for w in bench["workloads"]) == cells
    for w in bench["workloads"]:
        cell = harness.load_json("cells", w["name"])
        assert cell["config"] == w["config"]
        assert cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"]
        mix = harness.load_json("traffic", cell["traffic"])
        assert callable(harness.load_module("traffic", mix["generator"]).make)
        check = harness.load_module("checks", cell["check"])
        assert callable(check.judge) and callable(check.control)
        assert set(cell["limits"]) >= {"passes_differing"}
        for metric in (harness.cell_metrics(bench, w["name"], False)
                       + harness.cell_metrics(bench, w["name"], True)):
            assert callable(harness.load_module("metrics",
                                                metric["name"]).read)


def test_configs_state_their_cuts():
    bench = harness.benchmark()
    for c in bench["configs"]:
        assert c["file"] == f"kssd_bench/configs/{c['name']}.json"
        cfg = harness.load_json("configs", c["name"])
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert key in cfg and NAME.match(key)


def test_cells_pair_configs_and_traffic_once():
    bench = harness.benchmark()
    cells = bench["workloads"]
    pairs = [(w["config"], w["traffic"]) for w in cells]
    assert len(pairs) == len(set(pairs)), pairs
    configs = [c["name"] for c in bench["configs"]]
    assert sorted(configs) == sorted({w["config"] for w in cells})
    sources = [c["source"] for c in bench["configs"]]
    assert len(sources) == len(set(sources))
    assert all(w["chips"] in (1, 4) for w in cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)


def test_names_units_and_lines_keep_the_contract():
    bench = harness.benchmark()
    every = (bench["configs"] + bench["workloads"] + bench["end_to_end"]
             + bench["per_layer"])
    for e in every:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert re.match(r"^[A-Za-z0-9_/%.-]{1,16}$", m["unit"])
        assert m["better"] in ("lower", "higher")
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    moved = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in moved
        e2e = next(x for x in bench["end_to_end"] if x["name"] == m["moves"])
        for cell in m["workloads"]:
            assert cell in e2e.get("workloads", [cell])


def test_a_new_cell_is_files_only(copy):
    """The copy gained a config, traffic mixes, cells and a metric as new
    files; the harness finds them by name."""
    rc, out, err = tiny.run_in(copy, """
from kssd_bench import harness
print(json.dumps([harness.names("cells", ".json"),
                  harness.names("metrics", ".py")]))
""")
    assert rc == 0, err
    cells, metrics = json.loads(out)
    assert set(tiny.CELLS) <= set(cells)
    assert "test_commands" in metrics


# -- traffic ------------------------------------------------------------------

def _tree_digest(root: str) -> str:
    h = hashlib.sha256()
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            if f.endswith(".list"):  # absolute paths into its directory
                continue
            h.update(f.encode())
            with open(os.path.join(dirpath, f), "rb") as fh:
                h.update(fh.read())
    return h.hexdigest()


@pytest.mark.parametrize("mix", sorted(tiny.MIXES))
def test_traffic_repeats_for_a_seed_and_differs_across(tmp_path, mix):
    params = dict(tiny.CONFIG["sizes"], **tiny.MIXES[mix])
    gen = harness.load_module("traffic", params["generator"])
    digests, works = [], []
    for k, seed in enumerate([2 ** 31 + 11, 2 ** 31 + 11, 5]):
        d = tmp_path / str(k)
        d.mkdir()
        got = gen.make(str(d), params, seed, torch.device("cpu"))
        works.append(got["work"])
        digests.append(_tree_digest(str(d)))
    assert digests[0] == digests[1] != digests[2]
    # a seed changes the contents, never the amount of work
    assert works[0] == works[1] == works[2]


# -- readers --------------------------------------------------------------------

BUDGET = {"feed": 1.0, "h2d_put": 0.5, "qwait": 0.25, "dispatch": 0.1,
          "flush_scalars": 0.05, "flush_collect": 0.1, "finalize": 0.1,
          "drain": 0.0, "wall": 2.0, "h2d_bytes": 10, "batches": 100,
          "reruns": 0, "exchange": 0.0}


def _pass(t0: float, lines: list[str], span: float) -> harness.Pass:
    return harness.Pass("x", t0, t0 + span,
                        [(t0 + 0.1 * (i + 1), ln) for i, ln in
                         enumerate(lines)], None)


# the fixture's window: wall-clock 100.001 .. 102.001 s
WINDOW = (100.001, 102.001)


def _chrome(path: str) -> None:
    """A 2 s window; three kernels; one host call in a gap; trace time
    is wall-clock microseconds less a base of 100 s."""
    ev = [
        {"ph": "X", "cat": "kernel", "name": "stream_keep_kernel",
         "ts": 1000.0 + 1e5, "dur": 2e5},
        {"ph": "X", "cat": "kernel", "name": "stream_compact_kernel",
         "ts": 1000.0 + 2e5, "dur": 2e5},   # overlaps the first
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
         "ts": 1000.0 + 1.5e6, "dur": 1e5},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 1000.0 + 6e5, "dur": 5e5},
        {"ph": "X", "cat": "kernel", "name": "outside the window",
         "ts": 1000.0 + 3e6, "dur": 1e5},
    ]
    with open(path, "w") as f:
        json.dump({"traceEvents": ev, "baseTimeNanoseconds": 100e9}, f)


def test_trace_summary_on_a_recorded_fixture(tmp_path):
    path = str(tmp_path / "t.json")
    _chrome(path)
    s = trace.summarize(path, WINDOW, [("read", 100.501, 101.201),
                                       ("outer", 100.0, 103.0),
                                       ("emit", 101.201, 101.25)])
    assert s.window_s == pytest.approx(2.0)
    assert s.busy_s == pytest.approx(0.4)  # 0.1-0.4 and 1.5-1.6
    assert s.kernel_s("stream_keep") == (pytest.approx(0.2), 1)
    # longest gap: 0.4 .. 1.5 s; of the innermost spans over it "read"
    # covers most of it; the runtime call is open at its middle
    assert s.gaps[0][0] == "read | cudaMemcpyAsync"
    assert s.gaps[0][1] == pytest.approx(1.1e6)


def test_readers_on_recorded_lines(tmp_path):
    path = str(tmp_path / "t.json")
    _chrome(path)
    lines = ["sketch budget: " + json.dumps(BUDGET)]
    passes = [_pass(0.0, lines, 4.0), _pass(4.0, lines, 4.0)]
    rec = harness.Record(
        config={"sizes": {"half_k": 10, "half_subk": 6,
                                   "drlevel": 3}},
        work={"bases": 8_000_000}, passes=passes,
        setup_s=12.5, trace=trace.summarize(path, WINDOW),
        extras={"survivors": 2000})

    def read(name):
        return harness.load_module("metrics", name).read(rec)

    assert read("setup_s") == 12.5
    assert read("sketch_Mbase_s") == pytest.approx(2.0)   # 16e6 / 8 s
    assert read("feed_share.sketch") == pytest.approx(50.0)
    assert read("h2d_put_share.sketch") == pytest.approx(25.0)
    assert read("qwait_share.sketch") == pytest.approx(12.5)
    assert read("finalize_share.sketch") == pytest.approx(12.5)
    assert read("dispatch_ms_per_batch.sketch") == pytest.approx(1.0)
    assert read("cli_rest_share.sketch") == pytest.approx(50.0)
    assert read("device_idle_pct.sketch") == pytest.approx(80.0)
    keep_s, _ = roofline.bound_s(*[2 * x for x in
                                   roofline.stream_keep_work(8_000_000)])
    assert read("stream_keep_roofline") == pytest.approx(100 * keep_s / 0.2)
    assert 0 < read("stream_compact_roofline") < 100


def test_readers_find_nothing_without_their_source():
    rec = harness.Record(config={}, work={}, setup_s=1.0,
                         passes=[_pass(0.0, [], 1.0)], trace=None, extras={})
    for name in ("feed_share.sketch", "stream_keep_roofline",
                 "device_idle_pct.sketch", "cli_rest_share.sketch",
                 "dispatch_ms_per_batch.sketch", "sketch_Mbase_s"):
        assert harness.load_module("metrics", name).read(rec) is None


def test_bounds_count_input_work():
    b, ops = roofline.stream_keep_work(512_000_000)
    t, what = roofline.bound_s(b, ops)
    assert what == "operations"
    assert t == pytest.approx(26 * 512e6 / 33.5e12)
    b, ops = roofline.stream_compact_work(512_000_000, 125_000, 4, 20)
    assert roofline.bound_s(b, ops)[1] == "bytes"


def test_a_made_shuffle_file_is_timed_apart(tmp_path, monkeypatch):
    """The reference's shuffle file, made on a run's first use, gives the
    seconds that set-up leaves out; a cached one gives 0."""
    from kssd_bench.reference import shuffle as ref_shuffle

    monkeypatch.setattr(harness, "CACHE", str(tmp_path))
    path, made = harness.shuffle_file(tiny.CONFIG["sizes"],
                                      torch.device("cpu"))
    assert made > 0
    with open(path, "rb") as f:
        assert f.read() == ref_shuffle.shuffle_bytes(6, 4, 1)
    assert harness.shuffle_file(tiny.CONFIG["sizes"],
                                torch.device("cpu")) == (path, 0.0)


# -- whole runs on the CPU ------------------------------------------------------

def test_without_a_card_the_run_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "kssd_bench/run.py", "--workload",
                        "sketch.bact-L3K10", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tiny.ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


def test_without_the_program_the_run_fails(tmp_path):
    import shutil

    shutil.copytree(tiny.BENCH, tmp_path / "kssd_bench",
                    ignore=shutil.ignore_patterns("cache", "__pycache__"))
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "kssd_bench/run.py", "--workload",
                        "sketch.bact-L3K10", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"correct"' not in p.stdout


@pytest.mark.parametrize("trace_on", [0, 1])
@pytest.mark.parametrize("cell", sorted(tiny.CELLS))
def test_cpu_run_is_correct_against_the_reference(copy, cell, trace_on):
    r = tiny.cpu_run(copy, cell, trace_on)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert all(c["value"] <= c["limit"] for c in r["checks"].values())
    assert list(r)[-1] == "checks"
    bench = json.load(open(os.path.join(copy, "BENCHMARK.json")))
    want = harness.cell_metrics(bench, cell, bool(trace_on))
    # what needs the card may read nothing here
    assert set(r["metrics"]) <= {m["name"] for m in want}
    if trace_on:
        assert "busy_s" in r["device"] and "breakdown" in r
        if cell == "sketch.test-L2K6":
            assert r["metrics"]["test_commands"]["value"] == r["attempted"]
    else:
        assert "setup_s" in r["metrics"]


# breaking the program underneath the run: an answer altered where it is
# produced, and half of the stream steps left out
FAULTS = {
    "sketch_answer": ("sketch.test-L2K6", """
import rabbitkssd_tpu_torch.engine.sketcher as sk
_finish = sk.GenomeFinalizer.finish
def finish(self):
    out, n = _finish(self)
    out[0] = out[0][1:]
    return out, n
sk.GenomeFinalizer.finish = finish
"""),
    "sketch_half_the_steps": ("sketch.test-L2K6", """
import rabbitkssd_tpu_torch.engine.sketcher as sk
_call = sk.StreamStep.__call__
calls = [0]
def call(self, words, exc, tables, bufs, count, overflow, *a):
    # every second step, the warm-up's first one kept: a window of one
    # command still meets a skipped step
    calls[0] += 1
    if calls[0] % 2 == 0:
        return count, overflow
    return _call(self, words, exc, tables, bufs, count, overflow, *a)
sk.StreamStep.__call__ = call
"""),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_program_reads_incorrect(copy, fault):
    cell, patch = FAULTS[fault]
    r = tiny.cpu_run(copy, cell, patch=patch)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())
