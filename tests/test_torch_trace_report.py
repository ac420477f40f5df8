"""utils.trace_report: device busy time of a torch.profiler Chrome trace.

Exact comparison on a hand-made trace (times are sums of the given
microsecond values), and a real CPU trace written by ``timers.phase``.
"""

import json

import torch

from rabbitkssd_tpu_torch.utils import timers
from rabbitkssd_tpu_torch.utils.trace_report import main, summarize

torch.set_num_threads(1)


def _x(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summarize_hand_made_trace(tmp_path):
    """Overlapping device intervals count once; host events widen the
    span but add no device time; per-name sums are exact."""
    events = [
        _x("cpu_op", "aten::add", 0, 1000),
        _x("kernel", "k_a", 100, 200),          # [100, 300)
        _x("kernel", "k_b", 250, 100),          # [250, 350) overlaps k_a
        _x("gpu_memcpy", "Memcpy HtoD", 500, 50),  # [500, 550)
        _x("kernel", "k_a", 900, 300),          # [900, 1200) ends last
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5000},
        {"ph": "M", "name": "process_name"},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = summarize(str(path), top=2)
    assert got["span_ms"] == 1.2
    assert got["device_window_ms"] == 1.1
    assert got["device_busy_ms"] == 0.6
    assert got["busy_share"] == 600 / 1200
    assert got["device_events"] == 4
    assert got["top"] == [
        {"cat": "kernel", "name": "k_a", "ms": 0.5, "count": 2},
        {"cat": "kernel", "name": "k_b", "ms": 0.1, "count": 1},
    ]


def _corr(e, c):
    return {**e, "args": {"correlation": c}}


def test_summarize_within_a_host_range(tmp_path, capsys):
    """``within`` keeps the device work launched inside the named host
    range, by correlation id, whatever its device time; a launch call
    there with no device record is counted as unrecorded."""
    events = [
        _corr(_x("cuda_runtime", "cudaLaunchKernel", 10, 5), 1),  # before
        _x("user_annotation", "timed", 100, 400),
        _corr(_x("cuda_runtime", "cudaLaunchKernel", 110, 5), 2),
        _corr(_x("cuda_driver", "cuLaunchKernel", 150, 5), 3),
        _corr(_x("cuda_runtime", "cudaMemcpyAsync", 200, 5), 4),
        _corr(_x("cuda_runtime", "cudaStreamSynchronize", 300, 5), 5),
        _corr(_x("kernel", "primer", 20, 10), 1),
        _corr(_x("kernel", "k_a", 90, 30), 2),   # starts before the range
        _corr(_x("kernel", "k_a", 600, 20), 3),  # ends after it
        _x("gpu_user_annotation", "timed", 90, 600),
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": events}))
    got = summarize(str(path), within="timed")
    assert (got["launches"], got["unrecorded"]) == (3, 1)
    assert got["device_events"] == 2
    assert got["device_busy_ms"] == 0.05
    assert got["top"] == [{"cat": "kernel", "name": "k_a", "ms": 0.05,
                           "count": 2}]
    assert "launches" not in summarize(str(path))
    capsys.readouterr()
    assert main([str(path), "--within", "timed"]) == 0
    assert json.loads(capsys.readouterr().out) == got


def test_summarize_cpu_phase_trace(tmp_path, monkeypatch, capsys):
    """A phase traced on the CPU has a span and no device time; the
    module's command line prints the same summary."""
    monkeypatch.setattr(timers, "PROFILE_DIR", str(tmp_path))
    with timers.phase("cpu only"):
        torch.arange(1000).cumsum(0)
    (trace,) = tmp_path.iterdir()
    got = summarize(str(trace))
    assert got["span_ms"] > 0
    assert got["device_busy_ms"] == 0 and got["device_events"] == 0
    capsys.readouterr()
    assert main([str(trace)]) == 0
    assert json.loads(capsys.readouterr().out) == got
