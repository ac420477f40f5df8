"""What a ``torch.profiler`` Chrome trace of the window says.

The busy-time arithmetic (the union of the device's kernel, copy and
memset intervals, so overlapping streams count once; device time summed
by name) is a frozen copy of ``rabbitkssd_tpu_torch/utils/
trace_report.py:_union_us`` and ``summarize`` (commit
251baa72153c12dfd30056862f5a431398347f0f).  Added here: the window is
cut to the timed commands, and the idle gaps between the device's busy
intervals are named by what the host was doing then.
"""

from __future__ import annotations

import dataclasses
import json

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host events that say what the host was doing: torch operations (traced
# on a CPU device only) and CUDA runtime and driver calls
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")


def merge(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    """Sorted, disjoint union of [start, end) intervals."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclasses.dataclass
class TraceSummary:
    window_us: tuple[float, float]       # first pass start .. last pass end
    busy_us: float                       # union of device intervals in it
    by_name: dict[str, tuple[float, int]]  # device us and count, by name
    gaps: list[tuple[str, float]]        # (what the host did, us), longest first

    @property
    def window_s(self) -> float:
        return (self.window_us[1] - self.window_us[0]) / 1e6

    @property
    def busy_s(self) -> float:
        return self.busy_us / 1e6

    def kernel_s(self, part: str) -> tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds
        ``part``."""
        us = sum(v[0] for k, v in self.by_name.items() if part in k)
        n = sum(v[1] for k, v in self.by_name.items() if part in k)
        return us / 1e6, n


def _label(gap: tuple[float, float], ops: list[tuple[float, float, str]],
           spans: list[tuple[float, float, str]]) -> str:
    """What the host did in an idle gap: of the program's innermost spans
    that overlap it, the one that overlaps it most, and the innermost
    host event at its middle."""
    a, b = gap

    def cover(s, e):
        return min(b, e) - max(a, s)

    hit = [(s, e, n) for s, e, n in spans if cover(s, e) > 0]
    leaves = [x for x in hit if not any(
        y is not x and x[0] <= y[0] and y[1] <= x[1] for y in hit)]
    span = (max(leaves, key=lambda x: cover(x[0], x[1]))[2] if leaves
            else "outside program spans")
    t = (a + b) / 2
    inner = [(e - s, n) for s, e, n in ops if s <= t < e]
    op = min(inner)[1] if inner else "no traced host call"
    return f"{span} | {op}"


def summarize(path: str, window: tuple[float, float],
              host_spans: list[tuple[str, float, float]] = (),
              top: int = 10) -> TraceSummary:
    """Read the trace at ``path`` over ``window`` (wall-clock seconds,
    ``time.time()``: the first timed command's start to the last one's
    end).  A trace's ``ts`` plus its ``baseTimeNanoseconds`` is wall-clock
    microseconds.  ``host_spans``: the program's own spans as (name,
    start, end) in wall-clock seconds, used to name idle gaps."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    base = (trace.get("baseTimeNanoseconds", 0) / 1e3
            if isinstance(trace, dict) else 0.0)
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    w0, w1 = window[0] * 1e6 - base, window[1] * 1e6 - base
    dev = [e for e in xs if e.get("cat") in DEVICE_CATS]
    iv = []
    by_name: dict[str, list] = {}
    for e in dev:
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e["dur"]), w1)
        if t <= s:
            continue
        iv.append((s, t))
        acc = by_name.setdefault(e.get("name", ""), [0.0, 0])
        acc[0] += t - s
        acc[1] += 1
    busy = merge(iv)
    edges = [w0] + [x for s, e in busy for x in (s, e)] + [w1]
    ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
           for e in xs if e.get("cat") in HOST_CATS]
    spans = sorted((a * 1e6 - base, b * 1e6 - base, n)
                   for n, a, b in host_spans)
    gaps = []
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            gaps.append((e - s, s, e))
    gaps.sort(reverse=True)
    named = [(_label((s, e), ops, spans), d) for d, s, e in gaps[:top]]
    return TraceSummary(
        window_us=(w0, w1), busy_us=sum(e - s for s, e in busy),
        by_name={k: (v[0], v[1]) for k, v in by_name.items()}, gaps=named)
