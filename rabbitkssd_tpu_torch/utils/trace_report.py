"""Where the device time went in one ``torch.profiler`` Chrome trace.

``utils.timers.phase`` writes one trace per CLI phase under
``KSSD_PROFILE_DIR``.  This reads one back and reports the trace's span,
the device's busy time (the union of its kernel, copy and memset
intervals, so overlapping streams count once), the busy share of the
span, and device time summed by kernel or copy name.  With ``within``,
only the device work launched inside the host ranges of that name (a
``torch.profiler.record_function``) counts, matched to its launch calls
by correlation id; ``launches`` and ``unrecorded`` then say how many
launch calls those ranges made and of how many the trace holds no
device record.

    python -m rabbitkssd_tpu_torch.utils.trace_report TRACE.json [--top N]
        [--within NAME]
"""

from __future__ import annotations

import argparse
import json

# trace event categories that run on the device
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host API calls that put work on the device, by a part of their name
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
LAUNCH_NAMES = ("Launch", "Memcpy", "Memset")


def _union_us(intervals: list[tuple[float, float]]) -> float:
    """Total length of the union of [start, end) intervals."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _within(spans: list[dict], dev: list[dict], name: str
            ) -> tuple[list[dict], int, int]:
    """The device records of the work launched inside the host ranges
    called ``name``, the count of launch calls there, and the count of
    those calls with no device record."""
    ranges = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
              for e in spans if e.get("cat") == "user_annotation"
              and e.get("name") == name]
    corr = {e.get("args", {}).get("correlation") for e in spans
            if e.get("cat") in LAUNCH_CATS
            and any(n in e.get("name", "") for n in LAUNCH_NAMES)
            and any(a <= float(e["ts"]) <= b for a, b in ranges)}
    corr.discard(None)
    mine = [e for e in dev if e.get("args", {}).get("correlation") in corr]
    recorded = {e["args"]["correlation"] for e in mine}
    return mine, len(corr), len(corr - recorded)


def summarize(path: str, top: int = 20, within: str | None = None
              ) -> dict:
    """Span, device busy time and share, and the ``top`` device entries
    by summed time, of the Chrome trace at ``path`` (times in ms); with
    ``within``, of the device work launched inside those host ranges."""
    with open(path) as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in spans if e.get("cat") in DEVICE_CATS]
    extra = {}
    if within is not None:
        dev, launches, unrecorded = _within(spans, dev, within)
        extra = {"launches": launches, "unrecorded": unrecorded}
    out = {"span_ms": 0.0, "device_window_ms": 0.0, "device_busy_ms": 0.0,
           "busy_share": 0.0, "device_events": len(dev), "top": [], **extra}
    if not spans:
        return out
    t0 = min(float(e["ts"]) for e in spans)
    t1 = max(float(e["ts"]) + float(e["dur"]) for e in spans)
    out["span_ms"] = (t1 - t0) / 1e3
    if not dev:
        return out
    iv = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]
    busy = _union_us(iv)
    out["device_window_ms"] = (max(b for _, b in iv)
                               - min(a for a, _ in iv)) / 1e3
    out["device_busy_ms"] = busy / 1e3
    out["busy_share"] = busy / (t1 - t0) if t1 > t0 else 0.0
    by_name: dict[tuple[str, str], list] = {}
    for e in dev:
        acc = by_name.setdefault((e["cat"], e.get("name", "")), [0.0, 0])
        acc[0] += float(e["dur"]) / 1e3
        acc[1] += 1
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])
    out["top"] = [{"cat": cat, "name": name, "ms": ms, "count": n}
                  for (cat, name), (ms, n) in ranked[:top]]
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--within", default=None,
                    help="count only the device work launched inside the "
                         "host ranges of this name")
    args = ap.parse_args(argv)
    print(json.dumps(summarize(args.trace, args.top, args.within),
                     indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
