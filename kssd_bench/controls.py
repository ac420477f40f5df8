"""Readings of a cell's correctness control, for setting its limits.

    python3 kssd_bench/controls.py --workload <cell> --seeds <n> [<n> ...]

For each seed: make the cell's inputs as a run does, put the plain
reference with the cell's ``control`` change in the program's place
(``checks/<check>.py:control``), judge that output as a run's output
is judged, and print one JSON line of readings.  The program does not
run.  A cell's control has to read above the cell's limits; the
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))

from kssd_bench import harness  # noqa: E402


def readings(workload: str, seed: int, device: str = "cuda",
             control: dict | None = None) -> dict:
    """One seed's readings; ``control`` replaces the cell's own."""
    import torch

    cell = harness.load_json("cells", workload)
    if control is not None:
        cell["control"] = control
    config = harness.load_json("configs", cell["config"])
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    work = tempfile.mkdtemp(prefix="kssd_bench.control.")
    try:
        traffic, values, _ = harness.prepare(cell, config, seed, dev,
                                             work)
        ctx = harness.check_context(cell, config, traffic, values, dev, [])
        got = harness.load_module("checks", cell["check"]).control(ctx)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"workload": workload, "seed": seed, "control": cell["control"],
            "readings": dict(got["readings"]), "limits": cell["limits"]}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--control", type=json.loads, default=None,
                    help="a JSON object in place of the cell's control")
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.device,
                                  args.control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
