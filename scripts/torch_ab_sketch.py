#!/usr/bin/env python3
"""A/B of the port's sketch main path between checkouts, on one card.

    python scripts/torch_ab_sketch.py ROOT [ROOT ...]

For each ROOT in turn (a checkout of this repository: this one, or an
earlier commit unpacked with ``git archive`` into a git-ignored
directory), a fresh process imports ROOT's ``chip_smoke.py`` and runs
its phase 4 (config 1: 256 genomes x ~2 Mb through the CLI ``sketch``
and ``alldist`` at L3K10, with its checks) and phase 7 (the same sketch
again, warm, under ``torch.profiler``).  Each prints one JSON line with
the card's name and power limit, the CLI sketch wall and Mbase/s, the
sketcher's budget (``dispatch``, ``feed``, ``h2d_put``, ``qwait`` and
the pipeline wall, unprofiled) and the trace's device events, device
time and busy share per batch.  Give the roots in turns (A, B, B, A) to
compare two versions within one call.  Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

_CHILD = r"""
import json, subprocess, sys, tempfile
root = sys.argv[1]
sys.path.insert(0, root)
import torch
import chip_smoke as cs

assert torch.cuda.is_available(), "needs a CUDA card"
dev = torch.device("cuda")
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True, check=True).stdout.strip().splitlines()[0]
with tempfile.TemporaryDirectory(prefix="kssd_ab_") as work:
    mp, ctx = cs.main_path(dev, work, cs.N_GENOMES, cs.GENOME_LEN)
    prof = cs.profile_sketch(dev, ctx, work, mp["budget"])
b = mp["budget"]
print(json.dumps({
    "root": root, "card": smi, "sketch_s": mp["sketch_s"],
    "sketch_mbase_per_s": mp["sketch_mbase_per_s"],
    "alldist_s": mp["alldist_s"], "batches": b["batches"],
    "pipeline_wall_s": b["wall"],
    "dispatch_ms_per_batch": 1e3 * b["dispatch"] / b["batches"],
    **{k: b[k] for k in ("dispatch", "feed", "h2d_put", "qwait")},
    "traced_pipeline_wall_s": prof["pipeline_wall_s"],
    "device_events_per_batch": prof["device_events_per_batch"],
    "device_busy_ms_per_batch": prof["device_busy_ms_per_batch"],
    "busy_share": prof["busy_share"]}))
"""


def main() -> int:
    roots = sys.argv[1:]
    if not roots:
        print(__doc__, file=sys.stderr)
        return 2
    for root in roots:
        root = os.path.abspath(root)
        proc = subprocess.run([sys.executable, "-c", _CHILD, root],
                              cwd=root, capture_output=True, text=True,
                              timeout=900)
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-6000:])
            print(f"torch_ab_sketch: {root} exited {proc.returncode}",
                  file=sys.stderr)
            return 1
        print(proc.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
