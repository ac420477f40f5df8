"""Run one benchmark cell once:

    python3 kssd_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

(or ``python3 -m kssd_bench.run ...``) from the repository root.
"""

import time

START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))))
    from kssd_bench.harness import main

    sys.exit(main(start=START))
