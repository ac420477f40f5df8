"""The benchmark of ``rabbitkssd_tpu_torch`` on NVIDIA H100 cards.

    python3 kssd_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run sets up one cell, repeats the cell's user command for the
window, checks what the timed commands wrote against the plain
reference in ``reference/``, and prints one JSON result line.  Cells,
configurations, traffic kinds, output checks and metrics are found by
name under this directory (``cells/``, ``configs/``, ``traffic/``,
``checks/``, ``metrics/``); ``BENCHMARK.json`` at the repository root
says which metrics a cell reports.  Nothing here imports JAX or the JAX
package.
"""
