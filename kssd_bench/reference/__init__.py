"""The plain reference of the benchmark.

Straightforward NumPy and PyTorch code (PyTorch on whatever device it is
given) that works out, from the benchmark's own inputs, what the program
under test must produce: the shuffle table and every genome's Kssd
sketch.  It imports no module of the program
and nothing of the JAX package; ``tests/test_kssd_bench_imports.py``
holds it to that.
"""
