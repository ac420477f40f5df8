"""Per-phase wall-clock spans, reference-style, for the port.

As in ``rabbitkssd_tpu/utils/timers.py``: spans are on by default and
print ``===...time of <name> is: <s>`` to stderr (the reference's Timer
spans); ``KSSD_TIMER=0`` disables them.  ``KSSD_PROFILE_DIR=<dir>``
additionally records a ``torch.profiler`` trace of each span (CPU and,
where a card is present, CUDA activity) as a Chrome trace in ``<dir>``.
:func:`progress_bar_size` is that module's, copied.
"""

from __future__ import annotations

import contextlib
import os
import re
import sys
import time

ENABLED = os.environ.get("KSSD_TIMER", "1") != "0"
PROFILE_DIR = os.environ.get("KSSD_PROFILE_DIR", "")


@contextlib.contextmanager
def phase(name: str):
    """Time a pipeline phase; print `===...time of <name> is: <s>`."""
    prof = None
    if PROFILE_DIR:
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    t0 = time.time()
    try:
        yield
    finally:
        if prof is not None:
            prof.stop()
            os.makedirs(PROFILE_DIR, exist_ok=True)
            stem = re.sub(r"[^A-Za-z0-9_.-]+", "_", name)[:80]
            prof.export_chrome_trace(
                os.path.join(PROFILE_DIR, f"{stem}.{os.getpid()}.json"))
    if ENABLED:
        print(
            f"===================time of {name} is: {time.time() - t0:.6g}",
            file=sys.stderr,
        )


def progress_bar_size(total: int) -> int:
    """Adaptive progress step, exactly get_progress_bar_size
    (reference common.cpp:23-32); copied from the JAX package."""
    coarse = total // 20
    step = 10
    while coarse // step:
        step *= 10
    step //= 10
    return (coarse // step + 1) * step
