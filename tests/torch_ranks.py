"""Start the ranks of a torch.distributed program on this machine, as
``torchrun --standalone`` would, with one deadline for all of them.

Each child gets RANK, WORLD_SIZE, LOCAL_RANK, LOCAL_WORLD_SIZE,
MASTER_ADDR (127.0.0.1), a free MASTER_PORT and OMP_NUM_THREADS=1; its
stdout and stderr go to files under ``logdir``.  On the deadline every
child still running is killed and the test fails.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(argv: list[str], world: int, logdir: str, **kw) -> list[str]:
    """:func:`rank_results`, failing if a rank exits non-zero; returns
    each rank's stdout."""
    outs = []
    for r, (rc, out, err) in enumerate(rank_results(argv, world, logdir,
                                                    **kw)):
        assert rc == 0, f"rank {r} exited {rc}:\n{err[-4000:]}"
        outs.append(out)
    return outs


def rank_results(argv: list[str], world: int, logdir: str, local: int = 0,
                 cwds: list[str] | None = None, env: dict | None = None,
                 timeout: float = 90.0) -> list[tuple[int, str, str]]:
    """Run ``argv`` (after the interpreter) as ``world`` ranks, ``local``
    per emulated node (default: all on one), node i's ranks in
    ``cwds[i]``; returns each rank's (exit code, stdout, stderr).  Fails
    if the deadline passes."""
    from rabbitkssd_tpu.native import load_native

    load_native()  # build the shared native library once, before children
    os.makedirs(logdir, exist_ok=True)
    local = local or world
    port = free_port()
    procs, logs = [], []
    try:
        for r in range(world):
            e = dict(os.environ, **(env or {}))
            e.update(RANK=str(r), WORLD_SIZE=str(world),
                     LOCAL_RANK=str(r % local), LOCAL_WORLD_SIZE=str(local),
                     MASTER_ADDR="127.0.0.1",
                     MASTER_PORT=str(port), OMP_NUM_THREADS="1",
                     PYTHONPATH=os.pathsep.join(
                         p for p in (REPO, e.get("PYTHONPATH")) if p))
            out = open(os.path.join(logdir, f"rank{r}.out"), "w+")
            err = open(os.path.join(logdir, f"rank{r}.err"), "w+")
            logs.append((out, err))
            procs.append(subprocess.Popen(
                [sys.executable, *argv], env=e, stdout=out, stderr=err,
                cwd=cwds[r // local] if cwds else None))
        deadline = time.monotonic() + timeout
        for p in procs:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                raise AssertionError(
                    f"{world} ranks did not finish in {timeout} s") from None
        results = []
        for p, (out, err) in zip(procs, logs):
            out.seek(0)
            err.seek(0)
            results.append((p.returncode, out.read(), err.read()))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in logs:
            out.close()
            err.close()
