"""A cell on several cards, one rank a card, as ``torchrun --standalone``
starts them: a cell with ``chips`` C > 1 runs every command on C ranks.

The harness process is rank 0.  After it has made the cell's inputs it
starts ranks 1 .. C-1 as worker processes of this module (:func:`serve`).
Every rank has the environment that ``torchrun --standalone
--nproc-per-node=C`` gives (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, and
``OMP_NUM_THREADS`` 1 where it is unset) besides the harness's own, all
set before the program is imported; a worker touches no card but
``cuda:LOCAL_RANK``.  Every rank runs the same commands through
``rabbitkssd_tpu_torch.cli.main``, warm-up first, so each process starts
the program's process group once and keeps it.

The harness drives each worker over a ``multiprocessing`` pipe of its
own: it sends a command, and the worker answers once the command has
ended and its card is synchronised.  The harness issues no collective:
each command ends at the program's own barrier, and after the window
every rank leaves the group through the program's ``shutdown()``, as its
command line does at exit.  A command starts on every rank together and
ends when the last rank has answered.

A worker that exits, or a command that one rank has ended and another
has not ``ANSWER_S`` later (or that runs past ``ANSWER_S``, the warm-up
past ``WARM_S``), ends the run at once with an error
(:meth:`Ranks.abort`) instead of waiting out the program's ten-minute
collective timeout; a thread watches for it, since rank 0 may be inside
that collective.  Workers write their output to
``<work>/ranks/rank<r>.log``; an aborted run prints the tails.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import itertools
import os
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time
from multiprocessing import Pipe, connection

from . import harness

# seconds a timed command may take, and a rank may take to end one
# after another rank ended it (a command takes a few seconds)
ANSWER_S = 120.0
# seconds the workers' start and the warm-up may take: the first run in
# a checkout builds the program
WARM_S = 1000.0
TAIL = 4000  # characters of each worker's log printed on an abort


def environment(n: int) -> None:
    """Rank 0's part of ``torchrun --standalone``'s environment, in this
    process; the workers inherit it with their own ranks."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE=str(n),
                      LOCAL_WORLD_SIZE=str(n), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    # torchrun sets it where a node runs more than one process
    os.environ.setdefault("OMP_NUM_THREADS", "1")


def worker_argv() -> list[str]:
    """The command that starts a worker; :class:`Ranks` appends the
    pipe's descriptor, the device and the harness's process id."""
    code = (f"import sys; sys.path.insert(0, {harness.ROOT!r})\n"
            "from kssd_bench.ranks import serve\n"
            "sys.exit(serve())\n")
    return [sys.executable, "-c", code]


# --------------------------------------------------------------------------
# a worker
# --------------------------------------------------------------------------

def serve() -> int:
    """A worker: ``argv`` holds the pipe, the device and the harness's
    process id."""
    fd, device, parent = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
    # be killed when the harness process ends, however it ends
    with contextlib.suppress(OSError, AttributeError):
        ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG
    if os.getppid() != parent:
        return 1
    pipe = connection.Connection(fd)
    rank = int(os.environ["RANK"])

    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    from rabbitkssd_tpu_torch import cli
    from rabbitkssd_tpu_torch.parallel import multihost

    pipe.send({"ready": rank})
    for k in itertools.count():
        try:
            msg = pipe.recv()
        except EOFError:
            return 1  # the harness went away
        if msg["op"] == "end":
            break
        if k == 0 and dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        p = harness.run_command(cli, msg["argv"], msg["out"], dev)
        print(f"rank {rank} command {k}: {p.span_s:.3f} s", flush=True)
        if p.error:
            print(p.error, flush=True)
        pipe.send({"done": k, "error": p.error})
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    multihost.shutdown()
    pipe.send({"end": rank, "memory_peak": peak,
               "leaked": harness.forbidden_loaded()})
    return 0


# --------------------------------------------------------------------------
# rank 0's side
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _Wait:
    """The answer that ``ranks`` owe, since when, for how long."""

    key: str
    value: object
    ranks: list[int]
    since: float
    limit: float


class Ranks:
    """Ranks 1 .. ``n`` - 1 of a run, started and ready."""

    def __init__(self, n: int, device: str, work: str):
        self.work = work
        self.logs = os.path.join(work, "ranks")
        os.makedirs(self.logs)
        self.cond = threading.Condition()
        # rank -> its answers, each with the host time it came
        self.got: dict[int, list[tuple[float, dict]]] = {0: []}
        self.procs: dict[int, subprocess.Popen] = {}
        self.pipes: dict[int, connection.Connection] = {}
        self.wait: _Wait | None = None
        self.sent = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._watch, daemon=True,
                                        name="kssd_bench ranks")
        try:
            for r in range(1, n):
                self._start(r, device)
        except BaseException:
            self.close()
            raise
        self.wait = _Wait("ready", None, list(self.procs),
                          time.perf_counter(), WARM_S)
        self._thread.start()
        self._collect()

    def _start(self, r: int, device: str) -> None:
        ours, theirs = Pipe()
        env = dict(os.environ, RANK=str(r), LOCAL_RANK=str(r))
        with theirs, open(os.path.join(self.logs, f"rank{r}.log"),
                          "w") as log:
            fd = theirs.fileno()
            self.procs[r] = subprocess.Popen(
                worker_argv() + [str(fd), device, str(os.getpid())],
                stdin=subprocess.DEVNULL, stdout=log,
                stderr=subprocess.STDOUT, env=env, pass_fds=(fd,))
        self.pipes[r] = ours
        self.got[r] = []

    # -- the watching thread --------------------------------------------------
    def _watch(self) -> None:
        while not self._stop.is_set():
            ready = connection.wait(list(self.pipes.values()), timeout=0.2)
            now = time.perf_counter()
            with self.cond:
                for r, pipe in list(self.pipes.items()):
                    if pipe in ready:
                        try:
                            self.got[r].append((now, pipe.recv()))
                        except EOFError:  # _fault sees the worker exit
                            del self.pipes[r]
                self.cond.notify_all()
                reason = self._fault(now)
            if reason and not self._stop.is_set():
                self.abort(reason)

    def _answers(self, w: _Wait) -> dict[int, tuple[float, dict]]:
        """The ranks that have answered ``w``, each with its answer."""
        return {r: a for r in w.ranks for a in self.got[r]
                if w.key in a[1] and w.value in (None, a[1][w.key])}

    def _fault(self, now: float) -> str | None:
        for r, p in self.procs.items():
            if p.poll() is not None and not any(
                    "end" in msg for _, msg in self.got[r]):
                return f"rank {r} exited with code {p.returncode}"
        w = self.wait
        if w is None:
            return None
        ends = {r: t for r, (t, _) in self._answers(w).items()}
        waiting = [r for r in w.ranks if r not in ends]
        if not waiting:
            return None
        what = {"ready": "the start", "end": "the group's end"}.get(
            w.key, f"command {w.value}")
        if now - w.since > w.limit:
            return (f"rank(s) {waiting} gave no answer for {what} in "
                    f"{w.limit:.0f} s")
        if ends and now - min(ends.values()) > ANSWER_S:
            first = min(ends, key=ends.get)
            return (f"rank(s) {waiting} gave no answer for {what} "
                    f"{ANSWER_S:.0f} s after rank {first} ended it")
        return None

    def abort(self, reason: str) -> None:
        """End the run now: kill the workers, print why and their logs'
        tails, remove the run's work directory, exit with code 3.  (Rank
        0 may be inside a collective that would wait for minutes.)"""
        self._kill()
        err = sys.__stderr__
        print(f"kssd_bench: ranks: {reason}", file=err)
        for r in self.procs:
            with contextlib.suppress(OSError):
                with open(os.path.join(self.logs, f"rank{r}.log")) as f:
                    tail = f.read()[-TAIL:]
                print(f"kssd_bench: rank {r}'s output ends:\n{tail}",
                      file=err)
        shutil.rmtree(self.work, ignore_errors=True)
        err.flush()
        os._exit(3)

    # -- rank 0's calls -------------------------------------------------------
    def _begin(self, key: str, value, limit: float, msg: dict) -> None:
        """Owe ``key`` from every rank, and send ``msg`` to the workers.
        A worker that took no message has exited: the thread sees it."""
        with self.cond:
            self.wait = _Wait(key, value, [0, *self.procs],
                              time.perf_counter(), limit)
            pipes = list(self.pipes.values())
        for pipe in pipes:
            with contextlib.suppress(OSError):
                pipe.send(msg)

    def _collect(self, rank0: dict | None = None
                 ) -> dict[int, tuple[float, dict]]:
        """Record rank 0's answer, then wait until every rank has
        answered ``self.wait``; the thread ends the run where one does
        not."""
        with self.cond:
            if rank0 is not None:
                self.got[0].append((time.perf_counter(), rank0))
            while len(got := self._answers(self.wait)) < len(
                    self.wait.ranks):
                self.cond.wait()
            self.wait = None
        return got

    def command(self, cli, argv: list[str], out: str, device
                ) -> harness.Pass:
        """One command on every rank, rank 0 in this process: it starts
        on all together and ends when the last rank has answered."""
        k, self.sent = self.sent, self.sent + 1
        wall0, t0 = time.time(), time.perf_counter()
        self._begin("done", k, WARM_S if k == 0 else ANSWER_S,
                    {"op": "run", "argv": argv, "out": out})
        p = harness.run_command(cli, argv, out, device)
        got = self._collect({"done": k, "error": p.error})
        errors = [f"rank {r}: {msg['error']}" for r, (_, msg)
                  in sorted(got.items()) if msg["error"]]
        t1 = max([p.t1] + [t for t, _ in got.values()])
        return harness.Pass(out, t0, t1, p.lines,
                            "\n".join(errors) or None, wall0)

    def finish(self) -> tuple[int, list[str]]:
        """After the window: every rank leaves the program's process
        group; (the workers' largest card peak, the forbidden modules
        they had loaded, each with its rank)."""
        from rabbitkssd_tpu_torch.parallel import multihost

        self._begin("end", None, ANSWER_S, {"op": "end"})
        multihost.shutdown()
        got = self._collect({"end": 0, "memory_peak": 0, "leaked": []})
        for p in self.procs.values():
            p.wait(timeout=ANSWER_S)
        self._stop.set()
        self._thread.join()
        peak = max(msg["memory_peak"] for _, msg in got.values())
        leaked = [f"{m} (rank {r})" for r, (_, msg) in sorted(got.items())
                  for m in msg["leaked"]]
        return peak, leaked

    def _kill(self) -> None:
        """The one way workers are stopped: killed, waited for, and
        their pipes closed."""
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
        for p in self.procs.values():
            with contextlib.suppress(OSError, subprocess.TimeoutExpired):
                p.wait(timeout=30)
        for pipe in self.pipes.values():
            pipe.close()

    def close(self) -> None:
        """Stop the watching thread and every worker still running."""
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join()
        self._kill()
