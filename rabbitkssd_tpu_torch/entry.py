"""Entry points of the port: the stream step on tiny shapes, and a dry run
of the sharded steps over n ranks.

The counterpart of the repository's ``__graft_entry__.py``, which drives
the JAX package (and stays as it is):

* :func:`entry` returns the sketch stream step (window hash + keep test,
  then compaction + append: the two CUDA kernels on a card) with
  example arguments at the JAX ``entry()`` shapes and seeds;
* :func:`dryrun_multichip` starts n ranks of this machine, as
  ``torchrun --standalone`` would, and runs one data-parallel sketch
  step (:func:`parallel.sharded.make_sharded_sketch_step`) and one
  sharded intersection count in every rank.

Both run on the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from .device import resolve_device
from .engine.sketcher import StreamStep, aligned_halo
from .ops.kmer import pack_words_np, pad_exceptions
from .ops.member import keep_tables
from .params import KssdParams

# the directory that holds the package, for the ranks' PYTHONPATH
_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tiny_inputs(params: KssdParams, n_blocks: int, block: int):
    """(codes int8[n_blocks, block + K - 1], table int32[dim_size]) as the
    JAX dry run makes them: random bases, 5 % of the Ts invalid."""
    rng = np.random.default_rng(7)
    codes = rng.integers(0, 4, size=(n_blocks, block + params.kmer_size - 1),
                         dtype=np.int8)
    codes[codes == 3] = np.where(rng.random((codes == 3).sum()) < 0.05, -1, 3)
    table = rng.permutation(params.dim_size).astype(np.int32)
    return codes, table


def entry(device=None):
    """(fn, args): the sketch stream step at L3K10, 2 blocks x 2^14
    windows, cap 2^12, carry buffers of 2^14, inputs from seed 7.

    ``fn(words, exc, tables, buf_lo, buf_hi, buf_pos, buf_batch, count,
    overflow, batch_idx, valid_upto) -> (buf_lo, buf_hi, buf_pos,
    buf_batch, count, overflow)``, the JAX step's signature.  The JAX
    step donates its carry buffers; ``fn`` appends to copies of them and
    keeps no state, so repeated ``fn(*args)`` calls give equal results.
    ``args`` lie on ``device`` (default: the card).
    """
    dev = resolve_device("cuda" if device is None else device)
    params = KssdParams(half_k=10, half_subk=6, drlevel=3)
    n_blocks, block, cap, buf_cap = 2, 1 << 14, 1 << 12, 1 << 14
    step = StreamStep(params, cap, buf_cap)
    rng = np.random.default_rng(7)
    halo = aligned_halo(params)
    codes = rng.integers(0, 4, size=(n_blocks, block + halo), dtype=np.int8)
    codes[codes == 3] = np.where(rng.random((codes == 3).sum()) < 0.02, -1, 3)
    L = block + halo
    flat_words, _, exc = pack_words_np(codes.ravel())
    words = np.concatenate([flat_words.reshape(n_blocks, L // 16),
                            np.zeros((n_blocks, 2), np.uint32)], axis=1)
    exc = pad_exceptions(exc, codes.size).astype(np.int64)
    table = rng.permutation(params.dim_size).astype(np.int32)

    def fn(words, exc, tables, buf_lo, buf_hi, buf_pos, buf_batch, count,
           overflow, batch_idx, valid_upto):
        bufs = tuple(b.clone() for b in (buf_lo, buf_hi, buf_pos, buf_batch))
        count, overflow = step(words, exc, tables, bufs, count, overflow,
                               batch_idx, valid_upto)
        return (*bufs, count, overflow)

    z = torch.zeros(buf_cap, dtype=torch.int32, device=dev)
    args = (torch.from_numpy(words.view(np.int32)).to(dev),
            torch.from_numpy(exc).to(dev),
            keep_tables(table, params.dim_end, dev), z, z.clone(), z.clone(),
            z.clone(), torch.zeros((), dtype=torch.int32, device=dev),
            torch.zeros((), dtype=torch.bool, device=dev), 0,
            n_blocks * block)
    return fn, args


# --------------------------------------------------------------------------
# the dry run over n ranks
# --------------------------------------------------------------------------

def dryrun_multichip(n: int, device=None, timeout: float = 600.0
                     ) -> list[dict]:
    """One sharded sketch step and one sharded count over ``n`` ranks of
    this machine (tiny shapes); returns each rank's report, in rank
    order, and raises if a rank fails or the deadline passes.

    On the card (the default) a machine with >= n cards gives each rank
    its own (``cpu:gloo,cuda:nccl``); with fewer, the n ranks share
    cuda:0 in a gloo group (NCCL refuses two ranks on one card).
    ``device="cpu"`` runs n gloo CPU ranks.  Every child is killed at
    the deadline.
    """
    name = "cuda" if device is None else str(device)
    dev = resolve_device(name)  # raises without a card
    nccl = dev.type == "cuda" and torch.cuda.device_count() >= n
    if dev.type == "cuda":  # each rank's own card, or all on card 0
        name = "cuda" if nccl else "cuda:0"
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, WORLD_SIZE=str(n), LOCAL_WORLD_SIZE=str(n),
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
                   p for p in (_ROOT, os.environ.get("PYTHONPATH")) if p))
    argv = [sys.executable, "-m", "rabbitkssd_tpu_torch.entry", "--world",
            str(n), "--device", name] + (["--nccl"] if nccl else [])
    procs = []
    with tempfile.TemporaryDirectory(prefix="kssd_dryrun_") as logdir:
        try:
            for r in range(n):
                with open(os.path.join(logdir, f"rank{r}.out"), "w") as out, \
                        open(os.path.join(logdir, f"rank{r}.err"), "w") as err:
                    procs.append(subprocess.Popen(
                        argv, stdout=out, stderr=err,
                        env=dict(env, RANK=str(r), LOCAL_RANK=str(r))))
            deadline = time.monotonic() + timeout
            for p in procs:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            raise RuntimeError(
                f"dryrun: {n} ranks did not finish in {timeout} s") from None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        reports = []
        for r, p in enumerate(procs):
            with open(os.path.join(logdir, f"rank{r}.out")) as f:
                out = f.read()
            if p.returncode != 0:
                with open(os.path.join(logdir, f"rank{r}.err")) as f:
                    raise RuntimeError(f"dryrun: rank {r} exited "
                                       f"{p.returncode}:\n{f.read()[-4000:]}")
            reports.append(json.loads(out.strip().splitlines()[-1]))
    return reports


def _require(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"entry: {msg}")


def _dryrun_rank(n: int, device: str, nccl: bool) -> dict:
    """One rank of :func:`dryrun_multichip`: the JAX dry run's shapes and
    checks (``__graft_entry__.py``)."""
    from .parallel.multihost import init_multihost, rank, shutdown
    from .parallel.sharded import (make_mesh, make_sharded_sketch_step,
                                   sharded_common_counts)

    _require(init_multihost(cuda=nccl) or n == 1, "no process group")
    dev = resolve_device(device)
    mesh = make_mesh(n)
    n_shards = mesh.size
    params = KssdParams(half_k=8, half_subk=4, drlevel=1)

    # data-parallel sketch over tape blocks
    n_blocks, block, cap = 2, 2048, 2048
    codes, table = _tiny_inputs(params, n_shards * n_blocks, block)
    step = make_sharded_sketch_step(params, mesh, n_blocks, block, cap)
    h_lo, h_hi, pos, total = step(codes, torch.from_numpy(table).to(dev))
    _require(h_lo.shape == h_hi.shape == pos.shape == (n_shards, cap),
             f"sketch outputs of shape {h_lo.shape}")
    _require(total.shape == (n_shards,), f"totals of shape {total.shape}")
    _require(bool((total >= 0).all()), f"totals {total}")

    # vocabulary-sharded distance (the vp reduction)
    rng = np.random.default_rng(11)
    hashes = [np.unique(rng.integers(0, 4096, size=300).astype(np.uint32))
              for _ in range(2 * n_shards + 1)]
    common = sharded_common_counts(hashes, None, mesh, dev)
    i, j = 0, len(hashes) - 1
    want = np.intersect1d(hashes[i], hashes[j]).size
    _require(common[i, j] == want, f"common[{i}, {j}] {common[i, j]} != "
             f"{want}")
    _require(common.shape == (len(hashes), len(hashes)),
             f"counts of shape {common.shape}")
    report = {"rank": rank(), "device": str(dev), "nccl": nccl,
              "mesh": [mesh.dp, mesh.vp], "totals": total.tolist()}
    shutdown()
    return report


def main(argv: list[str] | None = None) -> int:
    """One rank of :func:`dryrun_multichip`, which starts each as
    ``python -m rabbitkssd_tpu_torch.entry --world N --device D [--nccl]``
    (its rank in ``RANK``) and reads its report, the last line of its
    standard output."""
    ap = argparse.ArgumentParser(prog="python -m rabbitkssd_tpu_torch.entry")
    ap.add_argument("--world", type=int, required=True, metavar="N",
                    help="ranks of the dry run")
    ap.add_argument("--device", required=True)
    ap.add_argument("--nccl", action="store_true")
    args = ap.parse_args(argv)
    print(json.dumps(_dryrun_rank(args.world, args.device, args.nccl)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
