"""Multi-process runtime: the torch.distributed process group.

Port of ``rabbitkssd_tpu/parallel/multihost.py``.  The JAX package runs
one process per host over all of its chips; the port runs one process
(a *rank*) per device, launched by ``torchrun`` or by anything that sets
the same environment: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``.  So a JAX
*process* is a torch *node* and a JAX *device* is a torch *rank*.  Every
rank runs the same program and computes the replicated result.

Host data (pair shards, survivor chunks, final gathers) travels as CPU
tensors over gloo; only device partial counts travel as CUDA tensors,
over NCCL, in a ``cpu:gloo,cuda:nccl`` process group.
"""

from __future__ import annotations

import datetime
import math
import os

import torch
import torch.distributed as dist

# a rank that dies fails the others' next collective within this time
# instead of leaving them waiting for ever
TIMEOUT = datetime.timedelta(minutes=10)


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, default))


def distributed_env() -> bool:
    """Whether this process is one rank of several (``WORLD_SIZE`` > 1)."""
    return _env_int("WORLD_SIZE", 1) > 1


def init_multihost(cuda: bool = False) -> bool:
    """Start the default process group from the launcher's environment.

    A no-op that returns False when ``WORLD_SIZE`` is unset or 1.
    Idempotent: a process that enters the CLI several times keeps the
    group of its first entry.  ``cuda``: the ranks hold CUDA devices, one
    each; the rank binds to ``cuda:LOCAL_RANK`` and CUDA tensors travel
    over NCCL.  Otherwise the group is gloo alone: CPU ranks, or several
    ranks sharing one card, which NCCL refuses.  A failed init raises.
    """
    if not distributed_env():
        return False
    if dist.is_initialized():
        return True
    backend = "gloo"
    if cuda:
        torch.cuda.set_device(local_rank())
        backend = "cpu:gloo,cuda:nccl"
    dist.init_process_group(backend, init_method="env://", timeout=TIMEOUT)
    return True


def rank() -> int:
    """This rank's index in the default group (0 without a group)."""
    return dist.get_rank() if dist.is_initialized() else 0


def world() -> int:
    """Ranks in the default group (1 without a group)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_rank() -> int:
    """This rank's index on its node (``LOCAL_RANK``; 0 for one process)."""
    return _env_int("LOCAL_RANK", 0) if distributed_env() else 0


def local_world() -> int:
    """Ranks on this node (``LOCAL_WORLD_SIZE``; 1 for one process)."""
    if not distributed_env():
        return 1
    return _env_int("LOCAL_WORLD_SIZE", _env_int("WORLD_SIZE", 1))


def thread_budget(threads: int = 0) -> int:
    """The host threads of this rank: ``threads`` (``-t``) if given, else
    its share of the node's cores (every rank of a node reads the whole
    input)."""
    return threads or max(1, (os.cpu_count() or 1) // local_world())


def is_writer() -> bool:
    """Whether this rank writes files: local rank 0 of each node.  The
    ranks of one node share its filesystem, so one write per node."""
    return local_rank() == 0


def barrier() -> None:
    """Wait for every rank (no-op without a group).  A CPU all-reduce, so
    it rides gloo even in a group that also holds NCCL."""
    if world() > 1:
        dist.all_reduce(torch.zeros(1))


def subgroups(rank_lists: tuple[tuple[int, ...], ...]) -> list:
    """One process group per tuple of ranks, created on first request
    and kept until :func:`shutdown` (NCCL builds each communicator
    once).  The first request is collective: torch's ``dist.new_group``
    must be called by every rank for every group in the same order."""
    if rank_lists not in _SUBGROUPS:
        _SUBGROUPS[rank_lists] = [dist.new_group(list(r))
                                  for r in rank_lists]
    return _SUBGROUPS[rank_lists]


# the subgroups of the live default group
_SUBGROUPS: dict[tuple, list] = {}


def shutdown() -> None:
    """Leave the process group before the process exits: wait for every
    rank, then tear the groups down.  A rank that exits with its gloo
    group alive can abort in the group's teardown while a peer closes
    its sockets."""
    if dist.is_initialized():
        barrier()
        _SUBGROUPS.clear()
        dist.destroy_process_group()


def global_mesh(n: int | None = None, local: int | None = None):
    """The (dp, vp) mesh over ``n`` ranks, ``local`` per node (default:
    this run's world and node): vp = gcd(n, local) keeps each vp group
    (the distance reduction) within one node; dp spans the nodes."""
    from .sharded import Mesh

    n = world() if n is None else n
    vp = math.gcd(n, local_world() if local is None else local)
    return Mesh(n // vp, vp)
