"""Device selection: an explicit name, never a silent fallback."""

from __future__ import annotations

import torch

from .parallel.multihost import distributed_env, local_rank


def resolve_device(name: str | torch.device) -> torch.device:
    """``"cuda"`` (or ``"cuda:N"``) requires a visible card and raises
    otherwise; ``"cpu"`` runs every kernel's plain PyTorch version.

    A bare ``"cuda"`` is the current card in one process, and
    ``cuda:LOCAL_RANK`` in each rank of a multi-rank run (one card per
    rank); an index that is not visible raises."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} requested but torch.cuda.is_available()"
                " is False")
        if dev.index is None:
            dev = torch.device("cuda", local_rank() if distributed_env()
                               else torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {str(dev)!r} requested but only "
                f"{torch.cuda.device_count()} card(s) are visible")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {str(name)!r} (cuda or cpu)")
    return dev
