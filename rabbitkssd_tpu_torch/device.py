"""Device selection: an explicit name, never a silent fallback."""

from __future__ import annotations

import torch


def resolve_device(name: str | torch.device) -> torch.device:
    """``"cuda"`` (or ``"cuda:N"``) requires a visible card and raises
    otherwise; ``"cpu"`` runs every kernel's plain PyTorch version."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(name)!r} requested but torch.cuda.is_available()"
                " is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type != "cpu":
        raise ValueError(f"unsupported device {str(name)!r} (cuda or cpu)")
    return dev
