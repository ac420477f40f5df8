"""Shared pieces of the FASTA generators: draws on the device from the
seed, and records written 100 bases a line."""

from __future__ import annotations

import torch

_ALPHABET = {False: b"ACGTN", True: b"acgtn"}


def generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed % (1 << 63))
    return g


def mutate(seq: torch.Tensor, n_mut: int, g: torch.Generator) -> None:
    """Change the base at ``n_mut`` drawn positions (repeats drawn once)
    to one of the other three, in place."""
    if n_mut <= 0:
        return
    pos = torch.unique(torch.randint(0, seq.numel(), (n_mut,), generator=g,
                                     device=seq.device))
    delta = torch.randint(1, 4, (pos.numel(),), generator=g,
                          device=seq.device, dtype=torch.uint8)
    seq[pos] = (seq[pos] + delta) % 4


def ascii_codes(seq: torch.Tensor, lower: bool = False) -> torch.Tensor:
    """Base codes 0..4 as letters (uint8)."""
    lut = torch.tensor(list(_ALPHABET[lower]), dtype=torch.uint8,
                       device=seq.device)
    return lut[seq.long()]


def n_runs(text: torch.Tensor, count: int, lo: int, hi: int,
           g: torch.Generator) -> None:
    """Overwrite ``count`` runs of lo..hi-1 letters with N, in place."""
    for _ in range(count):
        st = int(torch.randint(0, text.numel() - hi - 20, (1,), generator=g,
                               device=text.device))
        ln = int(torch.randint(lo, hi, (1,), generator=g,
                               device=text.device))
        text[st: st + ln] = ord("N")


def write_record(f, name: str, text: torch.Tensor,
                 rows_a_piece: int = 1 << 22) -> None:
    """One record: its header, then ``text`` in lines of 100 letters."""
    f.write(b">" + name.encode() + b"\n")
    full = text.numel() - text.numel() % 100
    for lo in range(0, full, 100 * rows_a_piece):
        hi = min(full, lo + 100 * rows_a_piece)
        rows = text[lo:hi].view(-1, 100)
        out = torch.full((rows.shape[0], 101), ord("\n"), dtype=torch.uint8,
                         device=text.device)
        out[:, :100] = rows
        f.write(out.cpu().numpy().tobytes())
    if full < text.numel():
        f.write(text[full:].cpu().numpy().tobytes() + b"\n")
