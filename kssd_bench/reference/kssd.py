"""Kssd sketches worked out from their definition, in plain PyTorch.

A k-mer of K = 2 * half_k bases is coded 2 bits a base (A 0, C 1, G 2,
T 3, either case); any other letter breaks every window over it, and no
window spans two records.  The window ending at base i has the forward
code sum_t c[i-t] << 2t and the reverse-complement code
sum_t (3 - c[i-t]) << 2(K-1-t); the canonical code is the smaller.  Its
middle 2 * half_subk bases are the "dim"; the window survives when the
shuffle table ranks that dim below 16 ** (half_subk - drlevel), and its
hash is the outer bases recomposed around that rank
(RabbitKSSD common.cpp:35-78, sketch.cpp:491-532).  A genome's sketch
is the sorted set of its survivors' hashes over all its records.

``strand`` exists for the correctness control alone:
``strand="forward"`` drops the canonical choice.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .fasta import read_records

# windows hashed at once (a chunk's int64 temporaries: ~6 x 8 bytes each)
CHUNK = 1 << 25


@dataclasses.dataclass(frozen=True)
class KssdSizes:
    half_k: int
    half_subk: int
    drlevel: int

    def __post_init__(self):
        if not (self.drlevel + 3 <= self.half_subk <= self.half_k <= 15):
            raise ValueError(f"unsupported sizes {self}")

    @property
    def kmer(self) -> int:
        return 2 * self.half_k

    @property
    def use64(self) -> bool:
        return self.half_k - self.drlevel > 8

    @property
    def dim_end(self) -> int:
        return 1 << (4 * (self.half_subk - self.drlevel))

    def masks(self) -> dict:
        full = (1 << (4 * self.half_k)) - 1
        outer = self.half_k - self.half_subk
        middle = (full >> (4 * outer)) << (2 * outer)
        rest = full ^ middle
        low = rest & (full >> (2 * (self.half_k + self.half_subk)))
        return {"middle": middle, "middle_shift": 2 * outer,
                "high": rest ^ low, "low": low,
                "low_shift": 4 * self.half_subk,
                "drop": 4 * self.drlevel}


def record_hashes(codes: torch.Tensor, sizes: KssdSizes,
                  table: torch.Tensor, strand: str = "canonical"
                  ) -> torch.Tensor:
    """Every survivor's hash (int64, with repeats) of one record's codes
    (int8 on the device: 0..3, -1 for a letter that breaks windows)."""
    K = sizes.kmer
    m = sizes.masks()
    out = []
    n = codes.numel()
    for lo in range(0, max(n - K + 1, 0), CHUNK):
        hi = min(n, lo + CHUNK + K - 1)
        c = codes[lo:hi].to(torch.int64)
        w = hi - lo - K + 1  # windows of this chunk
        bad = (c < 0).to(torch.int32)
        cb = torch.cumsum(bad, 0)
        nbad = cb[K - 1:].clone()
        nbad[1:] -= cb[: w - 1]
        c = c.clamp_min(0)
        fwd = torch.zeros(w, dtype=torch.int64, device=c.device)
        rev = torch.zeros_like(fwd)
        for t in range(K):
            base = c[K - 1 - t: K - 1 - t + w]
            fwd |= base << (2 * t)
            rev |= (3 - base) << (2 * (K - 1 - t))
        uni = fwd if strand == "forward" else torch.minimum(fwd, rev)
        del fwd, rev
        dim = (uni & m["middle"]) >> m["middle_shift"]
        rank = table[dim]
        keep = (nbad == 0) & (rank < sizes.dim_end)
        u, r = uni[keep], rank[keep]
        h = (((u & m["high"]) | ((u & m["low"]) << m["low_shift"]))
             >> m["drop"]) | r
        out.append(h)
    if not out:
        return torch.empty(0, dtype=torch.int64, device=codes.device)
    return torch.cat(out)


def genome_sketch(path: str, sizes: KssdSizes, table: torch.Tensor,
                  strand: str = "canonical") -> tuple[np.ndarray, int]:
    """(sorted unique hashes, survivors with repeats) of one genome file."""
    parts = [record_hashes(codes, sizes, table, strand)
             for codes in read_records(path, table.device)]
    allh = torch.cat(parts) if parts else torch.empty(0, dtype=torch.int64)
    dt = np.uint64 if sizes.use64 else np.uint32
    return torch.unique(allh).cpu().numpy().astype(dt), int(allh.numel())
