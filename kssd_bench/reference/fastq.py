"""FASTQ read sets as one base-code tape a file, and their Kssd sketch,
worked out from the definitions in plain PyTorch.

A record is four lines: ``@`` and a name, the bases, ``+`` (a name may
follow), and one quality byte a base (a ``\\r`` before a line end is
not part of the line).  The tape holds each read's bases in file order,
one -1 between two reads: A, C, G, T (either case) code 0-3, every
other letter -1, and so does every base whose quality byte is below
``least_qual`` (the byte itself is compared, as the RabbitKSSD binary
does, sketch.cpp:795: Phred 20 in Phred+33 is 53).  A -1 breaks every
window over it, so hashing the tape (``kssd.record_hashes``) hashes
each read alone.  A sample's sketch is the sorted set of the sampled
hashes that occur at least ``least_num_kmer`` times in its file
(sketch.cpp:240-314).
"""

from __future__ import annotations

import numpy as np
import torch

from .kssd import KssdSizes, record_hashes

_LUT = np.full(256, -1, np.int8)
for _i, _ch in enumerate(b"ACGT"):
    _LUT[_ch] = _i
    _LUT[_ch + 32] = _i  # lower case
# bases put on the tape at once (each takes ~40 bytes of temporaries)
PIECE = 1 << 25


def _records(raw: np.ndarray) -> tuple[np.ndarray, ...]:
    """(first byte, end) of each record's bases and its qualities' first
    byte, checked against the four-line definition."""
    nl = np.flatnonzero(raw == ord("\n"))
    if raw.size and raw[-1] != ord("\n"):
        nl = np.append(nl, raw.size)
    starts = np.concatenate([[0], nl[:-1] + 1])
    cr = (nl > starts) & (raw[np.maximum(nl - 1, 0)] == ord("\r"))
    ends = nl - cr.astype(np.int64)
    if starts.size % 4:
        raise ValueError(f"{starts.size} lines: not four a record")
    head, seq, plus, qual = (starts[k::4] for k in range(4))
    seq_end, qual_end = ends[1::4], ends[3::4]
    if not ((raw[head] == ord("@")).all() and (raw[plus] == ord("+")).all()
            and np.array_equal(seq_end - seq, qual_end - qual)):
        raise ValueError("not a FASTQ file of four-line records")
    return seq, seq_end, qual


def read_pieces(path: str, least_qual: int, device: torch.device):
    """The file's tape in pieces of whole reads (int8 on ``device``);
    joined with one -1 between pieces they make the whole tape."""
    raw = np.fromfile(path, np.uint8)
    seq, seq_end, qual = _records(raw)
    lens = seq_end - seq
    lut = torch.from_numpy(_LUT).to(device)
    r0 = 0
    while r0 < lens.size:
        r1 = r0 + max(1, int(np.searchsorted(np.cumsum(lens[r0:]), PIECE)))
        r1 = min(r1, lens.size)
        lo, hi = int(seq[r0]), int(qual[r1 - 1] + lens[r1 - 1])
        data = torch.from_numpy(raw[lo:hi]).to(device)
        ln = torch.from_numpy(lens[r0:r1]).to(device)
        first = torch.from_numpy(seq[r0:r1] - lo).to(device)
        to_qual = torch.from_numpy(qual[r0:r1] - seq[r0:r1]).to(device)
        read = torch.repeat_interleave(torch.arange(r1 - r0, device=device),
                                       ln)
        t = (torch.arange(read.numel(), device=device)
             - (torch.cumsum(ln, 0) - ln)[read])
        src = first[read] + t
        codes = lut[data[src].long()]
        codes[data[src + to_qual[read]] < least_qual] = -1
        # each read's place on the tape: after the reads and the -1s
        # before it
        at = (torch.cumsum(ln + 1, 0) - (ln + 1))[read] + t
        tape = torch.full((int(ln.sum()) + r1 - r0 - 1,), -1,
                          dtype=torch.int8, device=device)
        tape[at] = codes
        yield tape
        r0 = r1


def read_tape(path: str, least_qual: int, device: torch.device
              ) -> torch.Tensor:
    """The whole tape of one FASTQ file."""
    sep = torch.full((1,), -1, dtype=torch.int8, device=device)
    parts = []
    for piece in read_pieces(path, least_qual, device):
        parts += [sep, piece] if parts else [piece]
    return (torch.cat(parts) if parts
            else torch.empty(0, dtype=torch.int8, device=device))


def sample_sketch(path: str, sizes: KssdSizes, table: torch.Tensor,
                  least_qual: int, least_num_kmer: int,
                  strand: str = "canonical") -> tuple[np.ndarray, int]:
    """(sorted hashes seen at least ``least_num_kmer`` times, survivors
    with repeats) of one FASTQ file."""
    parts = [record_hashes(tape, sizes, table, strand)
             for tape in read_pieces(path, least_qual, table.device)]
    allh = (torch.cat(parts) if parts
            else torch.empty(0, dtype=torch.int64, device=table.device))
    vals, counts = torch.unique(allh, return_counts=True)
    vals = vals[counts >= least_num_kmer]
    dt = np.uint64 if sizes.use64 else np.uint32
    return vals.cpu().numpy().astype(dt), int(allh.numel())
