"""FASTA records as base codes, read straight from the file.

A record is a ``>`` header line and the lines up to the next header;
its sequence is those lines' bytes without line ends.  A, C, G, T
(either case) code 0-3; every other letter codes -1.
"""

from __future__ import annotations

import numpy as np
import torch

_SKIP = -2
_LUT = np.full(256, -1, np.int8)
for _i, _ch in enumerate(b"ACGT"):
    _LUT[_ch] = _i
    _LUT[_ch + 32] = _i  # lower case
_LUT[ord("\n")] = _LUT[ord("\r")] = _SKIP
# bytes converted at once on the device
_PIECE = 1 << 27


def read_records(path: str, device: torch.device) -> list[torch.Tensor]:
    """Each record of the FASTA file at ``path`` as int8 codes on
    ``device``."""
    raw = np.fromfile(path, np.uint8)
    lut = torch.from_numpy(_LUT).to(device)
    nl = np.flatnonzero(raw == ord("\n"))
    line_starts = np.concatenate([[0], nl + 1])
    line_starts = line_starts[line_starts < raw.size]
    heads = line_starts[raw[line_starts] == ord(">")]
    records = []
    for k, h in enumerate(heads):
        at = np.searchsorted(nl, h)
        end_of_head = nl[at] + 1 if at < nl.size else raw.size
        stop = heads[k + 1] if k + 1 < len(heads) else raw.size
        pieces = []
        for lo in range(int(end_of_head), int(stop), _PIECE):
            hi = min(int(stop), lo + _PIECE)
            b = torch.from_numpy(raw[lo:hi]).to(device).to(torch.int32)
            c = lut[b]
            pieces.append(c[c != _SKIP])
        records.append(torch.cat(pieces) if pieces
                       else torch.empty(0, dtype=torch.int8, device=device))
    return records
