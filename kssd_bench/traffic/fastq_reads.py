"""Illumina paired-end read sets, one FASTQ file a sample.

Isolates of one species: ``n_samples`` mutated copies of a few random
ancestors (each isolate's SNP rate 10^U(snp_log10)), their lengths
spread evenly over ``genome_len`` [lo, hi].  Each isolate is sampled at
``coverage`` as pairs of ``read_len`` mates: a fragment of U(fragment)
bases from a uniform start, read from either strand, mate 1 from one
end and mate 2 as the reverse complement from the other.  Mates are
interleaved in one file of four-line records (``@r<pair>/<mate>``, the
bases, ``+``, the qualities), so each file is one sample.

Qualities are drawn per base from the Phred bins ``quality_bins`` with
the shares ``bin_share``; the first two bins (the low ones) are
weighted by 0.5 + t / (read_len - 1) at read position t, so they lean
toward the 3' end while keeping their shares.  A base turns into one of
the other three with probability 10^(-Q/10) of its bin; a base in the
first bin is written as ``N``.  Qualities are Phred+33 letters.

params: n_samples, genome_len [lo, hi], ancestors, snp_log10 [lo, hi],
coverage, read_len, fragment [lo, hi], quality_bins [4 Phred values],
bin_share [4 shares].
"""

from __future__ import annotations

import os

import torch

from . import fasta_writer

# read pairs drawn and written at once
PIECE = 1 << 17
NAME_DIGITS = 9


def _digits(k: torch.Tensor) -> torch.Tensor:
    """Pair numbers as NAME_DIGITS ASCII digits, [n, NAME_DIGITS]."""
    scale = 10 ** torch.arange(NAME_DIGITS - 1, -1, -1, device=k.device)
    return (k[:, None] // scale % 10 + ord("0")).to(torch.uint8)


def _const(text: bytes, n: int, device) -> torch.Tensor:
    return torch.tensor(list(text), dtype=torch.uint8,
                        device=device).expand(n, len(text))


def read_pairs(seq: torch.Tensor, first: int, n: int, p: dict,
               g: torch.Generator) -> torch.Tensor:
    """Records of the ``n`` read pairs numbered from ``first`` of the
    isolate ``seq`` (base codes 0..3), as one uint8 row a read:
    [2 n, record bytes], mate 1 then mate 2 of each pair."""
    dev = seq.device
    L = p["read_len"]
    flo, fhi = p["fragment"]
    frag = torch.randint(flo, fhi + 1, (n,), generator=g, device=dev)
    start = (torch.rand(n, generator=g, device=dev, dtype=torch.float64)
             * (seq.numel() - frag + 1)).long()
    m1_fw = torch.randint(0, 2, (n,), generator=g, device=dev).bool()
    # a fragment's strand gives mate 1's; mate 2 reads the other strand
    fw = torch.stack([m1_fw, ~m1_fw], 1).reshape(-1)
    start2 = start.repeat_interleave(2)
    end2 = (start + frag - 1).repeat_interleave(2)
    t = torch.arange(L, device=dev)
    pos = torch.where(fw[:, None], start2[:, None] + t, end2[:, None] - t)
    codes = seq[pos]
    codes = torch.where(fw[:, None], codes, 3 - codes)

    share = torch.tensor(p["bin_share"], dtype=torch.float64, device=dev)
    lean = 0.5 + t.double() / max(L - 1, 1)
    cut0 = share[0] * lean
    cut1 = cut0 + share[1] * lean
    cut2 = cut1 + share[2]
    u = torch.rand((2 * n, L), generator=g, device=dev, dtype=torch.float64)
    qbin = (u >= cut0).long() + (u >= cut1).long() + (u >= cut2).long()
    phred = torch.tensor(p["quality_bins"], device=dev)
    p_err = 10.0 ** (-phred.double() / 10)
    err = torch.rand((2 * n, L), generator=g, device=dev,
                     dtype=torch.float64) < p_err[qbin]
    shift = torch.randint(1, 4, (2 * n, L), generator=g, device=dev,
                          dtype=torch.uint8)
    codes = torch.where(err, (codes + shift) % 4, codes)
    letters = fasta_writer.ascii_codes(codes)
    letters[qbin == 0] = ord("N")
    quals = (phred[qbin] + 33).to(torch.uint8)

    pair = torch.arange(first, first + n, device=dev).repeat_interleave(2)
    mate = (torch.arange(2 * n, device=dev) % 2 + ord("1")).to(torch.uint8)
    return torch.cat([_const(b"@r", 2 * n, dev), _digits(pair),
                      _const(b"/", 2 * n, dev), mate[:, None],
                      _const(b"\n", 2 * n, dev), letters,
                      _const(b"\n+\n", 2 * n, dev), quals,
                      _const(b"\n", 2 * n, dev)], 1)


def make(root: str, p: dict, seed: int, device: torch.device) -> dict:
    g = fasta_writer.generator(seed, device)
    n, (lo, hi) = p["n_samples"], p["genome_len"]
    anc = torch.randint(0, 4, (p["ancestors"], hi), generator=g,
                        device=device, dtype=torch.uint8)
    files, bases = [], 0
    for i in range(n):
        glen = int(lo + (hi - lo) * i / max(n - 1, 1))
        seq = anc[i % p["ancestors"], :glen].clone()
        u = float(torch.rand(1, generator=g, device=device))
        a, b = p["snp_log10"]
        fasta_writer.mutate(seq, int(glen * 10 ** (a + (b - a) * u)), g)
        pairs = p["coverage"] * glen // (2 * p["read_len"])
        path = os.path.join(root, f"s{i:03d}.fq")
        with open(path, "wb") as f:
            for first in range(0, pairs, PIECE):
                rows = read_pairs(seq, first, min(PIECE, pairs - first), p,
                                  g)
                f.write(rows.cpu().numpy().tobytes())
        files.append(path)
        bases += 2 * pairs * p["read_len"]
    list_path = os.path.join(root, "reads.list")
    with open(list_path, "w") as f:
        f.write("\n".join(files) + "\n")
    return {"paths": {"list": list_path},
            "work": {"bases": bases, "genomes": n}}
