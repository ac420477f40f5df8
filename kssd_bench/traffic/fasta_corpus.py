"""Bacterial-size genomes, one FASTA file each.

Frozen copy of the recipe of ``chip_smoke.py:make_corpus`` (commit
251baa72153c12dfd30056862f5a431398347f0f), itself ``bench.py``'s, with
``--seed`` in place of its fixed seed and the draws made on the device:
mutated copies of a few random ancestors, each genome's SNP rate
10^U(snp_log10), a few runs of N, lengths spread evenly over
``length_spread`` x ``genome_len`` (all distinct, multiples of 100, as
the reference orders genomes by file size), 100 bases a line.

params: n_genomes, genome_len, ancestors, snp_log10 [lo, hi], n_runs,
n_run_max, length_spread [lo, hi].
"""

from __future__ import annotations

import os

import torch

from . import fasta_writer


def make(root: str, p: dict, seed: int, device: torch.device) -> dict:
    g = fasta_writer.generator(seed, device)
    n, glen0 = p["n_genomes"], p["genome_len"]
    lo, hi = p["length_spread"]
    anc = torch.randint(0, 4, (p["ancestors"], int(hi * glen0) + 128),
                        generator=g, device=device, dtype=torch.uint8)
    files, total = [], 0
    for i in range(n):
        glen = int(glen0 * (lo + (hi - lo) * i / max(n - 1, 1)))
        glen -= glen % 100
        seq = anc[i % p["ancestors"], :glen].clone()
        u = float(torch.rand(1, generator=g, device=device))
        a, b = p["snp_log10"]
        fasta_writer.mutate(seq, int(glen * 10 ** (a + (b - a) * u)), g)
        text = fasta_writer.ascii_codes(seq)
        fasta_writer.n_runs(text, p["n_runs"], 1, p["n_run_max"], g)
        path = os.path.join(root, f"g{i:05d}.fna")
        with open(path, "wb") as f:
            fasta_writer.write_record(f, f"g{i} synthetic", text)
        files.append(path)
        total += glen
    list_path = os.path.join(root, "genomes.list")
    with open(list_path, "w") as f:
        f.write("\n".join(files) + "\n")
    return {"paths": {"list": list_path},
            "work": {"bases": total, "genomes": n}}
