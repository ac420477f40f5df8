"""Mammal-size single-record genomes and a file of contigs.

Frozen copy of the recipe of ``chip_smoke.py:make_config4_corpus``
(commit 251baa72153c12dfd30056862f5a431398347f0f), itself
``scripts/config4_run.py``'s, with ``--seed`` in place of its fixed
seed and the draws made on the device: ``large`` single-record genomes
(each its own file, copies of one random ancestor, ``large[g]`` bases,
``snp_rate`` of bases changed, ``n_runs`` runs of N) and one file of
``n_contigs`` random contigs of ``contig_len`` bases, every
``lower_every``-th one in lower case.  Files over the program's 1 GiB
stream threshold go through its chunked reader.

params: large [bases, ...], snp_rate, n_runs, n_run_max, n_contigs,
contig_len, lower_every.
"""

from __future__ import annotations

import os

import torch

from . import fasta_writer


def make(root: str, p: dict, seed: int, device: torch.device) -> dict:
    g = fasta_writer.generator(seed, device)
    anc = torch.randint(0, 4, (max(p["large"]) + 64,), generator=g,
                        device=device, dtype=torch.uint8)
    files, total = [], 0
    for i, bases in enumerate(p["large"]):
        seq = anc[:bases].clone()
        fasta_writer.mutate(seq, int(bases * p["snp_rate"]), g)
        text = fasta_writer.ascii_codes(seq)
        del seq
        fasta_writer.n_runs(text, p["n_runs"], 1, p["n_run_max"], g)
        path = os.path.join(root, f"large{i}.fna")
        with open(path, "wb") as f:
            fasta_writer.write_record(f, f"chr{i}", text)
        del text
        files.append(path)
        total += bases
    del anc
    path = os.path.join(root, "contigs.fna")
    with open(path, "wb") as f:
        for r in range(p["n_contigs"]):
            seq = torch.randint(0, 4, (p["contig_len"],), generator=g,
                                device=device, dtype=torch.uint8)
            text = fasta_writer.ascii_codes(seq, r % p["lower_every"] == 0)
            fasta_writer.write_record(f, f"contig{r}", text)
            total += p["contig_len"]
    files.append(path)
    list_path = os.path.join(root, "genomes.list")
    with open(list_path, "w") as f:
        f.write("\n".join(files) + "\n")
    return {"paths": {"list": list_path},
            "work": {"bases": total, "genomes": len(files)}}
