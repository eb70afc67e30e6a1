"""Synthetic spliced genomes, written once per checkout from the
configuration's own seed.

``synth_chromosome`` and ``write_synth_genome`` are frozen copies of the
program's ``testing/synth.py`` (the same bytes for the same seed): random
chromosomes with 3-exon genes (150 bp exons, 300 bp introns) on random
strands at chr21-like density.  ``ensure`` writes the FASTA, the GTF and
a sidecar of each chromosome's sequence offset in the FASTA (read by the
read generators with ``os.pread``), and reuses them when the sidecar
names the same genome.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

import numpy as np

_ALPHA = np.frombuffer(b"ACGT", np.uint8)


def synth_chromosome(length: int, rng: np.random.Generator, name: str,
                     gene_every: int = 22_000) -> Tuple[bytes, List[str]]:
    """One random chromosome and its GTF lines."""
    seq = _ALPHA[rng.integers(0, 4, length)].tobytes()
    gtf: List[str] = []
    pos = 500
    gi = 0
    while pos + 1500 < length:
        strand = "+" if rng.random() < 0.5 else "-"
        gid = f"{name}G{gi:05d}"
        attrs = (f'gene_id "{gid}"; transcript_id "{gid}T"; '
                 f'gene_name "{gid}n";')
        for s, e in ((pos, pos + 150), (pos + 450, pos + 600),
                     (pos + 900, pos + 1050)):
            gtf.append(f"{name}\tsyn\texon\t{s + 1}\t{e}\t.\t{strand}\t.\t{attrs}")
        gi += 1
        pos += int(rng.integers(gene_every * 3 // 4, gene_every * 5 // 4))
    return seq, gtf


def write_synth_genome(out_dir: str, total_bp: int, seed: int, n_chroms: int,
                       basename: str, gene_every: int) -> Dict[str, object]:
    """Write ``basename``.fasta and .gtf (``total_bp`` over ``n_chroms``
    chromosomes, one sequence line each); -> the sidecar: paths and, per
    chromosome, its name, sequence offset in the FASTA and length."""
    os.makedirs(out_dir, exist_ok=True)
    fasta = os.path.join(out_dir, f"{basename}.fasta")
    gtf_path = os.path.join(out_dir, f"{basename}.gtf")
    rng = np.random.default_rng(seed)
    per = total_bp // n_chroms
    chroms = []
    with open(fasta, "wb") as ff, open(gtf_path, "w") as gf:
        for c in range(n_chroms):
            name = f"{basename}{c + 1}"
            seq, gtf = synth_chromosome(per, rng, name, gene_every)
            ff.write(f">{name}\n".encode())
            chroms.append({"name": name, "offset": ff.tell(), "len": len(seq)})
            ff.write(seq)
            ff.write(b"\n")
            gf.write("\n".join(gtf))
            gf.write("\n")
    return {"fasta": fasta, "gtf": gtf_path, "chroms": chroms}


def ensure(cache_dir: str, cfg: dict) -> Dict[str, object]:
    """The genome of the configuration ``cfg`` (its ``total_bp``,
    ``n_chroms``, ``genome_seed`` and ``gene_every``) under ``cache_dir``:
    written the first time, reused after.  The sidecar is written last,
    so a cut write is redone."""
    genome = {k: cfg[k] for k in ("name", "total_bp", "n_chroms",
                                  "genome_seed", "gene_every")}
    side = os.path.join(cache_dir, f"{genome['name']}.json")
    if os.path.exists(side):
        with open(side) as f:
            got = json.load(f)
        if got.get("genome") == genome and os.path.exists(got["fasta"]):
            return got
    out = write_synth_genome(cache_dir, genome["total_bp"],
                             genome["genome_seed"], genome["n_chroms"],
                             genome["name"], genome["gene_every"])
    out["genome"] = genome
    tmp = side + ".part"
    with open(tmp, "w") as f:
        json.dump(out, f)
    os.replace(tmp, side)
    return out
