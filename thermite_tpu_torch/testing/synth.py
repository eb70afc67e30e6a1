"""Deterministic synthetic genomes + reads for benches and scale tests.

The reference benchmarks against GRCh38 chr21 + pbmc10k reads, all
git-LFS-elided upstream (reference .MISSING_LARGE_BLOBS); these
generators synthesize stand-ins at matched scale: a chromosome of the
requested length with spliced genes on both strands (chr21-like
density), and error-bearing reads whose TRUE origin is encoded in the
read name so accuracy can be scored against ground truth
(``testing/alignment_metrics.py``, its ``--truth`` mode).
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

_ALPHA = np.frombuffer(b"ACGT", np.uint8)


def synth_chromosome(
    length: int,
    rng: np.random.Generator,
    name: str = "syn1",
    gene_every: int = 22_000,
) -> Tuple[bytes, List[str]]:
    """One random chromosome + GTF lines (~chr21 gene density at the
    default spacing: chr21 is 46.7 Mbp with ~2k genes incl. ncRNA).

    Genes are 3-exon transcripts (150 bp exons, 300 bp introns) on
    random strands; every gene gets one transcript.
    """
    seq = _ALPHA[rng.integers(0, 4, length)].tobytes()
    gtf: List[str] = []
    pos = 500
    gi = 0
    while pos + 1500 < length:
        strand = "+" if rng.random() < 0.5 else "-"
        gid = f"{name}G{gi:05d}"
        attrs = (
            f'gene_id "{gid}"; transcript_id "{gid}T"; '
            f'gene_name "{gid}n";'
        )
        for s, e in ((pos, pos + 150), (pos + 450, pos + 600), (pos + 900, pos + 1050)):
            gtf.append(
                f"{name}\tsyn\texon\t{s + 1}\t{e}\t.\t{strand}\t.\t{attrs}"
            )
        gi += 1
        pos += int(rng.integers(gene_every * 3 // 4, gene_every * 5 // 4))
    return seq, gtf


def write_synth_genome(
    out_dir: str,
    total_bp: int,
    seed: int = 1234,
    n_chroms: int = 1,
    basename: str = "syn",
) -> Tuple[str, str]:
    """Write a synthetic FASTA+GTF of ``total_bp`` across ``n_chroms``
    chromosomes; returns (fasta_path, gtf_path)."""
    os.makedirs(out_dir, exist_ok=True)
    fasta = os.path.join(out_dir, f"{basename}.fasta")
    gtf_path = os.path.join(out_dir, f"{basename}.gtf")
    rng = np.random.default_rng(seed)
    per = total_bp // n_chroms
    with open(fasta, "w") as ff, open(gtf_path, "w") as gf:
        for c in range(n_chroms):
            name = f"{basename}{c + 1}"
            seq, gtf = synth_chromosome(per, rng, name=name)
            ff.write(f">{name}\n")
            # 80-col wrapping is unnecessary for our parser but cheap
            ff.write(seq.decode())
            ff.write("\n")
            gf.write("\n".join(gtf))
            gf.write("\n")
    return fasta, gtf_path


def make_truth_reads(
    index,
    n: int,
    read_len: int = 90,
    seed: int = 3,
    max_subst: int = 3,
) -> List[Tuple[str, bytes]]:
    """(name, seq) reads drawn from the forward chromosome copies of an
    Index, substitution errors, both strands.  The name encodes the
    ground truth as ``synth{i}:{chrom}:{start}:{end}:{strand}`` with a
    0-based half-open genome interval and +/- strand — the accuracy
    referee (alignment_metrics --truth) parses this.
    """
    from ..io.fastx import revcomp

    rng = np.random.default_rng(seed)
    fwd = [r for r in index.refs if r.strand and r.len > read_len + 1]
    lens = np.array([r.len for r in fwd], np.float64)
    pchrom = lens / lens.sum()
    out: List[Tuple[str, bytes]] = []
    for i in range(n):
        ref = fwd[int(rng.choice(len(fwd), p=pchrom))]
        p = int(rng.integers(0, ref.len - read_len - 1))
        seq = bytearray(
            index.seq[ref.start_idx + p : ref.start_idx + p + read_len]
        )
        for _ in range(int(rng.integers(0, max_subst + 1))):
            seq[int(rng.integers(0, read_len))] = _ALPHA[
                int(rng.integers(0, 4))
            ]
        seq = bytes(seq)
        strand = "+"
        if rng.random() < 0.5:
            seq = revcomp(seq)
            strand = "-"
        out.append(
            (f"synth{i}:{ref.name}:{p}:{p + read_len}:{strand}", seq)
        )
    return out


def write_fastq(reads: List[Tuple[str, bytes]], path: str) -> None:
    with open(path, "w") as f:
        for name, seq in reads:
            f.write(f"@{name}\n{seq.decode()}\n+\n{'I' * len(seq)}\n")
