"""GTF annotation parsing.

Covers the capability the reference gets from the 10X `transcriptome`
crate (reference src/index.rs:116-124): GTF → genes, transcripts,
exons, with spliced transcript sequence extraction.

Conventions (matching the 10X crate's model):
* GTF coordinates are 1-based inclusive; we convert to 0-based
  half-open on parse.
* Transcripts are defined by their `exon` features, sorted by genomic
  start within each transcript.
* Transcript/gene order is order of first appearance in the file
  (this fixes `tx_idx` / `gene_idx`).
* A '-' strand transcript's spliced sequence is the reverse complement
  of its concatenated exon sequence.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Tuple

from .fastx import revcomp

_ATTR_RE = re.compile(rb'(\w+)\s+"([^"]*)"')


@dataclass
class GtfTranscript:
    id: str
    chrom: str
    strand: bool  # True = '+'
    gene_idx: int
    # 0-based half-open exon ranges in chromosome coordinates, sorted
    # ascending by start.
    exons: List[Tuple[int, int]] = field(default_factory=list)

    @property
    def start(self) -> int:
        return self.exons[0][0]

    @property
    def end(self) -> int:
        return self.exons[-1][1]

    def spliced_seq(self, chrom_seq: bytes) -> bytes:
        s = b"".join(chrom_seq[a:b] for a, b in self.exons)
        return s if self.strand else revcomp(s)


@dataclass
class GtfGene:
    id: str
    name: str


def parse_gtf(path: str) -> Tuple[List[GtfGene], List[GtfTranscript]]:
    genes: List[GtfGene] = []
    gene_idx_of: Dict[str, int] = {}
    txs: List[GtfTranscript] = []
    tx_idx_of: Dict[str, int] = {}

    with open(path, "rb") as f:
        for line in f:
            if line.startswith(b"#"):
                continue
            parts = line.rstrip(b"\r\n").split(b"\t")
            if len(parts) < 9:
                continue
            chrom, _src, feature, start, end, _score, strand, _frame, attrs = parts[:9]
            if feature not in (b"gene", b"transcript", b"exon"):
                continue
            a = dict(_ATTR_RE.findall(attrs))
            gene_id = a.get(b"gene_id", b"").decode()
            if gene_id and gene_id not in gene_idx_of:
                gene_idx_of[gene_id] = len(genes)
                genes.append(
                    GtfGene(id=gene_id, name=a.get(b"gene_name", a[b"gene_id"]).decode())
                )
            if feature != b"exon":
                continue
            tx_id = a.get(b"transcript_id", b"").decode()
            if not tx_id:
                continue
            if not gene_id:
                # exon with a transcript but no gene_id: skip rather
                # than KeyError into an aborted index build
                continue
            if tx_id not in tx_idx_of:
                tx_idx_of[tx_id] = len(txs)
                txs.append(
                    GtfTranscript(
                        id=tx_id,
                        chrom=chrom.decode(),
                        strand=strand == b"+",
                        gene_idx=gene_idx_of[gene_id],
                    )
                )
            tx = txs[tx_idx_of[tx_id]]
            tx.exons.append((int(start) - 1, int(end)))

    for tx in txs:
        tx.exons.sort()
    return genes, txs
