"""The reference's own index: the genome text and the transcriptome,
worked out from the FASTA and GTF that the benchmark wrote.

A frozen copy of the program's ``Index.create_from_files``, with the
layout of the upstream aligner (src/index.rs:52-223): every chromosome is
appended forward then reverse-complemented, each copy '$'-terminated, so
a reverse-strand alignment is a forward match against the revcomp copy.
It holds no seed table: ``seeds.SampleSeeder`` finds the anchors of the
reads that are checked.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from .fastx import parse_fastx, revcomp
from .gtf import parse_gtf
from .txome import Exon, Gene, IntervalTable, Tx, Txome


@dataclass
class Ref:
    """One strand copy of one chromosome."""

    name: str
    strand: bool  # True = the forward copy
    len: int
    start_idx: int  # start in the concatenated text
    end_idx: int  # end in the concatenated text, including '$'


class Genome:
    """Concatenated fwd+rc text with the transcriptome annotations."""

    def __init__(self, refs: List[Ref], seq: bytes, txome: Txome):
        self.refs = refs
        self.seq = seq
        self.seq_arr = np.frombuffer(seq, dtype=np.uint8)
        self.txome = txome
        self._ref_ends = np.array([r.end_idx for r in refs], dtype=np.int64)

    @classmethod
    def from_files(cls, fasta: str, gtf: Optional[str]) -> "Genome":
        refs: List[Ref] = []
        chunks: List[bytes] = []
        pos = 0
        name_to_ref: Dict[Tuple[str, bool], int] = {}
        chrom_seqs: Dict[str, bytes] = {}
        for rec in parse_fastx(fasta):
            name = rec.id.split(b" ")[0].decode()
            fwd = rec.seq.upper()
            chrom_seqs[name] = fwd
            start = pos
            chunks += [fwd, b"$"]
            pos += len(fwd) + 1
            name_to_ref[(name, True)] = len(refs)
            refs.append(Ref(name, True, len(fwd), start, pos))
            rc = revcomp(rec.seq).upper()
            start = pos
            chunks += [rc, b"$"]
            pos += len(rc) + 1
            name_to_ref[(name, False)] = len(refs)
            refs.append(Ref(name, False, len(fwd), start, pos))
        seq = b"".join(chunks)
        del chunks

        genes: List[Gene] = []
        txs: List[Tx] = []
        gene_spans: List[Tuple[int, int]] = []
        exon_starts: List[int] = []
        exon_ends: List[int] = []
        exon_tx: List[int] = []
        if gtf is not None:
            gtf_genes, gtf_txs = parse_gtf(gtf)
            genes = [Gene(g.id, g.name) for g in gtf_genes]
            gene_spans = [(len(seq), 0)] * len(genes)
            for gtf_tx in gtf_txs:
                strand = gtf_tx.strand
                if (gtf_tx.chrom, strand) not in name_to_ref:
                    print(f"warning: skipping annotations on {gtf_tx.chrom!r}"
                          ": not in the reference FASTA", file=sys.stderr)
                    continue
                tx_ref = refs[name_to_ref[(gtf_tx.chrom, strand)]]
                tx_seq = gtf_tx.spliced_seq(chrom_seqs[gtf_tx.chrom])
                if strand:
                    tx_start = gtf_tx.start + tx_ref.start_idx
                    tx_end = gtf_tx.end + tx_ref.start_idx
                else:
                    tx_start = tx_ref.end_idx - 1 - gtf_tx.end
                    tx_end = tx_ref.end_idx - 1 - gtf_tx.start
                g = gtf_tx.gene_idx
                gene_spans[g] = (min(gene_spans[g][0], tx_start),
                                 max(gene_spans[g][1], tx_end))
                exons = []
                for e_start, e_end in gtf_tx.exons:
                    if strand:
                        es = e_start + tx_ref.start_idx
                        ee = e_end + tx_ref.start_idx
                    else:
                        es = tx_ref.end_idx - 1 - e_end
                        ee = tx_ref.end_idx - 1 - e_start
                    exon_starts.append(es)
                    exon_ends.append(ee)
                    exon_tx.append(len(txs))
                    exons.append(Exon(es, ee, len(txs)))
                if not strand:
                    # exon order follows the (revcomp'd) transcript sequence
                    exons.reverse()
                txs.append(Tx(id=gtf_tx.id, chrom=gtf_tx.chrom, strand=strand,
                              exons=exons, seq=tx_seq, gene_idx=g))
        txome = Txome(
            genes=genes,
            txs=txs,
            exon_to_tx=IntervalTable(exon_starts, exon_ends, exon_tx),
            gene_intervals=IntervalTable(
                [s for s, _ in gene_spans], [e for _, e in gene_spans],
                list(range(len(genes)))),
        )
        return cls(refs, seq, txome)

    def idx_to_ref(self, idx: int) -> Tuple[Ref, int]:
        """Concatenated coordinate -> (chromosome copy, local coordinate)."""
        r = self.refs[int(np.searchsorted(self._ref_ends, idx, side="right"))]
        return r, idx - r.start_idx

    def seq_slice(self, start: int, end: int) -> bytes:
        return self.seq[start:end]

    def unique_refs(self) -> List[Tuple[str, int]]:
        """(name, length) of each chromosome, in FASTA order: the BAM
        header's reference table, whose index is a record's ref id."""
        out, seen = [], set()
        for r in self.refs:
            if r.name not in seen:
                seen.add(r.name)
                out.append((r.name, r.len))
        return out
