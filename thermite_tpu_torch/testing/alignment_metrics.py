"""Parity-metrics harness: compare two BAM files read-by-read.

Port of the reference's test tooling
(reference lib/testing/alignment_metrics.py:30-283) built on this
framework's own BAM reader (pysam is unavailable here).  Semantics:

* both files are walked in name-sorted order;
* for each file-1 read, file-2 records are consumed until HI == NH
  (multimaps grouped, reference alignment_metrics.py:71-76);
* emits the same eight fraction metrics and the same markdown table.

Usage: python -m thermite_tpu_torch.testing.alignment_metrics A.bam B.bam
"""

from __future__ import annotations

import argparse
import sys
from dataclasses import dataclass
from typing import List

from ..io.bam import BamRead, read_bam


@dataclass
class Metrics:
    n_reads: int = 0
    n_reads_on_genes: int = 0
    n_in1_identical_align: int = 0
    n_in2_identical_align: int = 0
    n_in1_unaligned: int = 0
    n_in2_unaligned: int = 0
    n_overlapping_align: int = 0
    n_same_gene_align: int = 0
    n_same_chromosome_align: int = 0
    n_identical_align: int = 0


def _name_sorted(path: str) -> List[BamRead]:
    _, _, records = read_bam(path)
    recs = list(records)
    recs.sort(key=lambda r: r.qname)
    return recs


def _identical_to_ref(r: BamRead) -> bool:
    return (not r.is_unmapped) and r.query_alignment_length == r.reference_length


def _identical(a: BamRead, b: BamRead) -> bool:
    """NB: mutually-unmapped pairs compare identical (None == None) —
    this mirrors the reference harness's queries_identical
    (reference lib/testing/alignment_metrics.py:171-180), which also
    has no unmapped guard; kept so golden tables stay comparable."""
    return (
        a.rname == b.rname
        and a.pos == b.pos
        and a.reference_end == b.reference_end
        and a.is_reverse == b.is_reverse
    )


def _overlap(a: BamRead, b: BamRead) -> bool:
    return (
        a.rname == b.rname
        and a.is_reverse == b.is_reverse
        and a.reference_end > b.pos
        and a.pos < b.reference_end
    )


def _gx_tags(rows: List[BamRead]) -> set:
    out = set()
    for r in rows:
        gx = r.tags.get("GX")
        if gx:
            out.update(gx.split(";"))
    return out


def compare(path1: str, path2: str) -> Metrics:
    rows1 = _name_sorted(path1)
    rows2 = _name_sorted(path2)
    m = Metrics()
    it2 = iter(rows2)

    for row1 in rows1:
        m.n_reads += 1
        row2s: List[BamRead] = []
        while True:
            row2 = next(it2, None)
            if row2 is None:
                raise SystemExit(
                    f"file2 ran out of records at read {row1.qname!r} "
                    "(truncated file or multimap group without HI == NH)"
                )
            row2s.append(row2)
            if row2.is_unmapped or row2.tags.get("HI") == row2.tags.get("NH"):
                break
        if row1.qname != row2s[0].qname:
            raise SystemExit(
                f"query names not matching up: {row1.qname}, {row2s[0].qname}"
            )

        m.n_in1_identical_align += _identical_to_ref(row1)
        m.n_in2_identical_align += _identical_to_ref(row2s[0])
        m.n_in1_unaligned += row1.is_unmapped
        m.n_in2_unaligned += row2s[0].is_unmapped
        m.n_same_chromosome_align += row1.rname in {r.rname for r in row2s}
        m.n_overlapping_align += (not row1.is_unmapped) and any(
            (not r.is_unmapped) and _overlap(row1, r) for r in row2s
        )
        m.n_identical_align += any(_identical(row1, r) for r in row2s)
        if "GX" in row1.tags:
            m.n_reads_on_genes += 1
            m.n_same_gene_align += bool(_gx_tags([row1]) & _gx_tags(row2s))
    return m


@dataclass
class TruthMetrics:
    """Accuracy vs the read generator's ground truth (non-circular: the
    synthetic read names encode each read's true origin —
    ``...:{chrom}:{start}:{end}:{strand}``, 0-based half-open — so this
    referee is independent of any aligner).  Fills the role of the
    reference's Cell Ranger comparison BAM
    (reference lib/testing/comparison_metrics.txt), whose blobs are
    git-LFS-elided upstream."""

    n_reads: int = 0
    n_aligned: int = 0
    n_true_chrom: int = 0
    n_true_overlap: int = 0
    n_true_identical: int = 0
    n_primary_true_overlap: int = 0
    n_primary_true_identical: int = 0


def _parse_truth(qname: str):
    """-> (chrom, start, end, is_reverse) from a truth-encoded name."""
    parts = qname.split(":")
    if len(parts) < 5:
        raise SystemExit(
            f"read name {qname!r} does not encode ground truth "
            "(expected ...:chrom:start:end:strand)"
        )
    chrom, start, end, strand = parts[-4], parts[-3], parts[-2], parts[-1]
    return chrom, int(start), int(end), strand == "-"


def truth_compare(path: str) -> TruthMetrics:
    rows = _name_sorted(path)
    m = TruthMetrics()
    i = 0
    while i < len(rows):
        # group consecutive rows by qname (the list is name-sorted);
        # walking HI/NH instead would IndexError on truncated or
        # tag-inconsistent inputs
        j = i + 1
        while j < len(rows) and rows[j].qname == rows[i].qname:
            j += 1
        group = rows[i:j]
        i = j
        chrom, start, end, rev = _parse_truth(group[0].qname)
        m.n_reads += 1
        aligned = [r for r in group if not r.is_unmapped]
        m.n_aligned += bool(aligned)

        def on_chrom(r):
            return r.rname == chrom and r.is_reverse == rev

        def overlaps(r):
            return on_chrom(r) and r.reference_end > start and r.pos < end

        def identical(r):
            return on_chrom(r) and r.pos == start and r.reference_end == end

        m.n_true_chrom += any(r.rname == chrom for r in aligned)
        m.n_true_overlap += any(overlaps(r) for r in aligned)
        m.n_true_identical += any(identical(r) for r in aligned)
        primary = [r for r in aligned if not r.is_secondary]
        if primary:
            m.n_primary_true_overlap += overlaps(primary[0])
            m.n_primary_true_identical += identical(primary[0])
    return m


def truth_to_markdown(m: TruthMetrics) -> str:
    def frac(a, nd=3):
        return round(a / m.n_reads, nd) if m.n_reads else 0.0

    return f"""
|metric|fraction|
|------|--------|
|aligned reads | {frac(m.n_aligned)}|
|aligned to true chromosome | {frac(m.n_true_chrom)}|
|any alignment overlaps truth | {frac(m.n_true_overlap)}|
|any alignment identical to truth | {frac(m.n_true_identical)}|
|primary overlaps truth | {frac(m.n_primary_true_overlap)}|
|primary identical to truth | {frac(m.n_primary_true_identical)}|
    """


def to_markdown(m: Metrics) -> str:
    def frac(a, b, nd=3):
        return round(a / b, nd) if b else 0.0

    return f"""
|metric|fraction|
|------|--------|
|file1 identical alignment to ref | {frac(m.n_in1_identical_align, m.n_reads)}|
|file2 identical alignment to ref | {frac(m.n_in2_identical_align, m.n_reads)}|
|file1 unaligned reads |            {frac(m.n_in1_unaligned, m.n_reads)}|
|file2 unaligned reads |            {frac(m.n_in2_unaligned, m.n_reads)}|
|file1 and file2 reads on same chr |{frac(m.n_same_chromosome_align, m.n_reads)}|
|file1 and file2 identical alignments |{frac(m.n_identical_align, m.n_reads)}|
|file1 and file2 overlapping align |{frac(m.n_overlapping_align, m.n_reads, 2)}|
|file1 and file2 reads on same gene |{frac(m.n_same_gene_align, m.n_reads_on_genes)}|
    """


def main(argv=None):
    p = argparse.ArgumentParser(description="Alignment parity metrics")
    p.add_argument("in1", help="comparison BAM (e.g. Cell Ranger), or the"
                   " single BAM to score with --truth")
    p.add_argument("in2", nargs="?", help="thermite BAM")
    p.add_argument(
        "--truth", action="store_true",
        help="score in1 against ground truth encoded in its read names"
        " (...:chrom:start:end:strand) instead of a comparison BAM",
    )
    args = p.parse_args(argv)
    if args.truth:
        m = truth_compare(args.in1)
        print(f"file: {args.in1} (vs encoded ground truth)")
        print(truth_to_markdown(m))
        return 0
    if args.in2 is None:
        p.error("in2 is required without --truth")
    m = compare(args.in1, args.in2)
    print(f"file1: {args.in1}, file2: {args.in2}")
    print(to_markdown(m))
    return 0


if __name__ == "__main__":
    sys.exit(main())
