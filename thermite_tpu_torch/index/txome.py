"""Transcriptome model and coordinate lifting.

Capability parity with the reference's transcriptome layer
(reference src/txome.rs:8-160): ``Txome``/``Tx``/``Gene``/``Exon`` data
model, MEM→transcript lifting, and transcript→genome alignment lifting
that introduces intron skips at exon junctions.

Design difference: instead of pointer-based interval trees
(reference src/txome.rs:13-14) the exon→transcript and gene interval
maps are stored as *flat sorted numpy arrays* queried with vectorized
binary search (`np.searchsorted`) — the same layout the device seeder
gathers from device memory.  See ``IntervalTable``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Sequence, Tuple

import numpy as np

from ..align.types import Alignment, Mem, OP_DEL, OP_MATCH, OP_SUBST, yclip


@dataclass
class Gene:
    id: str
    name: str


@dataclass
class Exon:
    """Exon in concatenated-genome coordinates, half-open [start, end)."""

    start: int
    end: int
    tx_idx: int

    def __len__(self) -> int:
        return self.end - self.start


@dataclass
class Tx:
    """A transcript: spliced sequence plus exon structure.

    ``exons`` are in concatenated coordinates on the strand-matching
    chromosome copy (forward copy for '+' transcripts, revcomp copy for
    '-' transcripts), sorted so that exon order follows the transcript's
    5'→3' spliced sequence (reference src/index.rs:164-195).
    """

    id: str
    chrom: str
    strand: bool
    exons: List[Exon]
    seq: bytes
    gene_idx: int


class IntervalTable:
    """Flat interval set with vectorized stabbing/overlap queries.

    Replaces the reference's ``IntervalTree`` with a numpy-friendly
    layout: three parallel int arrays (start, end, payload) sorted by
    start, plus a running prefix-max of ends for pruned overlap scans.
    Query results are returned sorted by (start, insertion order) —
    a deterministic canonical order (the reference's tree iteration
    order is an implementation detail we intentionally canonicalise).
    """

    def __init__(self, starts: Sequence[int], ends: Sequence[int], data: Sequence[int]):
        starts = np.asarray(starts, dtype=np.int64)
        ends = np.asarray(ends, dtype=np.int64)
        data = np.asarray(data, dtype=np.int64)
        order = np.lexsort((np.arange(len(starts)), starts))
        self.starts = starts[order]
        self.ends = ends[order]
        self.data = data[order]
        self.max_end_prefix = (
            np.maximum.accumulate(self.ends) if len(self.ends) else self.ends
        )

    def __len__(self) -> int:
        return len(self.starts)

    def find(self, start: int, end: int) -> np.ndarray:
        """Payloads of all intervals overlapping [start, end)."""
        if len(self.starts) == 0 or end <= start:
            return np.empty(0, dtype=np.int64)
        # Candidates: interval.start < end.
        hi = int(np.searchsorted(self.starts, end, side="left"))
        if hi == 0:
            return np.empty(0, dtype=np.int64)
        # Prune the prefix where every end <= start.
        lo = int(np.searchsorted(self.max_end_prefix[:hi], start, side="right"))
        sel = self.ends[lo:hi] > start
        return self.data[lo:hi][sel]


@dataclass
class Txome:
    genes: List[Gene]
    txs: List[Tx]
    exon_to_tx: IntervalTable = field(default=None)
    gene_intervals: IntervalTable = field(default=None)


def intersect(a: Tuple[int, int], b: Tuple[int, int]) -> bool:
    """Half-open interval overlap (reference src/txome.rs:77-79)."""
    return (b[0] <= a[0] < b[1]) or (a[0] <= b[0] < a[1])


def contains(larger: Tuple[int, int], smaller: Tuple[int, int]) -> bool:
    """Reference src/txome.rs:72-74 semantics (note: end-exclusive <)."""
    return smaller[0] >= larger[0] and smaller[1] < larger[1]


def lift_mem_to_tx(mem: Mem, tx: Tx) -> Mem:
    """Lift a concatenated-genome MEM onto a transcript.

    Clips the MEM to the *first* intersecting exon in transcript order
    (reference src/txome.rs:82-103).
    """
    exon_sum = 0
    for exon in tx.exons:
        if intersect((mem.ref_idx, mem.ref_idx + mem.len), (exon.start, exon.end)):
            start = max(mem.ref_idx - exon.start, 0) + exon_sum
            start_offset = max(exon.start - mem.ref_idx, 0)
            end = min(mem.ref_idx + mem.len, exon.end) - exon.start + exon_sum
            return Mem(
                ref_idx=start,
                query_idx=mem.query_idx + start_offset,
                len=end - start,
            )
        exon_sum += len(exon)
    raise AssertionError("MEM does not intersect any exon of the transcript")


def lift_tx_to_gx(tx_aln: Alignment, tx: Tx) -> Alignment:
    """Lift a transcript alignment to concatenated-genome coordinates.

    Walks the ops, inserting an intron skip ``('N', gap)`` whenever the
    reference cursor crosses an exon boundary (reference
    src/txome.rs:110-160).  The known edge case at src/txome.rs:132
    (trailing insert at an exon boundary does not pull in the next
    exon) is preserved by the `exon_idx + 1 < len` guard.
    """
    aln = tx_aln.copy()
    aln.operations = []

    i = tx_aln.ystart
    exon_sum = 0
    exon_idx = 0
    while exon_sum + len(tx.exons[exon_idx]) <= i:
        exon_sum += len(tx.exons[exon_idx])
        exon_idx += 1

    aln.ystart = tx.exons[exon_idx].start + (i - exon_sum)

    for op in tx_aln.operations:
        if exon_idx + 1 < len(tx.exons) and exon_sum + len(tx.exons[exon_idx]) <= i:
            exon_sum += len(tx.exons[exon_idx])
            exon_idx += 1
            aln.operations.append(
                yclip(tx.exons[exon_idx].start - tx.exons[exon_idx - 1].end)
            )
        if op in (OP_MATCH, OP_SUBST, OP_DEL):
            i += 1
        aln.operations.append(op)

    assert i == tx_aln.yend
    aln.yend = tx.exons[exon_idx].start + (i - exon_sum)
    return aln
