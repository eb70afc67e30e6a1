"""Core alignment data types.

These mirror the observable structure of the reference aligner's types
(rust-bio ``Alignment``/``AlignmentOperation``, reference src/swg.rs:1-2;
``GenomeAlignment``/``AlnType``, reference src/txome.rs:54-69;
``Mem``, reference src/index.rs:383-388) without copying any code: they
are plain Python dataclasses designed for cheap interchange with the
batched device pipeline (which carries the same fields as arrays).

Alignment operations are represented per-cell exactly like the
reference: 'M' (match), 'S' (substitution), 'I' (insertion: consumes
query), 'D' (deletion: consumes ref) are single-cell ops, while clips
carry a length: ``('SC', n)`` soft-clips n query bases (reference
Xclip) and ``('N', n)`` skips n reference bases, repurposed for introns
(reference Yclip, src/txome.rs:138).  Keeping per-cell ops matters for
byte-exact PAF output: the reference counts op *elements* when
computing the PAF alignment-length column (src/aln_writer.rs:64-72).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

OP_MATCH = "M"
OP_SUBST = "S"
OP_INS = "I"
OP_DEL = "D"

# Clip ops are (kind, length) tuples.
XCLIP = "SC"  # query soft clip
YCLIP = "N"  # reference skip (introns)

Op = Union[str, Tuple[str, int]]

_RUN_CHARS = (OP_MATCH, OP_SUBST, OP_DEL, OP_INS)


def runs_to_ops(runs) -> List[Op]:
    """Expand RLE op runs ((code << 32) | length; codes 0..3 =
    M/S/D/I, 4 = SC, 5 = N) into the per-cell op list."""
    ops: List[Op] = []
    for r in runs:
        op = int(r) >> 32
        ln = int(r) & 0xFFFFFFFF
        if op < 4:
            ops.extend([_RUN_CHARS[op]] * ln)
        elif op == 4:
            ops.append((XCLIP, ln))
        else:
            ops.append((YCLIP, ln))
    return ops


class RunOps:
    """Lazy list view of an RLE ``op_runs`` list.

    The batch pipeline's native finalize produces alignments whose op
    streams arrive run-length encoded; most consumers (the SAM/BAM/PAF
    writers, span logic) read the RLE ``op_runs`` fast path and never
    touch per-cell ``operations`` — expanding ~90 per-cell ops per
    alignment eagerly was ~half the object-construction cost of
    ``align_batch``.  This view materializes on first sequence access
    and compares equal to the expanded list.
    """

    __slots__ = ("_runs", "_ops")

    def __init__(self, runs):
        self._runs = runs
        self._ops = None

    def _mat(self) -> List[Op]:
        if self._ops is None:
            self._ops = runs_to_ops(self._runs)
        return self._ops

    def __iter__(self):
        return iter(self._mat())

    def __len__(self):
        return len(self._mat())

    def __getitem__(self, i):
        return self._mat()[i]

    def __eq__(self, other):
        if isinstance(other, RunOps):
            other = other._mat()
        return self._mat() == other

    def __ne__(self, other):
        return not self.__eq__(other)

    def __add__(self, other):
        if isinstance(other, RunOps):
            other = other._mat()
        return self._mat() + other

    def __radd__(self, other):
        return other + self._mat()

    def __repr__(self):
        return repr(self._mat())


def xclip(n: int) -> Tuple[str, int]:
    return (XCLIP, n)


def yclip(n: int) -> Tuple[str, int]:
    return (YCLIP, n)


@dataclass(slots=True)
class Alignment:
    """A pairwise alignment of query x against reference y.

    Coordinate semantics identical to rust-bio's ``Alignment``:
    half-open [start, end) ranges; ops describe the path from
    (xstart, ystart) to (xend, yend), with clips covering the rest.
    """

    score: int
    ystart: int
    xstart: int
    yend: int
    xend: int
    ylen: int
    xlen: int
    operations: List[Op] = field(default_factory=list)
    # Optional RLE form of `operations` ((op_code << 32) | length ints,
    # codes 0..3 = M/S/D/I, 4 = SC, 5 = N) attached by the batch
    # pipeline's native finalize; writers use it as a fast path for
    # CIGAR/mismatch computation.  Excluded from equality: it is a
    # cache of `operations`, not independent state.
    op_runs: Optional[List[int]] = field(default=None, compare=False)

    def copy(self) -> "Alignment":
        return Alignment(
            score=self.score,
            ystart=self.ystart,
            xstart=self.xstart,
            yend=self.yend,
            xend=self.xend,
            ylen=self.ylen,
            xlen=self.xlen,
            operations=list(self.operations),
        )


@dataclass(slots=True)
class Mem:
    """A maximal exact match seed (reference src/index.rs:383-388)."""

    ref_idx: int
    query_idx: int
    len: int


# Alignment classification (reference src/txome.rs:64-69).
EXONIC = "exonic"
INTRONIC = "intronic"
INTERGENIC = "intergenic"


@dataclass(slots=True)
class GenomeAlignment:
    """An alignment placed on a chromosome (reference src/txome.rs:54-61)."""

    gx_aln: Alignment
    aln_type: str  # EXONIC | INTRONIC | INTERGENIC
    ref_name: str
    strand: bool  # True = forward
    primary: bool = False
    # Exonic-only payload (reference AlnType::Exonic fields).
    tx_aln: Optional[Alignment] = None
    tx_idx: Optional[int] = None
    # Intronic-only payload.
    gene_idx: Optional[int] = None
