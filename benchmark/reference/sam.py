"""SAM record construction: a frozen copy of the program's ``io/sam.py``
(its record fields and tags; the writers are left out).

Behaviour parity with the reference's output layer
(reference src/aln_writer.rs:118-358): flags, tags
(AS/NH/HI/nM/TX/GX/GN/RE), CIGAR conversion (Subst→M merge, intron
Yclip→N, Xclip→S), multimap MAPQ table, read-name truncation at the
first space, '-'-strand sequence/quality reversal.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from .types import (
    EXONIC,
    GenomeAlignment,
    INTRONIC,
    OP_DEL,
    OP_INS,
    OP_MATCH,
    OP_SUBST,
    XCLIP,
)
from .fastx import revcomp

FLAG_UNMAPPED = 4
FLAG_REVERSE = 16
FLAG_SECONDARY = 256


_RUN_CIGAR_CHARS = ("M", "M", "D", "I", "S", "N")  # codes 0..5


def cigar_from_runs(runs: List[int]) -> str:
    """CIGAR from the RLE op_runs form — same output as cigar_string
    on the expanded ops (M/S runs merge; clips and N never merge)."""
    merged: List = []
    for r in runs:
        ch = _RUN_CIGAR_CHARS[r >> 32]
        n = r & 0xFFFFFFFF
        if merged and merged[-1][0] == ch and ch in "MID":
            merged[-1][1] += n
        else:
            merged.append([ch, n])
    return "".join(f"{n}{ch}" for ch, n in merged)


def cigar_string(ops: List, runs: Optional[List[int]] = None) -> str:
    """Run-length CIGAR; Match and Subst both emit 'M'
    (reference src/aln_writer.rs:279-323)."""
    if runs is not None:
        return cigar_from_runs(runs)
    out: List[Tuple[str, int]] = []
    for op in ops:
        if isinstance(op, tuple):
            kind, n = op
            ch = "S" if kind == XCLIP else "N"
            out.append((ch, n))
            continue
        ch = {OP_MATCH: "M", OP_SUBST: "M", OP_DEL: "D", OP_INS: "I"}[op]
        if out and out[-1][0] == ch:
            out[-1] = (ch, out[-1][1] + 1)
        else:
            out.append((ch, 1))
    # The reference run-length-merges *consecutive identical raw ops*
    # after mapping Subst->Match; clips flush the run.  Consecutive
    # clips of the same kind are separate ops there too — merge only
    # M/I/D runs, which the loop above already does (clips appended
    # unconditionally).  Re-merge adjacent same-kind entries produced
    # across a Subst->Match boundary:
    merged: List[Tuple[str, int]] = []
    for ch, n in out:
        if merged and merged[-1][0] == ch and ch in "MID":
            merged[-1] = (ch, merged[-1][1] + n)
        else:
            merged.append((ch, n))
    return "".join(f"{n}{ch}" for ch, n in merged)


def multimapq(n: int) -> int:
    """MAPQ for an n-way multimapper (reference src/aln_writer.rs:326-340)."""
    if n <= 1:
        return 255
    if n >= 5:
        return 0
    return int(round(-10.0 * math.log10(1.0 - 1.0 / float(n))))


def format_read_name(name: bytes) -> str:
    """Truncate at first space (reference src/aln_writer.rs:344-349)."""
    i = name.find(b" ")
    return (name if i < 0 else name[:i]).decode()


def _maybe_empty(s: bytes) -> str:
    return s.decode() if s else "*"


@dataclass
class SamRecord:
    qname: str
    flag: int
    rname: str = "*"
    pos: int = 0  # 1-based; 0 = unmapped
    mapq: int = 255
    cigar: str = "*"
    rnext: str = "*"
    pnext: int = 0
    tlen: int = 0
    seq: str = "*"
    qual: str = "*"
    tags: List[Tuple[str, str, str]] = field(default_factory=list)  # (tag, type, value)


def aln_to_sam_record(
    index,
    query_name: bytes,
    query_seq: bytes,
    query_qual: bytes,
    aln: GenomeAlignment,
    multimap: int,
    hit_index: int,
) -> SamRecord:
    """Reference src/aln_writer.rs:118-238."""
    if aln.strand:
        seq = query_seq
        qual = query_qual
    else:
        seq = revcomp(query_seq)
        qual = query_qual[::-1]

    flag = 0
    if not aln.strand:
        flag |= FLAG_REVERSE
    if not aln.primary:
        flag |= FLAG_SECONDARY

    if aln.gx_aln.op_runs is not None:
        num_mismatch = sum(
            r & 0xFFFFFFFF for r in aln.gx_aln.op_runs if (r >> 32) == 1
        )
    else:
        num_mismatch = sum(1 for op in aln.gx_aln.operations if op == OP_SUBST)

    tags: List[Tuple[str, str, str]] = [
        ("AS", "i", str(aln.gx_aln.score)),
        ("NH", "i", str(multimap)),
        ("HI", "i", str(hit_index)),
        ("nM", "i", str(num_mismatch)),
    ]
    if aln.aln_type == EXONIC:
        tx = index.txome.txs[aln.tx_idx]
        gene = index.txome.genes[tx.gene_idx]
        tx_val = (
            f"{tx.id},+{aln.tx_aln.ystart},"
            f"{cigar_string(aln.tx_aln.operations, aln.tx_aln.op_runs)}"
        )
        tags.append(("TX", "Z", tx_val))
        tags.append(("GX", "Z", gene.id))
        tags.append(("GN", "Z", gene.name))
        tags.append(("RE", "A", "E"))
    elif aln.aln_type == INTRONIC:
        gene = index.txome.genes[aln.gene_idx]
        tags.append(("GX", "Z", gene.id))
        tags.append(("GN", "Z", gene.name))
        tags.append(("RE", "A", "N"))
    else:
        tags.append(("RE", "A", "I"))

    return SamRecord(
        qname=format_read_name(query_name),
        flag=flag,
        rname=aln.ref_name,
        pos=aln.gx_aln.ystart + 1,
        mapq=multimapq(multimap),
        cigar=cigar_string(aln.gx_aln.operations, aln.gx_aln.op_runs),
        seq=_maybe_empty(seq),
        qual=_maybe_empty(qual),
        tags=tags,
    )


def unmapped_sam_record(
    query_name: bytes, query_seq: bytes, query_qual: bytes
) -> SamRecord:
    """Reference src/aln_writer.rs:241-253."""
    return SamRecord(
        qname=format_read_name(query_name),
        flag=FLAG_UNMAPPED,
        mapq=255,
        seq=_maybe_empty(query_seq),
        qual=_maybe_empty(query_qual),
    )
