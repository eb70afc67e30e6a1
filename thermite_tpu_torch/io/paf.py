"""PAF output (reference src/aln_writer.rs:32-115).

Field quirks preserved exactly:
* column 10 ("number of residue matches") counts Match *op elements*;
* column 11 ("alignment block length") counts all op elements except
  intron skips (Yclip) — so a soft-clip counts as 1 regardless of its
  length, exactly like the reference (src/aln_writer.rs:56-72);
* a trailing tab terminates every row (the reference's format string
  ends with "\\t").
"""

from __future__ import annotations

from ..align.types import GenomeAlignment, OP_MATCH, YCLIP
from .sam import multimapq


def paf_line(
    query_name: bytes, query_seq: bytes, aln: GenomeAlignment, multimap: int
) -> str:
    runs = aln.gx_aln.op_runs
    if runs is not None:
        # runs fast path (codes 0..3 = M/S/D/I per-cell, 4 = SC, 5 = N);
        # SC counts as ONE element, N as zero — matching the per-cell
        # accounting below
        num_match = sum(r & 0xFFFFFFFF for r in runs if (r >> 32) == 0)
        num_match_gap = sum(
            (r & 0xFFFFFFFF) if (r >> 32) < 4 else 1
            for r in runs
            if (r >> 32) != 5
        )
    else:
        ops = aln.gx_aln.operations
        num_match = sum(1 for op in ops if op == OP_MATCH)
        num_match_gap = sum(
            1 for op in ops if not (isinstance(op, tuple) and op[0] == YCLIP)
        )
    fields = [
        query_name.decode(),
        str(len(query_seq)),
        str(aln.gx_aln.xstart),
        str(aln.gx_aln.xend),
        "+" if aln.strand else "-",
        aln.ref_name,
        str(aln.gx_aln.ylen),
        str(aln.gx_aln.ystart),
        str(aln.gx_aln.yend),
        str(num_match),
        str(num_match_gap),
        str(multimapq(multimap)),
    ]
    return "\t".join(fields) + "\t"


class PafWriter:
    def __init__(self, fh, index=None):
        self.fh = fh

    def write_aln(self, query_name, query_seq, aln, multimap):
        self.fh.write(paf_line(query_name, query_seq, aln, multimap) + "\n")

    def finish(self):
        pass
