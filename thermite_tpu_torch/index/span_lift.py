"""Span-only transcript->genome lifting.

The batched pipeline arbitrates alignments using only scores and
coordinate spans; full op lifting (``lift_tx_to_gx``) is deferred to
the few winner alignments.  This module computes the lifted
(ystart, yend) span without ops, exactly matching what
``lift_tx_to_gx`` would produce:

* ystart lands in the exon containing tx-coordinate ``ystart``
  (boundary rule: first exon with exon_sum + len > ystart, reference
  src/txome.rs:123-129);
* yend lands in the exon containing ``yend - 1``, *except*: the lift's
  exon-advance check runs before every op (src/txome.rs:133-141), so a
  trailing non-reference-consuming op (insert or clip) after the cursor
  reaches an exon boundary advances into the next exon (the reference's
  own TODO at src/txome.rs:132).  ``trailing_nonref`` conveys whether
  such a trailing op exists; for SWG extensions it is exactly
  ``xend < xlen`` (a query soft clip), because a banded-extension max
  cell can never be reached by an insertion (an insertion strictly
  lowers the score of an earlier same-column cell, which the
  strictly-greater max rule would have kept instead).
* an alignment consuming no reference (yend == ystart) never advances.
"""

from __future__ import annotations

from typing import Tuple

from .txome import Tx


def lift_tx_span_to_gx(
    ystart: int, yend: int, tx: Tx, trailing_nonref: bool = False
) -> Tuple[int, int]:
    exon_sum = 0
    k0 = 0
    while exon_sum + len(tx.exons[k0]) <= ystart:
        exon_sum += len(tx.exons[k0])
        k0 += 1
    out_start = tx.exons[k0].start + (ystart - exon_sum)

    if yend == ystart:
        return out_start, tx.exons[k0].start + (yend - exon_sum)

    k = k0
    end_sum = exon_sum
    while k + 1 < len(tx.exons) and end_sum + len(tx.exons[k]) <= yend - 1:
        end_sum += len(tx.exons[k])
        k += 1
    if trailing_nonref and k + 1 < len(tx.exons) and end_sum + len(tx.exons[k]) <= yend:
        end_sum += len(tx.exons[k])
        k += 1
    out_end = tx.exons[k].start + (yend - end_sum)
    return out_start, out_end
