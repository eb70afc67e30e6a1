"""Seed extension helpers shared by the oracle driver and the batched
batch pipeline's host-side stitching.

Semantics match reference src/aligner.rs:352-426: a seed hit is
extended right from its end and left from its start (left inputs
reversed), then stitched with the seed's exact-match run in the middle.
"""

from __future__ import annotations

from typing import List

from .constants import MATCH_SCORE
from .types import Alignment, Mem, Op, OP_MATCH


def stitch(
    left_aln: Alignment,
    right_aln: Alignment,
    hit: Mem,
    ref_len: int,
    read_len: int,
) -> Alignment:
    """Combine left/right extension alignments around a seed hit
    (reference src/aligner.rs:377-406)."""
    ystart = hit.ref_idx - left_aln.yend
    yend = hit.ref_idx + hit.len + right_aln.yend
    xstart = hit.query_idx - left_aln.xend
    xend = hit.query_idx + hit.len + right_aln.xend
    score = left_aln.score + MATCH_SCORE * hit.len + right_aln.score
    ops: List[Op] = list(reversed(left_aln.operations))
    ops.extend([OP_MATCH] * hit.len)
    ops.extend(right_aln.operations)
    return Alignment(
        score=score,
        ystart=ystart,
        xstart=xstart,
        yend=yend,
        xend=xend,
        ylen=ref_len,
        xlen=read_len,
        operations=ops,
    )


def extend_left_right(
    ref_seq: bytes,
    hit: Mem,
    read: bytes,
    swg,
    band_width: int,
    x_drop: int,
) -> Alignment:
    """Banded SWG extension both ways around a seed hit
    (reference src/aligner.rs:352-407)."""
    x = read[hit.query_idx + hit.len :]
    # the band slides one row per column, so no cell exists beyond
    # column len(x) + band_width — clamp the suffix (transcript tails
    # can be tens of kb) exactly like the left side / the batch path
    y = ref_seq[hit.ref_idx + hit.len :][: len(x) + band_width + 1]
    right_aln = swg.extend(x, y, band_width, x_drop)

    x = read[: hit.query_idx][::-1]
    y_lo = max(hit.ref_idx - (len(read) + band_width), 0)
    y = ref_seq[y_lo : hit.ref_idx][::-1]
    left_aln = swg.extend(x, y, band_width, x_drop)

    return stitch(left_aln, right_aln, hit, len(ref_seq), len(read))


def extend_seed_match(ref_seq: bytes, hit: Mem, read: bytes) -> Mem:
    """Exact-match extension of a (lifted) seed both ways
    (reference src/aligner.rs:410-426).  Returns a new Mem."""
    ref_idx, query_idx, length = hit.ref_idx, hit.query_idx, hit.len
    while (
        ref_idx + length < len(ref_seq)
        and query_idx + length < len(read)
        and ref_seq[ref_idx + length] == read[query_idx + length]
    ):
        length += 1
    while ref_idx > 0 and query_idx > 0 and ref_seq[ref_idx - 1] == read[query_idx - 1]:
        ref_idx -= 1
        query_idx -= 1
        length += 1
    return Mem(ref_idx=ref_idx, query_idx=query_idx, len=length)
