"""Oracle per-read alignment driver.

Exact-semantics re-implementation of the reference's seed → extend →
arbitrate → filter pipeline (reference src/aligner.rs:123-449).  It is
the parity referee for the batched device pipeline and the fallback CPU
path; all observable rules (score thresholds, adaptive band narrowing,
genome-vs-transcriptome arbitration, overlap filtering, primary
selection) follow the reference line-for-line in behaviour.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..constants import (
    DEFAULT_MIN_ALN_SCORE,
    DEFAULT_MIN_ALN_SCORE_PERCENT,
    DEFAULT_MIN_SEED_LEN,
    DEFAULT_MULTIMAP_SCORE_RANGE,
    MATCH_SCORE,
)
from ..index.build import Index
from ..index.txome import lift_mem_to_tx, lift_tx_to_gx
from ..ops.swg_ref import SwgExtend
from ..seed.smem import SmemEngine
from .extend import extend_left_right, extend_seed_match
from .types import (
    Alignment,
    EXONIC,
    GenomeAlignment,
    INTERGENIC,
    INTRONIC,
    Mem,
)


@dataclass
class AlignOpts:
    """Reference src/aligner.rs:452-464 with identical defaults
    (src/main.rs:116-132, src/wrapper.rs:40-46)."""

    min_seed_len: int = DEFAULT_MIN_SEED_LEN
    min_aln_score_percent: float = DEFAULT_MIN_ALN_SCORE_PERCENT
    min_aln_score: int = DEFAULT_MIN_ALN_SCORE
    multimap_score_range: int = DEFAULT_MULTIMAP_SCORE_RANGE
    intron_mode: bool = False


class OracleAligner:
    """Per-read aligner bundling the index with a seeding engine."""

    def __init__(self, index: Index, opts: AlignOpts):
        self.index = index
        self.opts = opts
        from ..seed.native import make_seeder

        self.seeder = make_seeder(
            index.seq_arr, opts.min_seed_len,
            table=getattr(index, "seed_table", None),
            stride_known=getattr(index, "seed_stride", None),
        )

    def align_read(self, read: bytes) -> List[GenomeAlignment]:
        return align_read(self.index, read, self.opts, self.seeder)


def align_read(
    index: Index,
    read: bytes,
    opts: AlignOpts,
    seeder: Optional[SmemEngine] = None,
) -> List[GenomeAlignment]:
    """Reference src/aligner.rs:123-190."""
    read = read.upper()
    if seeder is None:
        seeder = SmemEngine(index.seq_arr, opts.min_seed_len)
    mems = seeder.all_smems(read)

    gx_alns: List[GenomeAlignment] = []
    min_aln_score = max(
        int(opts.min_aln_score_percent * float(len(read))), opts.min_aln_score
    )
    max_aln_score = min_aln_score
    band_width = max(len(read) - min_aln_score, 0)
    x_drop = max(len(read) - min_aln_score, 0)

    swg = SwgExtend(band_width)

    for hit in mems:
        gx_aln = align_seed_hit(index, read, hit, swg, band_width, x_drop)

        if not opts.intron_mode and gx_aln.aln_type != EXONIC:
            continue

        # NB: the opts.min_aln_score clause is subsumed by min_aln_score
        # (= max(pct*len, opts.min_aln_score)); kept because this module
        # mirrors reference src/aligner.rs:154-159 line-for-line
        if (
            gx_aln.gx_aln.score < opts.min_aln_score
            or gx_aln.gx_aln.score < min_aln_score
            or gx_aln.gx_aln.score < max_aln_score - opts.multimap_score_range
        ):
            continue

        # adaptive band/X-drop narrowing (src/aligner.rs:162-172)
        narrowed = max(
            len(read) + opts.multimap_score_range - gx_aln.gx_aln.score, 0
        )
        band_width = min(band_width, narrowed)
        x_drop = min(x_drop, narrowed)
        max_aln_score = max(max_aln_score, gx_aln.gx_aln.score)

        gx_alns.append(gx_aln)

    gx_alns = [
        a
        for a in gx_alns
        if a.gx_aln.score >= max_aln_score - opts.multimap_score_range
    ]
    gx_alns = filter_overlapping(gx_alns)
    gx_alns.sort(key=lambda a: -a.gx_aln.score)  # stable, like Rust sort_by_key
    if gx_alns:
        gx_alns[0].primary = True
    return gx_alns


def align_seed_hit(
    index: Index,
    read: bytes,
    hit: Mem,
    swg: SwgExtend,
    band_width: int,
    x_drop: int,
) -> GenomeAlignment:
    """Reference src/aligner.rs:198-314."""
    aln_ref, _ = index.idx_to_ref(hit.ref_idx)

    # genome extension within a window around the hit
    seq_start = max(hit.ref_idx - (len(read) + band_width), aln_ref.start_idx)
    seq_end = min(hit.ref_idx + hit.len + len(read) + band_width, aln_ref.end_idx - 1)
    ref_seq = index.seq_slice(seq_start, seq_end)
    rel_hit = Mem(ref_idx=hit.ref_idx - seq_start, query_idx=hit.query_idx, len=hit.len)
    gx_aln = extend_left_right(ref_seq, rel_hit, read, swg, band_width, x_drop)
    gx_aln.ystart += seq_start
    gx_aln.yend += seq_start

    # transcriptome candidates intersecting the seed
    best_tx: Optional[tuple] = None  # (tx_idx, Alignment)
    tx_idxs = sorted(set(index.txome.exon_to_tx.find(hit.ref_idx, hit.ref_idx + hit.len).tolist()))
    for tx_idx in tx_idxs:
        tx = index.txome.txs[tx_idx]
        tx_seed = lift_mem_to_tx(hit, tx)
        tx_seed = extend_seed_match(tx.seq, tx_seed, read)
        tx_aln = extend_left_right(tx.seq, tx_seed, read, swg, band_width, x_drop)
        if best_tx is None or tx_aln.score > best_tx[1].score:
            best_tx = (tx_idx, tx_aln)
        if tx_aln.score >= len(read) * MATCH_SCORE:
            break  # cannot beat an exact match

    ref_name = aln_ref.name
    strand = aln_ref.strand

    if best_tx is not None and best_tx[1].score >= gx_aln.score:
        tx_idx, tx_aln = best_tx
        lifted = lift_tx_to_gx(tx_aln, index.txome.txs[tx_idx])
        chr_aln = concat_to_chr_aln(index, lifted)
        return GenomeAlignment(
            gx_aln=chr_aln,
            aln_type=EXONIC,
            ref_name=ref_name,
            strand=strand,
            tx_aln=tx_aln,
            tx_idx=tx_idx,
        )

    gene_idxs = index.txome.gene_intervals.find(gx_aln.ystart, gx_aln.yend)
    chr_aln = concat_to_chr_aln(index, gx_aln)
    if len(gene_idxs) == 0:
        return GenomeAlignment(
            gx_aln=chr_aln, aln_type=INTERGENIC, ref_name=ref_name, strand=strand
        )
    return GenomeAlignment(
        gx_aln=chr_aln,
        aln_type=INTRONIC,
        ref_name=ref_name,
        strand=strand,
        gene_idx=int(gene_idxs[0]),
    )


def filter_overlapping(alns: List[GenomeAlignment]) -> List[GenomeAlignment]:
    """Dedupe same-locus alignments keeping the max score
    (reference src/aligner.rs:317-349)."""
    if not alns:
        return alns
    alns = sorted(
        alns, key=lambda a: (a.ref_name, a.strand, a.gx_aln.ystart)
    )  # python sort is stable, matching Rust sort_by then-chaining
    max_end = 0
    res: List[GenomeAlignment] = []
    for aln in alns:
        if (
            aln.gx_aln.ystart >= max_end
            or aln.ref_name != res[-1].ref_name
            or aln.strand != res[-1].strand
        ):
            max_end = aln.gx_aln.yend
            res.append(aln)
        else:
            curr = res[-1]
            if aln.gx_aln.score > curr.gx_aln.score:
                res[-1] = aln
                curr = aln
            max_end = max(max_end, curr.gx_aln.yend)
    return res


def concat_to_chr_aln(index: Index, aln: Alignment) -> Alignment:
    """Concatenated coords → chromosome coords, normalising '-'-strand
    intervals to forward [left, right) and reversing ops
    (reference src/aligner.rs:429-449)."""
    aln_ref, _ = index.idx_to_ref(aln.ystart)
    out = aln.copy()
    if aln_ref.strand:
        out.ystart = aln.ystart - aln_ref.start_idx
        out.yend = aln.yend - aln_ref.start_idx
        out.ylen = aln_ref.len
    else:
        out.ystart = aln_ref.len - (aln.yend - aln_ref.start_idx)
        out.yend = aln_ref.len - (aln.ystart - aln_ref.start_idx)
        out.ylen = aln_ref.len
        out.operations = list(reversed(aln.operations))
    return out
