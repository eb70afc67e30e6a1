"""Paired-end alignment of the port: two mate FASTQs in, SAM/BAM out.

Both mates are aligned independently by any engine (oracle / batch /
cpp: identical per-mate results), then pair selection and the SAM mate
fields (flags 0x1/0x2/0x8/0x20/0x40/0x80, RNEXT/PNEXT/TLEN) are computed
on the host here.

Pairing rules (the BWA/STAR-standard FR contract):
* a *proper pair* is two mapped mates on the SAME chromosome with
  OPPOSITE strands in forward-reverse orientation (the forward mate's
  start is not past the reverse mate's end) whose outer span
  (template length) is <= ``max_insert``;
* among all candidate combinations of the two mates' alignments the
  pair maximizing summed alignment score wins (ties: the combination
  of the earliest-ranked alignments, preserving each engine's
  deterministic ordering);
* when no proper pair exists each mate keeps its own primary
  alignment; mate fields still link the two records ("orphan" pairing
  — flags carry 0x1 but not 0x2);
* an unmapped mate with a mapped partner is emitted AT the partner's
  coordinates (rname/pos equal, flag 0x4 set, cigar "*") so sorted
  BAMs keep pairs adjacent.

Mate rescue (``rescue_mate``): when one mate maps and the other finds
no alignment at all, the lost mate is searched ONLY inside the mapped
mate's FR insert window with a much weaker seed (k = 12), and the
rescued alignment goes through the same ``align_seed_hit`` rules as the
main pipeline.  ``pair_records`` is the referee that the C++ pairing of
the batch and cpp engines is held against; this module also owns the
file entry point and the serializer that the paired emit paths splice
into the C++ engine's bytes.
"""

from __future__ import annotations

import sys
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np

from ..io.bam import BamWriter, encode_bam_record
from ..io.sam import (
    SamRecord,
    SamWriter,
    aln_to_sam_record,
    unique_refs,
    unmapped_sam_record,
)
from .run import FORMAT_BAM, FORMAT_SAM, _count_records, emit_in_cpp, profile_to

FLAG_PAIRED = 0x1
FLAG_PROPER = 0x2
FLAG_UNMAPPED = 0x4
FLAG_MATE_UNMAPPED = 0x8
FLAG_REVERSE = 0x10
FLAG_MATE_REVERSE = 0x20
FLAG_READ1 = 0x40
FLAG_READ2 = 0x80

# combinatorial cap: a repeat-pathological read pair could offer
# thousands of alignment combinations; past this many per mate the
# tail alignments cannot win anyway (lists are score-ordered)
_MAX_CANDIDATES = 64


def _span(a) -> Tuple[int, int]:
    """[start, end) of the alignment on the chromosome forward strand."""
    return a.gx_aln.ystart, a.gx_aln.yend


def is_proper(a1, a2, max_insert: int) -> bool:
    """FR proper-pair test (see module docstring)."""
    if a1.ref_name != a2.ref_name or a1.strand == a2.strand:
        return False
    fwd, rev = (a1, a2) if a1.strand else (a2, a1)
    fs, fe = _span(fwd)
    rs, rend = _span(rev)
    if fs > rend:  # forward mate starts past the reverse mate's end
        return False
    tlen = max(rend, fe) - min(fs, rs)
    return 0 < tlen <= max_insert


def template_len(a1, a2) -> int:
    """Signed TLEN for mate 1 (mate 2 gets the negation): outer span,
    positive for the leftmost mate (ties: positive for mate 1)."""
    s1, e1 = _span(a1)
    s2, e2 = _span(a2)
    span = max(e1, e2) - min(s1, s2)
    if (s1, e1) <= (s2, e2):
        return span
    return -span


def select_pair(
    alns1: List, alns2: List, max_insert: int
) -> Tuple[Optional[int], Optional[int], bool]:
    """Choose the output pair: indices into each mate's alignment list
    plus the proper flag.  ``None`` marks an unmapped mate."""
    if not alns1 or not alns2:
        return (0 if alns1 else None), (0 if alns2 else None), False
    best = None  # (score_sum, -i, -j) maximized
    bi = bj = 0
    for i, a1 in enumerate(alns1[:_MAX_CANDIDATES]):
        for j, a2 in enumerate(alns2[:_MAX_CANDIDATES]):
            if not is_proper(a1, a2, max_insert):
                continue
            key = (a1.gx_aln.score + a2.gx_aln.score, -i, -j)
            if best is None or key > best:
                best = key
                bi, bj = i, j
    if best is None:
        return 0, 0, False
    return bi, bj, True


# mate-rescue knobs: a deliberately weaker seed than the main pipeline
# (the insert window is ~1 kb, so a 12-mer cannot hit genome-wide
# repeats the way it would in full seeding), capped fan-out for repeaty
# windows, and at most this many anchor alignments of the mapped mate
_RESCUE_K = 12
_RESCUE_MAX_SEEDS = 8
_RESCUE_MAX_ANCHORS = 4


def _window_seeds(window: bytes, read: bytes, k: int) -> List[Tuple[int, int, int]]:
    """Maximal exact matches of the read inside a small window, one per
    diagonal (longest wins): [(win_off, query_idx, len)], longest first."""
    best = {}  # diagonal -> (len, win_off, q_idx)
    n, m = len(window), len(read)
    for q in range(0, m - k + 1):
        kmer = read[q : q + k]
        off = window.find(kmer)
        while off >= 0:
            diag = off - q
            seen = best.get(diag)
            if seen is None or not (seen[1] <= off < seen[1] + seen[0]):
                # extend the exact match maximally both ways
                lo = 0
                while q - lo > 0 and off - lo > 0 and read[q - lo - 1] == window[off - lo - 1]:
                    lo += 1
                hi = k
                while q + hi < m and off + hi < n and read[q + hi] == window[off + hi]:
                    hi += 1
                cand = (lo + hi, off - lo, q - lo)
                if seen is None or cand[0] > seen[0]:
                    best[diag] = cand
            off = window.find(kmer, off + 1)
    seeds = [(o, q, ln) for ln, o, q in best.values()]
    seeds.sort(key=lambda s: (-s[2], s[0], s[1]))  # longest, then leftmost
    return seeds[:_RESCUE_MAX_SEEDS]


def rescue_mate(index, read: bytes, anchors: List, max_insert: int, opts):
    """Find the lost mate inside a mapped mate's FR insert window.

    ``anchors`` is the mapped mate's (score-ordered) alignment list;
    the first ``_RESCUE_MAX_ANCHORS`` are each tried as the pair
    anchor.  Returns the best ``GenomeAlignment`` meeting the
    pipeline's score threshold (``max(pct*len, min_aln_score)``, the
    same rule as ``align_read``) and, unless ``opts.intron_mode``, the
    exonic-only rule — or None."""
    from ..ops.swg_ref import SwgExtend
    from .driver import align_seed_hit
    from .types import EXONIC, Mem

    read = read.upper()
    if len(read) < _RESCUE_K:
        return None
    min_score = max(
        int(opts.min_aln_score_percent * float(len(read))), opts.min_aln_score
    )
    band = max(len(read) - min_score, 0)
    swg = SwgExtend(band)
    copies = {(r.name, r.strand): r for r in index.refs}

    best = None
    for a in anchors[:_RESCUE_MAX_ANCHORS]:
        # FR window on chromosome-forward coordinates
        s, e = a.gx_aln.ystart, a.gx_aln.yend
        L = a.gx_aln.ylen
        if a.strand:  # anchor forward -> mate reverse, downstream
            ws, we = s, min(L, s + max_insert)
        else:  # anchor reverse -> mate forward, upstream
            ws, we = max(0, e - max_insert), e
        r = copies.get((a.ref_name, not a.strand))
        if r is None or we - ws < _RESCUE_K:
            continue
        # map the window onto the mate's strand copy of the
        # concatenated text (reads are always aligned forward against
        # a copy; '-'-strand placement comes from hitting the rc copy)
        if r.strand:
            lo = r.start_idx + ws
            hi = r.start_idx + we
        else:
            lo = r.start_idx + (L - we)
            hi = r.start_idx + (L - ws)
        window = index.seq_slice(lo, hi)
        for off, q, ln in _window_seeds(window, read, _RESCUE_K):
            hit = Mem(ref_idx=lo + off, query_idx=q, len=ln)
            g = align_seed_hit(index, read, hit, swg, band, band)
            if g.gx_aln.score < min_score:
                continue
            if not opts.intron_mode and g.aln_type != EXONIC:
                continue
            if best is None or g.gx_aln.score > best.gx_aln.score:
                best = g
    if best is not None:
        best.primary = True
    return best


def _reorder_primary(alns: List, chosen: int) -> List:
    """Move the chosen alignment to the front as primary; everything
    else becomes secondary.  Copies the dataclasses so the per-mate
    results stay untouched."""
    from dataclasses import replace

    out = []
    order = [chosen] + [k for k in range(len(alns)) if k != chosen]
    for rank, k in enumerate(order):
        out.append(replace(alns[k], primary=(rank == 0)))
    return out


def pair_records(
    index,
    rec1,
    rec2,
    alns1: List,
    alns2: List,
    max_insert: int = 1000,
    rescue_opts=None,
) -> List[SamRecord]:
    """All SAM records for one read pair, mate fields filled.

    ``rec1``/``rec2`` are FASTX records (``.id``/``.seq``/``.qual``);
    ``alns1``/``alns2`` the per-mate results from any engine.  With
    ``rescue_opts`` (an ``AlignOpts``), a mate with no alignments is
    searched for inside its mapped partner's insert window first
    (``rescue_mate``)."""
    if rescue_opts is not None:
        if alns1 and not alns2:
            r = rescue_mate(index, rec2.seq, alns1, max_insert, rescue_opts)
            if r is not None:
                alns2 = [r]
        elif alns2 and not alns1:
            r = rescue_mate(index, rec1.seq, alns2, max_insert, rescue_opts)
            if r is not None:
                alns1 = [r]
    i1, i2, proper = select_pair(alns1, alns2, max_insert)
    out: List[SamRecord] = []

    a1 = alns1[i1] if i1 is not None else None
    a2 = alns2[i2] if i2 is not None else None
    ordered1 = _reorder_primary(alns1, i1) if a1 is not None else []
    ordered2 = _reorder_primary(alns2, i2) if a2 is not None else []
    tlen = template_len(a1, a2) if proper else 0

    for mate_flag, rec, ordered, mine, mate in (
        (FLAG_READ1, rec1, ordered1, a1, a2),
        (FLAG_READ2, rec2, ordered2, a2, a1),
    ):
        qual = rec.qual if rec.qual is not None else b""
        base = FLAG_PAIRED | mate_flag
        if mate is None:
            base |= FLAG_MATE_UNMAPPED
        elif not mate.strand:
            base |= FLAG_MATE_REVERSE
        if mine is None:
            # unmapped mate: placed at the mapped partner's primary
            # coordinates when one exists (see module docstring)
            r = unmapped_sam_record(rec.id, rec.seq, qual)
            r.flag |= base
            if mate is not None:
                r.rname = mate.ref_name
                r.pos = mate.gx_aln.ystart + 1
                r.rnext = "="
                r.pnext = mate.gx_aln.ystart + 1
            out.append(r)
            continue
        for k, aln in enumerate(ordered):
            r = aln_to_sam_record(
                index, rec.id, rec.seq, qual, aln, len(ordered), k + 1
            )
            r.flag |= base
            if proper and k == 0:
                r.flag |= FLAG_PROPER
            if mate is not None:
                r.rnext = "=" if mate.ref_name == aln.ref_name else mate.ref_name
                r.pnext = mate.gx_aln.ystart + 1
                if proper and k == 0:
                    r.tlen = tlen if mate_flag == FLAG_READ1 else -tlen
            else:
                # mate unmapped: it is placed at THIS mate's primary
                # position, so records point back at themselves
                r.rnext = "="
                r.pnext = aln.gx_aln.ystart + 1
            out.append(r)
    return out


def iter_read_pairs(path1: str, path2: str):
    """Lockstep iteration over the two mate files; raises on length
    mismatch (a truncated R2 silently mispairing every later read is
    the classic paired-FASTQ corruption)."""
    from ..io.fastx import parse_fastx

    it1 = parse_fastx(path1)
    it2 = parse_fastx(path2)
    sentinel = object()
    n = 0
    while True:
        r1 = next(it1, sentinel)
        r2 = next(it2, sentinel)
        if r1 is sentinel and r2 is sentinel:
            return
        if r1 is sentinel or r2 is sentinel:
            short = path1 if r1 is sentinel else path2
            raise ValueError(
                f"paired inputs differ in length: {short} ended after "
                f"{n} records"
            )
        n += 1
        yield r1, r2




# tags the embedding surface drops (reference src/wrapper.rs:136-139)
STRIP_TAGS = frozenset({"TX", "GX", "GN", "RE"})


class _Rec(NamedTuple):
    id: bytes
    seq: bytes
    qual: bytes


def pair_serializer(index, fmt_bam, max_insert: int, rescue_opts,
                    strip_tags: bool) -> Callable:
    """-> ser(rec1, rec2, alns1, alns2) -> bytes: one pair's records by
    ``pair_records`` (mate rescue with ``rescue_opts``, none if None) and
    the Python writers; rec1/rec2 are (name, seq, qual) tuples."""
    ref_ids = {n: i for i, (n, _) in enumerate(unique_refs(index))}

    def ser(rec1, rec2, alns1, alns2) -> bytes:
        out = []
        for rec in pair_records(index, _Rec(*rec1), _Rec(*rec2), alns1,
                                alns2, max_insert, rescue_opts=rescue_opts):
            if strip_tags:
                rec.tags = [t for t in rec.tags if t[0] not in STRIP_TAGS]
            out.append(encode_bam_record(rec, ref_ids) if fmt_bam
                       else (rec.to_line() + "\n").encode())
        return b"".join(out)

    return ser


def splice_pairs(raw: bytes, pairs_idx: np.ndarray, offs: np.ndarray,
                 pair_bytes: Callable[[int], bytes]) -> bytes:
    """A chunk's C++-emitted bytes with the records of the pairs it left
    to the host (``pair_bytes(p)``) spliced in at their byte offsets."""
    parts, prev = [], 0
    for p, off in zip(pairs_idx.tolist(), offs.tolist()):
        parts.append(raw[prev:off])
        parts.append(pair_bytes(p))
        prev = off
    parts.append(raw[prev:])
    return b"".join(parts)


def align_paired_from_files(
    index,
    path1: str,
    path2: str,
    output_path: str,
    output_fmt: str,
    opts,
    engine: str = "batch",
    batch_size: int = 16384,
    max_insert: int = 1000,
    verbose: bool = False,
    shard=None,
    mate_rescue: bool = True,
    device: str = "cuda",
    mesh=None,
    profile_dir=None,
) -> None:
    """Paired-end file entry point: SAM/BAM out (PAF has no mate fields).

    ``engine``: ``batch`` runs the port's ``BatchAligner.align_paired_emit``
    on ``device`` (or on the devices of ``mesh``), or, when
    ``THERMITE_NO_EMIT`` is set (``run.emit_in_cpp``), ``align_batch`` on the interleaved mates with ``pair_records`` and the
    Python writers (the same bytes); ``cpp`` the all-C++ engine
    (``align/cpu.py``); ``oracle`` the sequential aligner
    (``align/driver.py``).  Pairs are flushed
    ``batch_size // 2`` at a time (both mates count against the batch).
    ``shard=(host_id, num_hosts)`` aligns only this host's contiguous
    block of pairs, so ``merge`` restores the input order.
    ``profile_dir`` traces the run (``run.profile_to``)."""
    if output_fmt not in (FORMAT_SAM, FORMAT_BAM):
        raise ValueError("paired mode writes SAM/BAM only")
    if engine not in ("batch", "cpp", "oracle"):
        raise ValueError(f"engine {engine!r} does not support paired mode "
                         "(oracle, batch and cpp do)")
    with profile_to(profile_dir, engine, device, mesh):
        _align_pairs(index, path1, path2, output_path, output_fmt, opts,
                     engine, batch_size, max_insert, verbose, shard,
                     mate_rescue, device, mesh)


def _align_pairs(index, path1, path2, output_path, output_fmt, opts, engine,
                 batch_size, max_insert, verbose, shard, mate_rescue, device,
                 mesh) -> None:
    lo, hi = 0, None
    if shard is not None:
        from ..parallel.multihost import shard_bounds

        host_id, num_hosts = shard
        lo, hi = shard_bounds(_count_records([path1]), num_hosts, host_id)

    def batches():
        buf = []
        for i, (r1, r2) in enumerate(iter_read_pairs(path1, path2)):
            if i >= lo and (hi is None or i < hi):
                buf.append(((r1.id, r1.seq, r1.qual), (r2.id, r2.seq, r2.qual)))
                if len(buf) >= max(batch_size // 2, 1):
                    yield buf
                    buf = []
        if buf:
            yield buf

    binary = output_fmt == FORMAT_BAM
    rescue_opts = opts if mate_rescue else None
    fh = (sys.stdout.buffer if binary else sys.stdout) if output_path == "-" \
        else open(output_path, "wb" if binary else "w")
    try:
        writer = BamWriter(fh, index) if binary else SamWriter(fh, index)
        stats = None
        if engine == "oracle":
            from .driver import OracleAligner

            oracle = OracleAligner(index, opts)
            for buf in batches():
                for r1, r2 in buf:
                    for rec in pair_records(
                        index, _Rec(*r1), _Rec(*r2), oracle.align_read(r1[1]),
                        oracle.align_read(r2[1]), max_insert,
                        rescue_opts=rescue_opts,
                    ):
                        writer.write(rec)
        else:
            if engine == "batch":
                from .batch import BatchAligner

                aligner = BatchAligner(index, opts, device=device, mesh=mesh)
                run = aligner.align_paired_emit if emit_in_cpp() else None
            else:
                from .cpu import CppAligner

                aligner = CppAligner(index, opts, threads=0)  # all cores
                run = aligner.align_records_paired
            stats = aligner.stats
            for buf in batches():
                if run is not None:
                    writer.write_raw(run(buf, binary, max_insert=max_insert,
                                         mate_rescue=mate_rescue))
                    continue
                # objects: both mates ride one interleaved batch, R1 at
                # even slots, R2 at odd
                res = aligner.align_batch([m[1] for pair in buf for m in pair])
                for k, (r1, r2) in enumerate(buf):
                    for rec in pair_records(
                        index, _Rec(*r1), _Rec(*r2), res[2 * k],
                        res[2 * k + 1], max_insert, rescue_opts=rescue_opts,
                    ):
                        writer.write(rec)
        writer.finish()
        if verbose and stats is not None:
            print(stats.report(), file=sys.stderr)
    finally:
        if fh is not sys.stdout and fh is not sys.stdout.buffer:
            fh.close()
