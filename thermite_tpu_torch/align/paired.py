"""Paired-end alignment of the port: two mate FASTQs in, SAM/BAM out.

The pairing itself is the reference's host code, imported and not
copied: ``pair_records`` (FR pair selection, mate fields, mate rescue),
``iter_read_pairs`` and the shard bounds.  This module owns what builds
the port's aligners: the file entry point (reference
``thermite_tpu/align/paired.py:326-509``) and the serializer that the
paired emit paths splice into the C++ engine's bytes.
"""

from __future__ import annotations

import sys
from typing import Callable, NamedTuple

import numpy as np

from thermite_tpu.align.paired import iter_read_pairs, pair_records
from thermite_tpu.align.run import FORMAT_BAM, FORMAT_SAM
from thermite_tpu.io.bam import BamWriter, encode_bam_record
from thermite_tpu.io.sam import SamWriter, unique_refs

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
) -> None:
    """Paired-end file entry point: SAM/BAM out (PAF has no mate fields).

    ``engine``: ``batch`` runs the port's ``BatchAligner.align_paired_emit``
    on ``device``; ``cpp`` the all-C++ engine (``align/cpu.py``);
    ``oracle`` the reference's sequential aligner.  Pairs are flushed
    ``batch_size // 2`` at a time (both mates count against the batch).
    ``shard=(host_id, num_hosts)`` aligns only this host's contiguous
    block of pairs, so ``merge`` restores the input order."""
    if output_fmt not in (FORMAT_SAM, FORMAT_BAM):
        raise ValueError("paired mode writes SAM/BAM only")
    if engine not in ("batch", "cpp", "oracle"):
        raise ValueError(f"engine {engine!r} does not support paired mode "
                         "(oracle, batch and cpp do)")
    lo, hi = 0, None
    if shard is not None:
        from thermite_tpu.align.run import _count_records
        from thermite_tpu.parallel.multihost import shard_bounds

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
            from thermite_tpu.align.driver import OracleAligner

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

                aligner = BatchAligner(index, opts, device=device)
                run = aligner.align_paired_emit
            else:
                from .cpu import CppAligner

                aligner = CppAligner(index, opts, threads=0)  # all cores
                run = aligner.align_records_paired
            stats = aligner.stats
            for buf in batches():
                writer.write_raw(run(buf, binary, max_insert=max_insert,
                                     mate_rescue=mate_rescue))
        writer.finish()
        if verbose and stats is not None:
            print(stats.report(), file=sys.stderr)
    finally:
        if fh is not sys.stdout and fh is not sys.stdout.buffer:
            fh.close()
