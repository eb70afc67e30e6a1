"""File-level alignment entry point of the port: FASTQ(s) in, PAF/SAM/BAM
out.

``engine="batch"`` runs the port's ``BatchAligner`` on ``device``
(records emitted by the C++ engine); ``engine="cpp"`` the all-C++ engine
(``align/cpu.py``, SAM/BAM only); ``engine="oracle"`` the sequential
oracle (``align/driver.py``).  Neither of the last two needs a device.
"""

from __future__ import annotations

import sys
from typing import Iterable

from ..index.build import Index
from ..io.bam import BamWriter
from ..io.fastx import parse_fastx
from ..io.paf import paf_line
from ..io.sam import SamWriter, aln_to_sam_record, unmapped_sam_record
from .driver import AlignOpts, OracleAligner

FORMAT_PAF = "paf"
FORMAT_SAM = "sam"
FORMAT_BAM = "bam"


def _count_records(query_paths) -> int:
    """Cheap record count for shard bounds: raw buffered line/record
    scan (FASTQ = lines/4, FASTA = '>' lines) instead of a full
    ``parse_fastx`` pass — shard mode otherwise parses every input
    twice per host."""
    from ..io.fastx import _open

    total = 0
    for p in query_paths:
        with _open(p) as fh:
            first = fh.peek(1)[:1]
            if first == b">":
                while True:
                    block = fh.read(1 << 20)
                    if not block:
                        break
                    total += block.count(b"\n>")
                total += 1  # first record has no preceding newline
            else:
                lines = 0
                while True:
                    block = fh.read(1 << 20)
                    if not block:
                        break
                    lines += block.count(b"\n")
                total += (lines + 3) // 4
    return total



def align_reads_from_file(
    index: Index,
    query_paths: Iterable[str],
    output_path: str,
    output_fmt: str,
    opts: AlignOpts,
    engine: str = "batch",
    batch_size: int = 16384,
    verbose: bool = False,
    device: str = "cuda",
    shard=None,
) -> None:
    """``shard=(host_id, num_hosts)`` aligns only this host's contiguous
    block of the input reads (``parallel.multihost.shard_bounds``), so
    merging the shards in host order restores the input order."""
    if engine == "oracle":
        aligner = run = fmt_code = None
    elif engine == "batch":
        from .batch import BatchAligner

        aligner = BatchAligner(index, opts, device=device)
        fmt_code = 2 if output_fmt == FORMAT_PAF else output_fmt == FORMAT_BAM
        run = aligner.align_batch_emit
    elif engine == "cpp":
        if output_fmt not in (FORMAT_SAM, FORMAT_BAM):
            raise ValueError("--engine cpp writes SAM/BAM only")
        from .cpu import CppAligner

        aligner = CppAligner(index, opts, threads=0)  # all cores
        fmt_code = output_fmt == FORMAT_BAM
        run = aligner.align_records
    else:
        raise ValueError(f"unknown engine {engine!r}")
    lo, hi = 0, None
    if shard is not None:
        from ..parallel.multihost import shard_bounds

        host_id, num_hosts = shard
        lo, hi = shard_bounds(_count_records(query_paths), num_hosts, host_id)

    def records():
        i = 0
        for path in query_paths:
            for rec in parse_fastx(path):
                if i >= lo and (hi is None or i < hi):
                    yield rec
                i += 1

    binary = output_fmt == FORMAT_BAM
    if output_path == "-":
        fh = sys.stdout.buffer if binary else sys.stdout
    else:
        fh = open(output_path, "wb" if binary else "w")
    try:
        if output_fmt == FORMAT_SAM:
            writer = SamWriter(fh, index)
        elif binary:
            writer = BamWriter(fh, index)
        else:
            writer = None
        if engine == "oracle":
            _oracle_run(index, records(), writer, fh, opts)
            return
        buf = []

        def flush():
            raw = run([(r.id, r.seq, r.qual) for r in buf], fmt_code)
            if writer is not None:
                writer.write_raw(raw)
            else:  # PAF: text handle, no header
                fh.write(raw.decode())

        for rec in records():
            buf.append(rec)
            if len(buf) >= batch_size:
                flush()
                buf = []
        if buf:
            flush()
        if writer is not None:
            writer.finish()
        if verbose:
            print(aligner.stats.report(), file=sys.stderr)
    finally:
        if fh is not sys.stdout and fh is not sys.stdout.buffer:
            fh.close()


def _oracle_run(index, records, writer, fh, opts) -> None:
    """The sequential oracle over ``records`` through the Python writers
    (``writer`` None: PAF lines to the text handle ``fh``)."""
    aligner = OracleAligner(index, opts)
    for rec in records:
        alns = aligner.align_read(rec.seq)
        qual = rec.qual if rec.qual is not None else b""
        if not alns:
            if writer is not None:
                writer.write(unmapped_sam_record(rec.id, rec.seq, qual))
            continue
        for i, aln in enumerate(alns):
            if writer is not None:
                writer.write(aln_to_sam_record(index, rec.id, rec.seq, qual,
                                               aln, len(alns), i + 1))
            else:
                fh.write(paf_line(rec.id, rec.seq, aln, len(alns)) + "\n")
    if writer is not None:
        writer.finish()
