"""File-level alignment entry point of the port: FASTQ(s) in, PAF/SAM/BAM
out.

``engine="batch"``, the default, runs the port's ``BatchAligner`` on
``device`` (or on the devices of ``mesh``); its records are emitted by the
C++ engine, or, when ``THERMITE_NO_EMIT`` is set, built as objects by
``align_batch`` and written by the Python writers: the same bytes.  ``engine="cpp"`` is the all-C++ engine
(``align/cpu.py``, SAM/BAM only); ``engine="oracle"`` the sequential
oracle (``OracleAligner``).  Neither of the last two needs a device, so
neither is the default here, where the reference's is the oracle: a call
with the defaults runs on the card.
"""

from __future__ import annotations

import os
import sys
from contextlib import nullcontext
from typing import Iterable, Optional

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


def emit_in_cpp() -> bool:
    """Whether a batch run's records come from the aligner's emit methods
    (the C++ emitter).  Under ``THERMITE_NO_EMIT`` they are built as
    objects by ``align_batch`` and written by the Python writers instead:
    the reference's switch for telling a fault of the emitter from one of
    the pipeline, with the same bytes either way."""
    return not os.environ.get("THERMITE_NO_EMIT")


def profile_to(profile_dir: Optional[str], engine: str, device, mesh):
    """The context a file entry point runs in: ``torch.profiler`` when
    ``profile_dir`` is given (CPU activity; CUDA too when the batch
    engine runs on a card), writing one Chrome trace file into it at the
    end; else nothing."""
    if not profile_dir:
        return nullcontext()
    import torch

    from ..utils.profile import traced_to

    dev = torch.device(mesh[0] if mesh else device)
    return traced_to(profile_dir, engine == "batch" and dev.type == "cuda")


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
    mesh=None,
    profile_dir: Optional[str] = None,
) -> None:
    """``shard=(host_id, num_hosts)`` aligns only this host's contiguous
    block of the input reads (``parallel.multihost.shard_bounds``), so
    merging the shards in host order restores the input order.  ``mesh``
    (``parallel.mesh.make_mesh``) goes to ``BatchAligner``.
    ``profile_dir`` traces the run (``profile_to``); the output does not
    change."""
    with profile_to(profile_dir, engine, device, mesh):
        _align_reads(index, query_paths, output_path, output_fmt, opts,
                     engine, batch_size, verbose, device, shard, mesh)


def _align_reads(index, query_paths, output_path, output_fmt, opts, engine,
                 batch_size, verbose, device, shard, mesh) -> None:
    run = fmt_code = None
    if engine == "oracle":
        aligner = OracleAligner(index, opts)
    elif engine == "batch":
        from .batch import BatchAligner

        aligner = BatchAligner(index, opts, device=device, mesh=mesh)
        if emit_in_cpp():
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

    def batches():
        buf = []
        for rec in records():
            buf.append(rec)
            if len(buf) >= batch_size:
                yield buf
                buf = []
        if buf:
            yield buf

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
        if run is not None:
            for buf in batches():
                raw = run([(r.id, r.seq, r.qual) for r in buf], fmt_code)
                if writer is not None:
                    writer.write_raw(raw)
                else:  # PAF: text handle, no header
                    fh.write(raw.decode())
        elif engine == "oracle":
            _write_records(index, ((rec, aligner.align_read(rec.seq))
                                   for rec in records()), writer, fh)
        else:  # the batch engine's objects through the Python writers
            _write_records(
                index,
                (pair for buf in batches() for pair in
                 zip(buf, aligner.align_batch([r.seq for r in buf]))),
                writer, fh)
        if writer is not None:
            writer.finish()
        if verbose and engine != "oracle":
            print(aligner.stats.report(), file=sys.stderr)
    finally:
        if fh is not sys.stdout and fh is not sys.stdout.buffer:
            fh.close()


def _write_records(index, results, writer, fh) -> None:
    """``results`` yields (record, its alignments); each goes through the
    Python writers (``writer`` None: PAF lines to the text handle
    ``fh``)."""
    for rec, alns in results:
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
