"""File-level alignment entry point of the port: FASTQ(s) in, PAF/SAM/BAM
out.

``engine="batch"`` runs the port's ``BatchAligner`` on ``device`` (the
reference ``align/run.py`` batch path, records emitted by the C++
engine); ``engine="cpp"`` the all-C++ engine (``align/cpu.py``, SAM/BAM
only); ``engine="oracle"`` the reference's sequential oracle.  Neither
of the last two needs a device.
"""

from __future__ import annotations

import sys
from typing import Iterable

from thermite_tpu.align.driver import AlignOpts
from thermite_tpu.align.run import FORMAT_BAM, FORMAT_PAF, FORMAT_SAM
from thermite_tpu.index.build import Index
from thermite_tpu.io.bam import BamWriter
from thermite_tpu.io.fastx import parse_fastx
from thermite_tpu.io.sam import SamWriter

__all__ = ["FORMAT_BAM", "FORMAT_PAF", "FORMAT_SAM", "align_reads_from_file"]


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
        from thermite_tpu.align.run import align_reads_from_file as oracle_run

        oracle_run(index, query_paths, output_path, output_fmt, opts,
                   engine="oracle", batch_size=batch_size, verbose=verbose,
                   shard=shard)
        return
    if engine == "batch":
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
        from thermite_tpu.align.run import _count_records
        from thermite_tpu.parallel.multihost import shard_bounds

        host_id, num_hosts = shard
        lo, hi = shard_bounds(_count_records(query_paths), num_hosts, host_id)

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
        buf = []

        def flush():
            raw = run([(r.id, r.seq, r.qual) for r in buf], fmt_code)
            if writer is not None:
                writer.write_raw(raw)
            else:  # PAF: text handle, no header
                fh.write(raw.decode())

        i = 0
        for path in query_paths:
            for rec in parse_fastx(path):
                if i >= lo and (hi is None or i < hi):
                    buf.append(rec)
                    if len(buf) >= batch_size:
                        flush()
                        buf = []
                i += 1
        if buf:
            flush()
        if writer is not None:
            writer.finish()
        if verbose:
            print(aligner.stats.report(), file=sys.stderr)
    finally:
        if fh is not sys.stdout and fh is not sys.stdout.buffer:
            fh.close()
