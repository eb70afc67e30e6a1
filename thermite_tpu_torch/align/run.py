"""File-level alignment entry point of the port: FASTQ(s) in, PAF/SAM/BAM
out.

``engine="batch"`` runs the port's ``BatchAligner`` on ``device`` (the
reference ``align/run.py`` batch path, records emitted by the C++
engine); ``engine="oracle"`` runs the reference's sequential oracle,
which needs no device.
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
) -> None:
    if engine == "oracle":
        from thermite_tpu.align.run import align_reads_from_file as oracle_run

        oracle_run(index, query_paths, output_path, output_fmt, opts,
                   engine="oracle", batch_size=batch_size, verbose=verbose)
        return
    if engine != "batch":
        raise ValueError(f"unknown engine {engine!r}")
    from .batch import BatchAligner

    batcher = BatchAligner(index, opts, device=device)
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
        fmt_code = 2 if output_fmt == FORMAT_PAF else binary
        buf = []

        def flush():
            raw = batcher.align_batch_emit(
                [(r.id, r.seq, r.qual) for r in buf], fmt_code
            )
            if writer is not None:
                writer.write_raw(raw)
            else:  # PAF: text handle, no header
                fh.write(raw.decode())

        for path in query_paths:
            for rec in parse_fastx(path):
                buf.append(rec)
                if len(buf) >= batch_size:
                    flush()
                    buf = []
        if buf:
            flush()
        if writer is not None:
            writer.finish()
        if verbose:
            print(batcher.stats.report(), file=sys.stderr)
    finally:
        if fh is not sys.stdout and fh is not sys.stdout.buffer:
            fh.close()
