"""FASTA / FASTQ parsing (gzip-transparent).

Covers the capability the reference outsources to the `needletail`
crate (reference src/index.rs:58, src/aligner.rs:52): streaming
records from plain or gzipped FASTA/FASTQ files, auto-detected by
content.
"""

from __future__ import annotations

import gzip
import io
from dataclasses import dataclass
from typing import Iterator, Optional


@dataclass
class SeqRecord:
    id: bytes  # full header line after '>'/'@' (first token + rest)
    seq: bytes
    qual: Optional[bytes] = None


def _open(path: str) -> io.BufferedReader:
    f = open(path, "rb")
    magic = f.peek(2)[:2]
    if magic == b"\x1f\x8b":
        # reuse the already-open handle (opening the path again would
        # leak this fd until GC)
        return io.BufferedReader(gzip.GzipFile(fileobj=f))
    return f


def parse_fastx(path: str) -> Iterator[SeqRecord]:
    """Stream records from a FASTA or FASTQ file (gzip ok)."""
    with _open(path) as f:
        first = f.peek(1)[:1] if hasattr(f, "peek") else b""
        if first == b">":
            yield from _parse_fasta(f)
        elif first == b"@":
            yield from _parse_fastq(f)
        elif first == b"":
            return
        else:
            raise ValueError(f"{path}: not FASTA or FASTQ (starts with {first!r})")


def _parse_fasta(f) -> Iterator[SeqRecord]:
    header = None
    chunks = []
    for line in f:
        line = line.rstrip(b"\r\n")
        if line.startswith(b">"):
            if header is not None:
                yield SeqRecord(id=header, seq=b"".join(chunks))
            header = line[1:]
            chunks = []
        elif line:
            chunks.append(line)
    if header is not None:
        yield SeqRecord(id=header, seq=b"".join(chunks))


def _parse_fastq(f) -> Iterator[SeqRecord]:
    while True:
        header = f.readline().rstrip(b"\r\n")
        if not header:
            return
        if not header.startswith(b"@"):
            raise ValueError(f"bad FASTQ header line: {header!r}")
        seq = f.readline().rstrip(b"\r\n")
        plus = f.readline()
        if not plus.startswith(b"+"):
            raise ValueError("bad FASTQ separator line")
        qual = f.readline().rstrip(b"\r\n")
        if len(qual) != len(seq):
            raise ValueError("FASTQ qual length != seq length")
        yield SeqRecord(id=header[1:], seq=seq, qual=qual)


_RC = bytes.maketrans(
    b"ACGTUNacgtunRYSWKMBDHVryswkmbdhv",
    b"TGCAANtgcaanYRSWMKVHDByrswmkvhdb",
)


def revcomp(seq: bytes) -> bytes:
    """Reverse complement (IUPAC-aware, like rust-bio dna::revcomp)."""
    return seq.translate(_RC)[::-1]
