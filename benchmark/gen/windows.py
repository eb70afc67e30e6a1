"""Reads drawn as windows of the genome: the generator of the ``se*``
mixes.

A read is a ``read_len`` window of a forward chromosome, the chromosome
drawn in proportion to its length (one chromosome: uniform windows of
it), with a uniform number of substitutions in ``substitutions``
([low, high]) at uniform positions to uniform bases, reverse-complemented
with probability ``reverse_share``.  Every base's quality is
``quality_char``, and read ``i`` of a batch is named ``name_format % i``,
as the repository's bench names and scores its reads.  The draws follow
the program's ``read_draws`` and ``make_truth_reads`` in distribution,
done in numpy for a whole batch (the same reads for the same seed and
batch).

Windows are read from the FASTA with ``os.pread`` at the offsets of the
genome's sidecar, so the generator keeps no copy of the genome in the
process.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

_ACGT = np.frombuffer(b"ACGT", np.uint8)
_COMP = np.arange(256, dtype=np.uint8)
_COMP[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)


def make_batch(genome: dict, traffic: dict, seed: int, stream: int,
               batch: int) -> List[Tuple[bytes, bytes, bytes]]:
    """The (name, seq, qual) records of batch ``batch`` of ``stream`` (0:
    the measured window; 1: set-up's warm-up) for ``seed``."""
    rng = np.random.default_rng([seed, stream, batch])
    n = traffic["batch_reads"]
    L = traffic["read_len"]
    chroms = [c for c in genome["chroms"] if c["len"] > L + 1]
    lens = np.array([c["len"] for c in chroms], np.int64)
    offs = np.array([c["offset"] for c in chroms], np.int64)
    ci = rng.choice(len(chroms), size=n, p=lens / lens.sum())
    start = rng.integers(0, lens[ci] - L - 1)
    lo, hi = traffic["substitutions"]
    nsub = rng.integers(lo, hi + 1, n)
    spos = rng.integers(0, L, (n, hi))
    sbase = _ACGT[rng.integers(0, 4, (n, hi))]
    rev = rng.random(n) < traffic["reverse_share"]

    fd = os.open(genome["fasta"], os.O_RDONLY)
    try:
        raw = b"".join(os.pread(fd, L, int(o)) for o in offs[ci] + start)
    finally:
        os.close(fd)
    seq = np.frombuffer(raw, np.uint8).reshape(n, L).copy()
    rows = np.arange(n)
    for t in range(hi):
        m = t < nsub
        seq[rows[m], spos[m, t]] = sbase[m, t]
    seq[rev] = _COMP[seq[rev, ::-1]]
    sb = seq.tobytes()
    qual = traffic["quality_char"].encode() * L
    fmt = traffic["name_format"].encode()
    return [(fmt % i, sb[i * L:(i + 1) * L], qual) for i in range(n)]
