"""Reads of mixed length drawn as windows of the genome: the generator of
the ``mix150`` mix.

A read is ``long`` bases with probability ``long_share``, else a uniform
length in ``short`` ([low, high]); its source is a window of a forward
chromosome, the chromosome drawn in proportion to its length.  Errors
are ``errors.mutate``'s (substitutions, one indel, one N), and the read
is reverse-complemented with probability ``reverse_share``.  Every
base's quality is ``quality_char`` and read ``i`` of a batch is named
``name_format % i``, as in the ``se*`` mixes (``windows.py``); the reads
of a length share one quality string, and every batch the same names, so
the batches a run keeps for its check hold little besides sequences.
Windows are read from the FASTA with ``os.pread``; the same seed and
batch give the same reads.
"""

from __future__ import annotations

import functools
import os
from typing import List, Tuple

import numpy as np

from benchmark.gen.errors import COMP, SRC_PAD, mutate


@functools.lru_cache(maxsize=2)
def names(fmt: str, n: int) -> Tuple[bytes, ...]:
    """``fmt % i`` for each read ``i`` of a batch of ``n``."""
    f = fmt.encode()
    return tuple(f % i for i in range(n))


def make_batch(genome: dict, traffic: dict, seed: int, stream: int,
               batch: int) -> List[Tuple[bytes, bytes, bytes]]:
    """The (name, seq, qual) records of batch ``batch`` of ``stream`` (0:
    the measured window; 1: set-up's warm-up) for ``seed``."""
    rng = np.random.default_rng([seed, stream, batch])
    n = traffic["batch_reads"]
    ln = traffic["lengths"]
    lo, hi = ln["short"]
    lens = np.where(rng.random(n) < ln["long_share"], ln["long"],
                    rng.integers(lo, hi + 1, n)).astype(np.int64)
    W = int(lens.max()) + SRC_PAD
    chroms = [c for c in genome["chroms"] if c["len"] > W + 1]
    clen = np.array([c["len"] for c in chroms], np.int64)
    offs = np.array([c["offset"] for c in chroms], np.int64)
    ci = rng.choice(len(chroms), size=n, p=clen / clen.sum())
    start = rng.integers(0, clen[ci] - W - 1)
    rev = rng.random(n) < traffic["reverse_share"]

    fd = os.open(genome["fasta"], os.O_RDONLY)
    try:
        raw = b"".join(os.pread(fd, W, int(o)) for o in offs[ci] + start)
    finally:
        os.close(fd)
    src = np.frombuffer(raw, np.uint8).reshape(n, W)
    seq, _, _ = mutate(rng, src, lens, traffic["errors"])
    r = np.flatnonzero(rev)
    back = lens[r, None] - 1 - np.arange(seq.shape[1])
    sub = seq[r]
    seq[r] = np.where(back >= 0, COMP[np.take_along_axis(
        sub, np.maximum(back, 0), 1)], sub)
    q = traffic["quality_char"].encode()
    lens = lens.tolist()
    qual = {L: q * L for L in set(lens)}
    sb, w = seq.tobytes(), seq.shape[1]
    return [(nm, sb[i * w : i * w + L], qual[L])
            for i, (nm, L) in enumerate(zip(names(traffic["name_format"], n),
                                            lens))]
