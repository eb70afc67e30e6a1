"""Sequencing errors and read metadata that the read generators share.

``mutate`` turns each read's source bases into its sequence: one indel
(a deletion or an insertion of ``indel_len`` bases, equally likely, at a
uniform position inside the read) with probability ``indel_share``, then
a uniform number of substitutions in ``substitutions`` ([low, high]) at
uniform positions to uniform bases, then one ``N`` at a uniform position
with probability ``n_share``.  A read's source holds ``SRC_PAD`` bases
past its length, so a deletion still leaves it whole.  ``binned_quals``
gives NovaSeq-binned qualities, ``illumina_names`` Illumina-style names.
Every draw is made for the whole batch whatever the branch, so the same
generator state gives the same reads.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = np.arange(256, dtype=np.uint8)
COMP[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA", np.uint8)
SRC_PAD = 3  # source bases past a read's length: the longest deletion


def mutate(rng: np.random.Generator, src: np.ndarray, lens: np.ndarray,
           spec: dict) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """-> ((n, max len) uint8 sequences, each read's N position or -1,
    each read's indel: +k inserted bases, -k deleted, 0 none) from ``src`` ((n, max len + SRC_PAD) source bases, 5' first) and the
    read lengths ``lens``; ``spec`` holds ``substitutions``,
    ``indel_share``, ``indel_len`` and ``n_share``."""
    n = len(lens)
    kmin, kmax = spec["indel_len"]
    if kmax > SRC_PAD or src.shape[1] < lens.max() + SRC_PAD:
        raise ValueError("a read's source is shorter than its longest deletion")
    has_indel = rng.random(n) < spec["indel_share"]
    klen = rng.integers(kmin, kmax + 1, n)
    is_del = rng.random(n) < 0.5
    ipos = rng.integers(1, lens)
    ins = ACGT[rng.integers(0, 4, (n, kmax))]
    lo, hi = spec["substitutions"]
    nsub = rng.integers(lo, hi + 1, n)
    spos = (rng.random((n, hi)) * lens[:, None]).astype(np.int64)
    sbase = ACGT[rng.integers(0, 4, (n, hi))]
    has_n = rng.random(n) < spec["n_share"]
    npos = (rng.random(n) * lens).astype(np.int64)

    seq = src[:, : lens.max()].copy()
    for i in np.flatnonzero(has_indel):
        L, p, k = int(lens[i]), int(ipos[i]), int(klen[i])
        row = src[i, : L + SRC_PAD]
        if is_del[i]:
            new = np.concatenate([row[:p], row[p + k:]])
        else:
            new = np.concatenate([row[:p], ins[i, :k], row[p:]])
        seq[i, :L] = new[:L]
    rows = np.arange(n)
    for t in range(hi):
        m = t < nsub
        seq[rows[m], spos[m, t]] = sbase[m, t]
    seq[rows[has_n], npos[has_n]] = ord("N")
    return (seq, np.where(has_n, npos, -1),
            np.where(has_indel, np.where(is_del, -klen, klen), 0))


def binned_quals(rng: np.random.Generator, lens: np.ndarray,
                 npos: np.ndarray, spec: dict) -> np.ndarray:
    """-> (n, max len) uint8 quality characters: ``default`` everywhere,
    then up to ``low_runs[1]`` runs (a uniform number in ``low_runs``) of
    a uniform length in ``low_run_len`` at uniform starts, each of one
    bin of ``low_bins`` drawn by ``low_bin_weights`` (a run may pass the
    read's end and is cut there), and ``n_base`` on the N base."""
    n, width = len(lens), int(lens.max())
    q = np.full((n, width), ord(spec["default"]), np.uint8)
    rlo, rhi = spec["low_runs"]
    llo, lhi = spec["low_run_len"]
    nruns = rng.integers(rlo, rhi + 1, n)
    bins = np.frombuffer("".join(spec["low_bins"]).encode(), np.uint8)
    w = np.asarray(spec["low_bin_weights"], float)
    step = np.arange(lhi)
    for r in range(rhi):
        start = (rng.random(n) * lens).astype(np.int64)
        length = rng.integers(llo, lhi + 1, n)
        b = bins[rng.choice(len(bins), n, p=w / w.sum())]
        rows = np.flatnonzero(r < nruns)
        cols = start[rows, None] + step
        on = (step < length[rows, None]) & (cols < lens[rows, None])
        hit = np.broadcast_to(rows[:, None], cols.shape)[on]
        q[hit, cols[on]] = b[hit]
    has_n = npos >= 0
    q[np.flatnonzero(has_n), npos[has_n]] = ord(spec["n_base"])
    return q


def illumina_names(batch: int, n: int, spec: dict) -> List[bytes]:
    """Read ``i`` of batch ``batch``'s name,
    ``<instrument>:<run>:<flowcell>:<lane>:<tile>:<x>:<y>``: lane and tile
    from the batch, x and y from ``i`` (unique within a batch)."""
    head = (f"{spec['instrument']}:{spec['run']}:{spec['flowcell']}:"
            f"{1 + batch % 4}:{1101 + (batch // 4) % 78}:").encode()
    return [head + b"%d:%d" % (1000 + 17 * (i % 2000), 1000 + 23 * (i // 2000))
            for i in range(n)]


def rows_to_records(names: List[bytes], seq: np.ndarray, qual: np.ndarray,
                    lens: np.ndarray) -> List[Tuple[bytes, bytes, bytes]]:
    """(name, seq, qual) records of the rows of ``seq`` and ``qual``, each
    cut to its length."""
    sb, qb = seq.tobytes(), qual.tobytes()
    w = seq.shape[1]
    return [(nm, sb[i * w : i * w + L], qb[i * w : i * w + L])
            for i, (nm, L) in enumerate(zip(names, lens.tolist()))]
