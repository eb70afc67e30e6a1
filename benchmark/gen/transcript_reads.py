"""10x Chromium 3'-style R2 reads drawn from the annotation's transcripts:
the generator of the ``gex3p*`` mixes.

Each read's origin is drawn by ``origins``:

- ``mrna``: a gene drawn by Zipf (exponent ``zipf_s``) over the
  annotation's genes, in a rank order fixed by ``expression_seed``; the
  read lies on the sense strand of the gene's spliced transcript (its
  first in the GTF), starting a uniform ``mrna_start_from_3p`` ([low,
  high]) bases before the transcript's 3' end, clipped to the transcript;
- ``pre_mrna``: a gene drawn by the same Zipf; the read is a window of
  the gene's span on its sense strand that overlaps one of the
  transcript's introns;
- ``intergenic``: a window of a forward chromosome (drawn in proportion
  to length) that overlaps no gene's span, reverse-complemented with
  probability ``intergenic_reverse_share``.

Errors are ``errors.mutate``'s, qualities ``errors.binned_quals``', names
``errors.illumina_names``'.  The annotation is parsed, and the genes'
spans read with ``os.pread``, once a process; the same seed and batch
give the same reads.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, List, Tuple

import numpy as np

from benchmark.gen.errors import (COMP, SRC_PAD, binned_quals,
                                  illumina_names, mutate, rows_to_records)
from benchmark.reference.gtf import parse_gtf


def annotation(genome: dict, width: int) -> Dict[str, np.ndarray]:
    """``_annotation`` of the genome's files (made once a process, and
    never written to)."""
    return _annotation(genome["fasta"], genome["gtf"],
                       tuple((c["name"], c["offset"]) for c in genome["chroms"]),
                       width)


@functools.lru_cache(maxsize=2)
def _annotation(fasta: str, gtf: str, chroms: tuple,
                width: int) -> Dict[str, np.ndarray]:
    """The genes as flat arrays: each gene's sense transcript and sense
    span in one buffer each (``tx``, ``span`` with their offsets and
    lengths), its introns in sense coordinates of its span (``introns``,
    (genes, most introns, 2), -1 where a gene has fewer), and per
    chromosome its genes' spans sorted by start, with the largest end of
    each prefix (``chrom_spans``: starts, ends).  Genes whose transcript
    is shorter than ``width`` are left out."""
    genes, txs = parse_gtf(gtf)
    offset = dict(chroms)
    first = {}
    for t in txs:
        first.setdefault(t.gene_idx, t)
    tx_parts, span_parts, intr = [], [], []
    chrom_spans: Dict[str, List[Tuple[int, int]]] = {}
    fd = os.open(fasta, os.O_RDONLY)
    try:
        for g in range(len(genes)):
            t = first.get(g)
            if t is None:
                continue
            lo, hi = t.start, t.end
            chrom_spans.setdefault(t.chrom, []).append((lo, hi))
            span = np.frombuffer(
                os.pread(fd, hi - lo, offset[t.chrom] + lo),
                np.uint8)
            tx = np.concatenate([span[a - lo : b - lo] for a, b in t.exons])
            if len(tx) < width:
                continue
            gaps = [(b, a2) for (_, b), (a2, _) in zip(t.exons, t.exons[1:])]
            if t.strand:
                gaps = [(a - lo, b - lo) for a, b in gaps]
            else:
                tx, span = COMP[tx[::-1]], COMP[span[::-1]]
                gaps = [(hi - b, hi - a) for a, b in gaps]
            tx_parts.append(tx)
            span_parts.append(span)
            intr.append(gaps)
    finally:
        os.close(fd)
    most = max(1, max(map(len, intr), default=1))
    introns = np.full((len(intr), most, 2), -1, np.int64)
    for g, gaps in enumerate(intr):
        if gaps:
            introns[g, : len(gaps)] = gaps

    def flat(parts):
        lens = np.array([len(p) for p in parts], np.int64)
        off = np.concatenate(([0], np.cumsum(lens)[:-1]))
        return np.concatenate(parts), off, lens

    out = {"introns": introns, "chrom_spans": {}}
    for c, v in chrom_spans.items():
        v = np.array(sorted(v), np.int64).reshape(-1, 2)
        out["chrom_spans"][c] = (v[:, 0], np.maximum.accumulate(v[:, 1]))
    for key, parts in (("tx", tx_parts), ("span", span_parts)):
        out[key], out[key + "_off"], out[key + "_len"] = flat(parts)
    return out


def zipf_p(n: int, s: float, seed: int) -> np.ndarray:
    """Each gene's share of expression: 1 / rank^s, the ranks a
    permutation of the genes drawn from ``seed``."""
    rank = np.empty(n, np.int64)
    rank[np.random.default_rng(seed).permutation(n)] = np.arange(1, n + 1)
    w = rank.astype(float) ** -s
    return w / w.sum()


def sources(genome: dict, traffic: dict, rng: np.random.Generator
            ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
    """-> ((n, read_len + SRC_PAD) source bases, the reads' origins):
    ``kind`` (0 mRNA, 1 pre-mRNA, 2 intergenic), ``gene`` (its index in
    ``annotation``'s arrays; -1 intergenic) and ``start`` (the offset of
    the source in the sense transcript, the sense span, or the forward
    chromosome ``chrom``, whose source is reverse-complemented where
    ``reverse``)."""
    n, L = traffic["batch_reads"], traffic["read_len"]
    W = L + SRC_PAD
    ann = annotation(genome, W)
    ng = len(ann["tx_len"])
    p = zipf_p(ng, traffic["zipf_s"], traffic["expression_seed"])
    o = traffic["origins"]
    u = rng.random(n)
    kind = np.where(u < o["mrna"], 0, np.where(u < o["mrna"] + o["pre_mrna"],
                                                1, 2))
    gene = np.full(n, -1, np.int64)
    start = np.zeros(n, np.int64)
    chrom = np.full(n, -1, np.int64)
    reverse = np.zeros(n, bool)
    src = np.empty((n, W), np.uint8)
    cols = np.arange(W)

    # mature mRNA: the sense transcript near its 3' end
    m = np.flatnonzero(kind == 0)
    g = gene[m] = rng.choice(ng, size=len(m), p=p)
    lo, hi = traffic["mrna_start_from_3p"]
    tl = ann["tx_len"][g]
    st = start[m] = np.clip(tl - rng.integers(lo, hi + 1, len(m)), 0, tl - W)
    src[m] = ann["tx"][(ann["tx_off"][g] + st)[:, None] + cols]

    # pre-mRNA: a window of the sense span over an intron (the same Zipf
    # over the genes that have one)
    m = np.flatnonzero(kind == 1)
    p_pre = np.where((ann["introns"][:, 0, 0] >= 0) & (ann["span_len"] >= W),
                     p, 0.0)
    g = gene[m] = rng.choice(ng, size=len(m), p=p_pre / p_pre.sum())
    sl = ann["span_len"][g]
    iv = ann["introns"][g]
    st = np.zeros(len(m), np.int64)
    todo = np.arange(len(m))
    while len(todo):
        s = rng.integers(0, sl[todo] - W + 1)
        a, b = iv[todo, :, 0], iv[todo, :, 1]
        hit = ((a >= 0) & (s[:, None] < b) & (a < (s + L)[:, None])).any(1)
        st[todo[hit]] = s[hit]
        todo = todo[~hit]
    start[m] = st
    src[m] = ann["span"][(ann["span_off"][g] + st)[:, None] + cols]

    # intergenic: a genome window clear of every gene's span
    m = np.flatnonzero(kind == 2)
    chroms = [c for c in genome["chroms"] if c["len"] > W + 1]
    clen = np.array([c["len"] for c in chroms], np.int64)
    ci = chrom[m] = rng.choice(len(chroms), size=len(m), p=clen / clen.sum())
    st = np.zeros(len(m), np.int64)
    todo = np.arange(len(m))
    while len(todo):
        s = rng.integers(0, clen[ci[todo]] - W)
        clear = np.ones(len(todo), bool)
        for c, ch in enumerate(chroms):
            spans = ann["chrom_spans"].get(ch["name"])
            on = np.flatnonzero(ci[todo] == c)
            if spans is None or not len(on):
                continue
            # every span that starts before the window's end has ended
            # by its start
            starts, max_end = spans
            k = np.searchsorted(starts, s[on] + W) - 1
            clear[on] = (k < 0) | (max_end[np.maximum(k, 0)] <= s[on])
        st[todo[clear]] = s[clear]
        todo = todo[~clear]
    start[m] = st
    rev = reverse[m] = rng.random(len(m)) < traffic["intergenic_reverse_share"]
    fd = os.open(genome["fasta"], os.O_RDONLY)
    try:
        for j, (c, s) in enumerate(zip(ci.tolist(), st.tolist())):
            row = np.frombuffer(os.pread(fd, W, chroms[c]["offset"] + s),
                                np.uint8)
            src[m[j]] = COMP[row[::-1]] if rev[j] else row
    finally:
        os.close(fd)
    return src, {"kind": kind, "gene": gene, "start": start, "chrom": chrom,
                 "reverse": reverse}


def make_batch(genome: dict, traffic: dict, seed: int, stream: int,
               batch: int) -> List[Tuple[bytes, bytes, bytes]]:
    """The (name, seq, qual) records of batch ``batch`` of ``stream`` (0:
    the measured window; 1: set-up's warm-up) for ``seed``."""
    rng = np.random.default_rng([seed, stream, batch])
    src, _ = sources(genome, traffic, rng)
    n, L = src.shape[0], traffic["read_len"]
    lens = np.full(n, L, np.int64)
    seq, npos, _ = mutate(rng, src, lens, traffic["errors"])
    qual = binned_quals(rng, lens, npos, traffic["qualities"])
    return rows_to_records(illumina_names(batch, n, traffic["names"]),
                           seq, qual, lens)
