"""SMEM seeds of a fixed set of reads, from the anchors of those reads
alone.

The program keeps a k-mer posting table of the whole text (every text
position, or one in ``stride`` for a whole genome).  A table of a
1.2 Gbp genome takes minutes and gigabytes to build, so the reference
does not build one: it scans the text once for the k-mers that the
checked reads contain, at the positions the program's table samples
(absolute text positions divisible by ``stride``), and keeps those hits
as a small posting table.  The seeds that follow are the numpy seeder's
(``SmemEngine.all_smems``, the program's plain oracle of its C++
seeder): anchors, maximal extension on the text, the envelope, and the
supermaximal intervals with all their occurrences.

The scan packs four bases a byte, so the 20-mer at a text position
divisible by four is five consecutive bytes (a 40-bit key); the other
three phases repeat the scan on the text shifted by one to three bases.
Windows with a byte other than A, C, G or T are never keys: a read
k-mer with an N matches only a text window with the same N, so a text
with N in it is refused when a checked read has one.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import numpy as np

from .types import Mem

K_MAX = 20  # anchor length: min(20, min_seed_len), as the program's
_CODE2 = np.full(256, 4, np.uint8)  # A C G T -> 0..3, anything else 4
for _i, _b in enumerate(b"ACGT"):
    _CODE2[_b] = _i
_GROUPS = 1 << 22  # text groups of four bases a chunk
_PREFIX_BITS = 23  # the prefix filter's table: 8 MB, cache-resident
_MUL32 = np.uint32(0x9E3779B1)
# two text bytes (a little-endian uint16) -> their 2-bit codes, the first
# base high; bytes other than A, C, G, T code as A and are refused later
# by position
_PAIR = np.zeros(1 << 16, np.uint8)
for _i, _a in enumerate(b"ACGT"):
    for _j, _b in enumerate(b"ACGT"):
        _PAIR[_a | (_b << 8)] = (_i << 2) | _j
_BAD = np.ones(256, bool)
_BAD[np.frombuffer(b"ACGT", np.uint8)] = False


def _read_keys(q: np.ndarray, k: int):
    """2-bit keys of every k-window of ``q`` (first base most significant)
    and whether the window is all ACGT."""
    c = _CODE2[q].astype(np.uint64)
    m = len(q) - k + 1
    keys = np.zeros(m, np.uint64)
    valid = np.ones(m, bool)
    for t in range(k):
        w = c[t : t + m]
        keys = (keys << np.uint64(2)) | (w & np.uint64(3))
        valid &= w < 4
    return keys, valid


def _prefix_slot(words: np.ndarray) -> np.ndarray:
    return (words.astype(np.uint32) * _MUL32) >> np.uint32(32 - _PREFIX_BITS)


def _scan_chunk(text: np.ndarray, want: np.ndarray, table: np.ndarray,
                k: int, phase: int, g0: int, g1: int):
    """The hits of the windows that start in groups g0 .. g1-5 of
    ``phase`` (the chunk reads four groups past them)."""
    lo = phase + 4 * g0
    raw = text[lo : phase + 4 * g1]
    pairs = _PAIR[raw.view(np.uint16)]
    packed = (pairs[0::2] << 4) | pairs[1::2]
    own = len(packed) - 4  # windows that start in this chunk
    cands = []
    for o in range(4):
        nw = (len(packed) - o) // 4
        words = packed[o : o + 4 * nw].view(">u4")
        c = np.flatnonzero(table[_prefix_slot(words)]) * 4 + o
        cands.append(c[c < own])
    g = np.concatenate(cands)
    key = np.zeros(len(g), np.uint64)
    for t in range(5):
        key = (key << np.uint64(8)) | packed[g + t].astype(np.uint64)
    i = np.minimum(np.searchsorted(want, key), len(want) - 1)
    hit = want[i] == key
    key, g = key[hit], g[hit].astype(np.int64)
    bad = np.flatnonzero(_BAD[raw])  # bytes other than A, C, G, T
    if len(bad):
        b = np.minimum(np.searchsorted(bad, 4 * g), len(bad) - 1)
        ok = (bad[b] < 4 * g) | (bad[b] >= 4 * g + k)
        key, g = key[ok], g[ok]
    return key, lo + 4 * g


def _scan(text: np.ndarray, want: np.ndarray, k: int, stride: int):
    """(keys, positions) of every text window at a position divisible by
    ``stride`` whose key is in the sorted array ``want``.

    Text is packed four bases a byte (group g: bases 4g .. 4g+3 of the
    phase); the 16-base prefix of the window at group g is the big-endian
    word of bytes g .. g+3, read as four views without a copy.  A prefix
    that hashes to a slot of a wanted prefix is a candidate; a
    candidate's whole key is built from its five bytes and looked up, and
    a window over a byte other than A, C, G, T is refused.  Chunks run on
    a thread each (numpy releases the interpreter lock)."""
    if 4 % stride:
        raise ValueError(f"stride {stride} does not divide 4")
    if k != 20:
        raise ValueError(f"anchor length {k}: the scan packs 20-mers")
    table = np.zeros(1 << _PREFIX_BITS, bool)
    table[_prefix_slot(want >> np.uint64(8))] = True
    jobs = []
    for phase in range(0, 4, stride):
        ngroups = (len(text) - phase) // 4
        jobs += [(phase, g0, min(g0 + _GROUPS + 4, ngroups))
                 for g0 in range(0, ngroups - 4, _GROUPS)]
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        parts = list(pool.map(
            lambda j: _scan_chunk(text, want, table, k, *j), jobs))
    if not parts:
        return np.zeros(0, np.uint64), np.zeros(0, np.int64)
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]))


class SampleSeeder:
    """``all_smems(read)`` for the reads given at construction."""

    def __init__(self, seq_arr: np.ndarray, reads: Sequence[bytes],
                 min_seed_len: int, stride: int = 1):
        self.seq_arr = seq_arr
        self.min_seed_len = min_seed_len
        self.k = min(K_MAX, min_seed_len)
        keys = []
        has_n = False
        for r in reads:
            q = np.frombuffer(r.upper(), np.uint8)
            if len(q) < self.k:
                continue
            kk, valid = _read_keys(q, self.k)
            keys.append(kk[valid])
            has_n |= not valid.all()
        if has_n and bool((seq_arr == ord("N")).any()):
            raise NotImplementedError(
                "reads with N against a text with N: the 2-bit scan cannot "
                "match N-windows")
        want = np.unique(np.concatenate(keys)) if keys else \
            np.zeros(0, np.uint64)
        if len(want):
            tk, tp = _scan(seq_arr, want, self.k, stride)
        else:
            tk, tp = np.zeros(0, np.uint64), np.zeros(0, np.int64)
        order = np.lexsort((tp, tk))  # by key, positions ascending
        self._keys, self._pos = tk[order], tp[order]

    def _lookup(self, keys: np.ndarray):
        lo = np.searchsorted(self._keys, keys, "left")
        hi = np.searchsorted(self._keys, keys, "right")
        return lo, hi - lo

    def all_smems(self, read: bytes) -> List[Mem]:
        """All SMEMs of ``read`` (uppercase) vs the text, len >= min_seed_len."""
        q = np.frombuffer(read, dtype=np.uint8)
        L = len(q)
        k = self.k
        if L < self.min_seed_len:
            return []
        keys, valid = _read_keys(q, k)
        starts, counts = self._lookup(keys)
        counts = np.where(valid, counts, 0)
        if int(counts.sum()) == 0:
            return []
        qpos = np.repeat(np.arange(len(keys), dtype=np.int64), counts)
        tpos = np.concatenate(
            [self._pos[s : s + c] for s, c in zip(starts, counts) if c])
        lext = self._extend(q, qpos, tpos, direction=-1)
        rext = self._extend(q, qpos + k, tpos + k, direction=+1)
        s_o = qpos - lext
        e_o = qpos + k + rext
        diag = tpos - qpos
        p_o = tpos - lext
        uniq = np.unique(np.stack([diag, s_o, e_o, p_o], axis=1), axis=0)
        s_o, e_o, p_o = uniq[:, 1], uniq[:, 2], uniq[:, 3]
        # envelope P(s) = max e_o over intervals starting at or before s
        env = np.zeros(L + 1, dtype=np.int64)
        np.maximum.at(env, s_o, e_o)
        P = np.maximum.accumulate(env)
        s_all = np.arange(L + 1, dtype=np.int64)
        is_smem = ((P - s_all >= self.min_seed_len)
                   & (P > np.concatenate([[0], P[:-1]])))
        mems: List[Mem] = []
        for s in np.nonzero(is_smem[:L])[0]:
            e = int(P[s])
            sel = (s_o <= s) & (e_o >= e)
            for p in np.sort(p_o[sel] + (s - s_o[sel])):
                mems.append(Mem(ref_idx=int(p), query_idx=int(s), len=e - int(s)))
        mems.sort(key=lambda m: (-m.len, m.query_idx, m.ref_idx))
        return mems

    def _extend(self, q, qi, ti, direction: int) -> np.ndarray:
        """Maximal exact-extension lengths from (query idx, text idx)."""
        text = self.seq_arr
        n = len(text)
        L = len(q)
        ext = np.zeros(len(qi), dtype=np.int64)
        active = np.ones(len(qi), dtype=bool)
        while active.any():
            if direction > 0:
                qq, tt = qi + ext, ti + ext
                inb = active & (qq < L) & (tt < n)
            else:
                qq, tt = qi - 1 - ext, ti - 1 - ext
                inb = active & (qq >= 0) & (tt >= 0)
            if not inb.any():
                break
            m = np.zeros(len(qi), dtype=bool)
            m[inb] = q[qq[inb]] == text[tt[inb]]
            ext[m] += 1
            active = m
        return ext

