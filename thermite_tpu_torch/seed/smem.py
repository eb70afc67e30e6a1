"""SMEM (supermaximal exact match) seeding via k-mer anchors.

Produces the same seed set as the reference's FM-index search
(reference src/index.rs:228-255: rust-bio ``FMDIndex::all_smems`` over
a text that already contains both strands) but from a gather-friendly
k-mer table — no FM index.

Definition used (standard SMEM): a maximal exact match between read
and text whose *query interval* is not contained in any other maximal
exact match's query interval; only SMEMs of length >= min_seed_len are
reported, each with ALL of its text occurrence positions.

Why anchor seeding is exact (proof sketch, relied on by tests):
let L(s) be the longest match starting at read offset s, and
e(s) = s + L(s).  Since L(s+1) >= L(s) - 1, e is non-decreasing, so an
interval [s, e(s)) is contained in an earlier one iff e(s-1) = e(s).
Thus SMEMs = { [s, e(s)) : e(s) > e(s-1), L(s) >= min_seed_len }.
Every reported interval has length >= min_seed_len >= k_anchor, so each
of its occurrences contains a k-anchor at every offset and is found by
anchor gathering; per-occurrence maximal extension therefore
reconstructs the exact envelope e(s) restricted to matches of length
>= k_anchor, which suffices for both the SMEM set and the containment
test (any containing interval is also >= k_anchor long).

Seed ordering: the reference sorts by length descending with
unspecified tie order inherited from FM emission (src/index.rs:251-253).
We canonicalise ties to (query_idx asc, ref_idx asc) — deterministic
and shared by the oracle and batch paths.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..align.types import Mem
from .kmer import KmerTable, MAX_ANCHOR_K, encode_base5, rolling_keys



class SmemEngine:
    """Host SMEM seeder over a concatenated genome text."""

    def __init__(self, seq_arr: np.ndarray, min_seed_len: int,
                 table: Optional[KmerTable] = None, stride: int = 1):
        self.seq_arr = seq_arr
        self.min_seed_len = min_seed_len
        self.k = min(MAX_ANCHOR_K, min_seed_len)
        self.table = table if table is not None else KmerTable.build(
            seq_arr, self.k, stride
        )

    def export_table(self, views: bool = False):
        """-> (k, uniq_keys, offsets, positions) — the persistable form.
        ``views`` is accepted for interface parity with the native
        engine; the numpy table's arrays are already plain ndarrays."""
        del views
        t = self.table
        return self.k, t.uniq_keys, t.offsets, t.positions

    def all_smems(self, read: bytes) -> List[Mem]:
        """All SMEMs of `read` (uppercase) vs the text, len >= min_seed_len."""
        q = np.frombuffer(read, dtype=np.uint8)
        L = len(q)
        k = self.k
        if L < self.min_seed_len:
            return []

        qcodes = encode_base5(q)
        keys, valid = rolling_keys(qcodes, k)
        starts, counts = self.table.lookup(keys)
        counts = np.where(valid, counts, 0)
        total = int(counts.sum())
        if total == 0:
            return []

        # Expand (qpos, tpos) anchor hit pairs.
        qpos = np.repeat(np.arange(len(keys), dtype=np.int64), counts)
        flat = np.concatenate(
            [self.table.positions[s : s + c] for s, c in zip(starts, counts) if c]
        )
        tpos = flat.astype(np.int64)

        # Deduplicate per diagonal: anchors inside the same maximal match
        # produce the same interval; keep one representative per
        # (diagonal, covered-run).  First extend every hit maximally,
        # then unique by (diag, s_o).
        lext = self._extend(q, qpos, tpos, direction=-1)
        rext = self._extend(q, qpos + k, tpos + k, direction=+1)
        s_o = qpos - lext
        e_o = qpos + k + rext
        diag = tpos - qpos
        p_o = tpos - lext  # text position of the interval start

        uniq = np.unique(np.stack([diag, s_o, e_o, p_o], axis=1), axis=0)
        diag, s_o, e_o, p_o = uniq[:, 0], uniq[:, 1], uniq[:, 2], uniq[:, 3]

        # Envelope P(s) = max e_o over intervals starting at or before s.
        env = np.zeros(L + 1, dtype=np.int64)
        np.maximum.at(env, s_o, e_o)
        P = np.maximum.accumulate(env)

        s_all = np.arange(L + 1, dtype=np.int64)
        is_smem = (P - s_all >= self.min_seed_len) & (P > np.concatenate([[0], P[:-1]]))
        smem_starts = np.nonzero(is_smem[:L])[0]

        mems: List[Mem] = []
        for s in smem_starts:
            e = int(P[s])
            sel = (s_o <= s) & (e_o >= e)
            hits = np.sort(p_o[sel] + (s - s_o[sel]))
            for p in hits:
                mems.append(Mem(ref_idx=int(p), query_idx=int(s), len=e - int(s)))

        mems.sort(key=lambda m: (-m.len, m.query_idx, m.ref_idx))
        return mems

    def longest_smem(self, read: bytes) -> Optional[Mem]:
        """A single longest SMEM of ``read`` (or None below min length).

        Parity surface for reference src/index.rs:260-283
        (``Index::longest_smem`` — unused by the align path there too).
        The reference keeps the FIRST length-maximal interval in FM
        emission order and its first occurrence; emission order is an
        FM-index internality, so we canonicalise the tie the same way
        ``all_smems`` does: earliest query start, then smallest text
        position.
        """
        mems = self.all_smems(read)
        if not mems:
            return None
        best = max(m.len for m in mems)
        return min(
            (m for m in mems if m.len == best),
            key=lambda m: (m.query_idx, m.ref_idx),
        )

    def _extend(self, q: np.ndarray, qi: np.ndarray, ti: np.ndarray, direction: int) -> np.ndarray:
        """Maximal exact-extension lengths from (query idx, text idx).

        direction=+1 extends rightwards comparing q[qi+e] vs text[ti+e];
        direction=-1 extends leftwards comparing q[qi-1-e] vs text[ti-1-e].
        Vectorized over hits; masked stepping (<= len(q) iterations).
        """
        text = self.seq_arr
        n = len(text)
        L = len(q)
        ext = np.zeros(len(qi), dtype=np.int64)
        active = np.ones(len(qi), dtype=bool)
        while active.any():
            if direction > 0:
                qq = qi + ext
                tt = ti + ext
                inb = active & (qq < L) & (tt < n)
            else:
                qq = qi - 1 - ext
                tt = ti - 1 - ext
                inb = active & (qq >= 0) & (tt >= 0)
            if not inb.any():
                break
            m = np.zeros(len(qi), dtype=bool)
            m[inb] = q[qq[inb]] == text[tt[inb]]
            ext[m] += 1
            active = m
        return ext


def all_smems_brute(seq: bytes, read: bytes, min_seed_len: int) -> List[Mem]:
    """Brute-force SMEM oracle for tests: O(L^2 * n). Definition-direct."""
    L = len(read)
    n = len(seq)
    # longest match starting at each s
    e = np.zeros(L + 1, dtype=np.int64)
    occ_cache = {}
    for s in range(L):
        # binary search longest l such that read[s:s+l] occurs
        lo, hi = 0, L - s
        best = 0
        while lo <= hi:
            mid = (lo + hi) // 2
            if mid == 0 or read[s : s + mid] in seq:
                best = mid
                lo = mid + 1
            else:
                hi = mid - 1
        e[s] = s + best
    mems = []
    prev = 0
    for s in range(L):
        if e[s] - s >= min_seed_len and e[s] > prev:
            pat = read[s : int(e[s])]
            # all occurrences
            start = 0
            while True:
                p = seq.find(pat, start)
                if p < 0:
                    break
                mems.append(Mem(ref_idx=p, query_idx=s, len=len(pat)))
                start = p + 1
        prev = max(prev, int(e[s]))
    mems.sort(key=lambda m: (-m.len, m.query_idx, m.ref_idx))
    return mems
