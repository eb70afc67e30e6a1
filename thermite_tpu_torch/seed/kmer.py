"""K-mer gather table over the concatenated genome text.

This replaces the reference's suffix-array/BWT/FM-index machinery
(reference src/index.rs:103-111) with the structure a batch device path wants:
flat sorted arrays supporting vectorized gather — a bucketed posting
list of every k-mer in the text.

Keys are packed base-5 over the alphabet {A,C,G,T,N} so N-containing
k-mers remain exactly searchable, matching the reference FM-index
alphabet "ACGNT" (src/index.rs:108): 'N' in the text matches a literal
'N' in a read.  k is capped at 13 (5^13 < 2^31).  Windows containing
'$' or any other byte are excluded (they can never match a read).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

MAX_ANCHOR_K = 20  # 5^20 < 2^63: base-5 keys stay in int64

# byte -> base-5 code; 255 = invalid
_CODE = np.full(256, 255, dtype=np.uint8)
for i, b in enumerate(b"ACGTN"):
    _CODE[b] = i


def encode_base5(seq_arr: np.ndarray) -> np.ndarray:
    """uint8 ASCII bytes -> base-5 codes (255 where invalid)."""
    return _CODE[seq_arr]


def rolling_keys(codes: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Base-5 keys of every length-k window and a validity mask.

    Returns (keys[int64 of len n-k+1], valid[bool]).
    """
    n = len(codes)
    if n < k:
        return np.empty(0, np.int64), np.empty(0, bool)
    c = codes.astype(np.int64)
    m = n - k + 1
    keys = np.zeros(m, dtype=np.int64)
    valid = np.ones(m, dtype=bool)
    for t in range(k):
        w = c[t : t + m]
        keys = keys * 5 + np.where(w == 255, 0, w)
        valid &= w != 255
    return keys, valid


@dataclass
class KmerTable:
    """Sorted posting list: for a key, its text positions.

    ``uniq_keys`` sorted ascending; bucket i covers
    ``positions[offsets[i]:offsets[i+1]]``.
    """

    k: int
    uniq_keys: np.ndarray  # int64 (m,)
    offsets: np.ndarray  # int64 (m+1,)
    positions: np.ndarray  # int64 (total,) text positions, ascending per bucket

    @classmethod
    def build(cls, seq_arr: np.ndarray, k: int, stride: int = 1) -> "KmerTable":
        """``stride`` > 1 samples text positions === 0 (mod stride):
        maximal matches of length >= k + stride - 1 are still always
        found (their k-window starts cover ``stride`` consecutive text
        offsets); shorter ones may be missed — the whole-genome memory
        tradeoff, shared by the C++ builder."""
        assert 1 <= k <= MAX_ANCHOR_K and stride >= 1
        codes = encode_base5(seq_arr)
        keys, valid = rolling_keys(codes, k)
        if stride > 1:
            samp = np.zeros(len(valid), bool)
            samp[::stride] = True
            valid = valid & samp
        pos = np.nonzero(valid)[0]
        keys = keys[pos]
        order = np.argsort(keys, kind="stable")  # stable => positions ascending
        keys_sorted = keys[order]
        positions = pos[order]
        uniq_keys, counts = np.unique(keys_sorted, return_counts=True)
        offsets = np.zeros(len(uniq_keys) + 1, dtype=np.int64)
        np.cumsum(counts, out=offsets[1:])
        return cls(k=k, uniq_keys=uniq_keys, offsets=offsets, positions=positions)

    def lookup(self, query_keys: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """For each query key: (bucket_start, bucket_count); (0,0) if absent."""
        if len(self.uniq_keys) == 0:
            # empty table (text shorter than k): offsets is [0], so the
            # offsets[idx + 1] below would index out of bounds
            z = np.zeros(len(query_keys), dtype=np.int64)
            return z, z
        idx = np.searchsorted(self.uniq_keys, query_keys)
        idx_c = np.minimum(idx, len(self.uniq_keys) - 1) if len(self.uniq_keys) else idx * 0
        found = (
            (len(self.uniq_keys) > 0)
            & (idx < len(self.uniq_keys))
            & (self.uniq_keys[idx_c] == query_keys)
        )
        starts = np.where(found, self.offsets[np.where(found, idx, 0)], 0)
        counts = np.where(
            found,
            self.offsets[np.where(found, idx, 0) + 1] - starts,
            0,
        )
        return starts, counts
