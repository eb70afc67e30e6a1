"""The all-C++ engine of the port (``--engine cpp``): the same-host CPU
baseline.

``CppAligner`` runs the whole pipeline in the C++ host engine
(seeding, chunk build, scalar banded SWG with the narrow-band
certificate, arbitration, finalize, pairing and record emit) on the host
threads, with no device, on the engine assembly that the batch pipeline
uses (``batch.host_engine``); its records equal the batch pipeline's
bytes.  ``threads=1`` is the single-core baseline the card's
reads/s are compared with.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Tuple

import numpy as np

from ..index.build import Index
from ..ops.layout import _WPAD
from ..utils.stats import PipelineStats
from .batch import host_engine
from .driver import AlignOpts, OracleAligner
from .paired import pair_serializer, splice_pairs

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i64p = ctypes.POINTER(ctypes.c_int64)


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


class CppAligner:
    PROBLEM_BUDGET = 32768 - 1024
    MAX_TAKE = 16384  # reads offered to one chunk

    def __init__(self, index: Index, opts: AlignOpts, threads: int = 1):
        """``threads`` host threads for the scalar DP (<= 0: the
        THERMITE_THREADS environment variable, else every core); the
        output does not depend on it.  A C++ engine that fails to load
        raises."""
        self.native = host_engine(index, opts).native
        self.index = index
        self.opts = opts
        if threads <= 0:
            threads = int(os.environ.get("THERMITE_THREADS", os.cpu_count() or 1))
        self.threads = max(threads, 1)
        # the device pipeline's narrow-band pass, certificate-gated
        self.narrow_band = int(os.environ.get("THERMITE_NARROW_BAND", "15"))
        self.stats = PipelineStats()

    def _chunk(self, sl, paired: bool) -> Tuple[object, int]:
        """Align a chunk of the (name, seq, qual) records ``sl`` in C++ ->
        (chunk handle, reads consumed); the caller emits and frees it."""
        lib = self.native._lib
        reads = [r[1].upper() for r in sl]
        maxlen = max((len(r) for r in reads), default=1)
        rpad = _round_up(maxlen, 32)
        pw = (3 * maxlen + 20) // 16 + 1
        reads_pad = np.zeros((len(sl), rpad), np.uint8)
        lens = np.zeros(len(sl), np.int64)
        for i, r in enumerate(reads):
            reads_pad[i, : len(r)] = np.frombuffer(r, np.uint8)
            lens[i] = len(r)
        patches = ctypes.c_int64(0)
        # restype/argtypes are declared in align/native_batch.py
        ch = lib.thermite_chunk_align_cpu_mt(
            self.native._h, reads_pad.ctypes.data_as(_u8p), len(sl), rpad,
            lens.ctypes.data_as(_i64p), self.PROBLEM_BUDGET, _WPAD, pw,
            self.narrow_band, ctypes.cast(ctypes.byref(patches), _i64p),
            1 if paired else 0, self.threads,
        )
        self.stats.cert_patches += patches.value
        if not ch:
            raise RuntimeError("native cpu chunk pipeline failed")
        consumed = lib.thermite_chunk_n_reads(ch)
        self.stats.reads += consumed
        self.stats.chunks += 1
        self.stats.problems += lib.thermite_chunk_n_problems(ch)
        return ch, consumed

    def _emit(self, ch, fmt_bam, sl, strip_tags: bool) -> bytes:
        raw = self.native.emit_chunk(
            ch, fmt_bam, [r[0] for r in sl], [r[1] for r in sl],
            [r[2] or b"" for r in sl], strip_tags=strip_tags,
        )
        if raw is None:
            self.native.free_chunk(ch)
            raise RuntimeError("native cpu emit fell back unexpectedly")
        return raw

    def align_records(self, recs: List[Tuple[bytes, bytes, bytes]], fmt_bam,
                      strip_tags: bool = False) -> bytes:
        """(name, seq, qual) tuples -> SAM/BAM record bytes in input
        order (one record or more per read)."""
        out: List[bytes] = []
        pos = 0
        while pos < len(recs):
            sl = recs[pos : pos + min(len(recs) - pos, self.MAX_TAKE)]
            ch, consumed = self._chunk(sl, paired=False)
            out.append(self._emit(ch, fmt_bam, sl[:consumed], strip_tags))
            self.native.free_chunk(ch)
            pos += consumed
        return b"".join(out)

    def align_records_paired(self, pair_recs, fmt_bam, max_insert: int = 1000,
                             mate_rescue: bool = True,
                             strip_tags: bool = False) -> bytes:
        """((name, seq, qual) R1, (name, seq, qual) R2) pairs -> SAM/BAM
        record bytes with mate fields, in pair order.  The C++ engine
        pairs and emits chunks that hold whole pairs; the mate-rescue
        pairs it leaves to the host are aligned by the sequential oracle
        (the engine's own alignments, by the parity tests)
        and spliced in through ``pair_records`` and the Python writers, as
        the batch paired emit does."""
        ser = pair_serializer(self.index, fmt_bam, max_insert,
                              self.opts if mate_rescue else None, strip_tags)
        oracle = None

        def pair_bytes(rec1, rec2) -> bytes:
            nonlocal oracle
            if oracle is None:
                oracle = OracleAligner(self.index, self.opts)
            return ser(rec1, rec2, oracle.align_read(rec1[1]),
                       oracle.align_read(rec2[1]))

        recs = [rec for pair in pair_recs for rec in pair]
        out: List[bytes] = []
        pos = 0
        while pos < len(recs):
            take = min(len(recs) - pos, self.MAX_TAKE)
            if take % 2:  # never offer half a pair
                take += 1 if pos + take < len(recs) else -1
            sl = recs[pos : pos + take]
            ch, consumed = self._chunk(sl, paired=True)
            if consumed % 2:
                self.native.free_chunk(ch)
                raise RuntimeError("the C++ chunk split a read pair")
            self.native.pair_chunk(ch, max_insert, mate_rescue)
            raw = self._emit(ch, fmt_bam, sl[:consumed], strip_tags)
            pairs_idx, offs = self.native.splices(ch)
            self.native.free_chunk(ch)
            base = pos // 2
            out.append(splice_pairs(raw, pairs_idx, offs,
                                    lambda p: pair_bytes(*pair_recs[base + p])))
            pos += consumed
        return b"".join(out)
