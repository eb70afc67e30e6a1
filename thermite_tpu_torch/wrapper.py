"""Embedding API of the port: ``ThermiteAligner``, the Orbit/STAR-style
surface (original src/wrapper.rs:19-141) that a host application such as
Cell Ranger clones across workers over one shared index.  It has the
public surface of the reference's ``ThermiteAligner``.

The per-read surfaces (``align_read``, ``align_read_pair``) run the
sequential oracle; ``align_reads``, ``align_reads_records`` and
``align_read_pairs_records`` run the port's batch pipeline on ``device``.
Records carry no TX/GX/GN/RE tags (original src/wrapper.rs:136-139).
"""

from __future__ import annotations

import os
from typing import List, Optional

from . import device as _device
from .align.batch import BatchAligner
from .align.driver import AlignOpts, OracleAligner
from .align.paired import STRIP_TAGS, _Rec, pair_records
from .constants import (
    DEFAULT_MIN_ALN_SCORE,
    DEFAULT_MIN_ALN_SCORE_PERCENT,
    DEFAULT_MIN_SEED_LEN,
    DEFAULT_MULTIMAP_SCORE_RANGE,
)
from .index.build import Index
from .io.sam import SamRecord, aln_to_sam_record, build_sam_header, unmapped_sam_record


def _strip(rec: SamRecord) -> SamRecord:
    rec.tags = [t for t in rec.tags if t[0] not in STRIP_TAGS]
    return rec


class ThermiteAligner:
    def __init__(self, index_path: str, device="cuda"):
        """``device`` is "cuda" (raises without a card) or "cpu" (the
        plain PyTorch kernels), as for ``BatchAligner``."""
        self.device = _device.resolve(device)
        self.index = Index.load(index_path)
        # the original wrapper's defaults (src/wrapper.rs:40-46)
        self.align_opts = AlignOpts(
            min_seed_len=DEFAULT_MIN_SEED_LEN,
            min_aln_score_percent=DEFAULT_MIN_ALN_SCORE_PERCENT,
            min_aln_score=DEFAULT_MIN_ALN_SCORE,
            multimap_score_range=DEFAULT_MULTIMAP_SCORE_RANGE,
            intron_mode=False,
        )
        self._oracle: Optional[OracleAligner] = None
        self._batch: Optional[BatchAligner] = None

    def _oracle_aligner(self) -> OracleAligner:
        if self._oracle is None:
            self._oracle = OracleAligner(self.index, self.align_opts)
        return self._oracle

    def _batcher(self) -> BatchAligner:
        """The batch pipeline for the current options, built on first
        use (``set_opts`` drops it)."""
        if self._batch is None:
            self._batch = BatchAligner(self.index, self.align_opts,
                                       device=self.device)
        return self._batch

    # -- alignment ------------------------------------------------------

    def align_read(self, name: bytes, read: bytes, qual: bytes) -> List[SamRecord]:
        """Align one read with the oracle; always >= 1 record (an
        unmapped record when nothing aligns)."""
        return self._records(name, read, qual,
                             self._oracle_aligner().align_read(read))

    def align_reads(self, names: List[bytes], reads: List[bytes],
                    quals: List[bytes]) -> List[List[SamRecord]]:
        """Batch path, record objects (>= 1 per read)."""
        return [self._records(name, read, qual, alns)
                for name, read, qual, alns in zip(
                    names, reads, quals, self._batcher().align_batch(reads))]

    def align_reads_records(self, names: List[bytes], reads: List[bytes],
                            quals: List[bytes], fmt_bam: bool = False) -> bytes:
        """Batch path, serialized records (SAM lines, or BAM record blobs
        with ``fmt_bam``) in input order, >= 1 per read; the same bytes
        as serializing ``align_reads``."""
        recs = [(n, r, q or b"") for n, r, q in zip(names, reads, quals)]
        return self._batcher().align_batch_emit(recs, fmt_bam, strip_tags=True)

    def align_read_pairs_records(
        self, names: List[bytes], reads1: List[bytes], quals1: List[bytes],
        reads2: List[bytes], quals2: List[bytes], fmt_bam: bool = False,
        max_insert: int = 1000, mate_rescue: bool = True,
    ) -> bytes:
        """Paired batch path, serialized records with mate fields (FR
        pairing, mate rescue unless ``mate_rescue=False``) in input-pair
        order, >= 2 per pair; the same bytes as serializing
        ``align_read_pair`` of each pair."""
        pair_recs = [((n, r1, q1 or b""), (n, r2, q2 or b""))
                     for n, r1, q1, r2, q2 in zip(names, reads1, quals1,
                                                  reads2, quals2)]
        return self._batcher().align_paired_emit(
            pair_recs, fmt_bam, max_insert=max_insert,
            mate_rescue=mate_rescue, strip_tags=True,
        )

    def align_read_pair(
        self, name: bytes, read1: bytes, qual1: bytes, read2: bytes,
        qual2: bytes, max_insert: int = 1000, mate_rescue: bool = True,
    ) -> List[SamRecord]:
        """One pair through the oracle: FR pairing and mate fields by
        ``pair_records`` (mate rescue unless ``mate_rescue=False``);
        always >= 2 records."""
        oracle = self._oracle_aligner()
        return [_strip(rec) for rec in pair_records(
            self.index, _Rec(name, read1, qual1), _Rec(name, read2, qual2),
            oracle.align_read(read1), oracle.align_read(read2), max_insert,
            rescue_opts=self.align_opts if mate_rescue else None,
        )]

    def _records(self, name, read, qual, alns) -> List[SamRecord]:
        if not alns:
            return [unmapped_sam_record(name, read, qual)]
        return [_strip(aln_to_sam_record(self.index, name, read, qual, aln,
                                         len(alns), i + 1))
                for i, aln in enumerate(alns)]

    # -- accessors (original src/wrapper.rs:104-123) ---------------------

    @staticmethod
    def est_mem(index_path: str) -> int:
        return os.path.getsize(index_path)

    @property
    def opts(self) -> AlignOpts:
        return self.align_opts

    def set_opts(self, opts: AlignOpts) -> None:
        self.align_opts = opts
        self._oracle = None
        self._batch = None

    def header(self) -> str:
        return build_sam_header(self.index)
