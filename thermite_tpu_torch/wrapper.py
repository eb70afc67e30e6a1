"""Embedding API of the port: the reference's ``ThermiteAligner``
(``thermite_tpu/wrapper.py``, the Orbit/STAR-style surface a host
application such as Cell Ranger clones across workers) with its batch
surfaces on the port's ``BatchAligner``.

Every method of the reference is here.  The per-read surfaces
(``align_read``, ``align_read_pair``) run the reference's sequential
oracle, as there; ``align_reads``, ``align_reads_records`` and
``align_read_pairs_records`` run the port's batch pipeline on ``device``.
Records carry no TX/GX/GN/RE tags (reference src/wrapper.rs:136-139).
"""

from __future__ import annotations

from typing import List

from thermite_tpu.io.sam import SamRecord
from thermite_tpu.wrapper import ThermiteAligner as _ReferenceAligner

from . import device as _device
from .align.batch import BatchAligner


class ThermiteAligner(_ReferenceAligner):
    def __init__(self, index_path: str, device="cuda"):
        """``device`` is "cuda" (raises without a card) or "cpu" (the
        plain PyTorch kernels), as for ``BatchAligner``."""
        self.device = _device.resolve(device)
        super().__init__(index_path)

    def _batcher(self) -> BatchAligner:
        """The batch pipeline for the current options, built on first
        use (``set_opts`` drops it)."""
        if self._batch is None:
            self._batch = BatchAligner(self.index, self.align_opts,
                                       device=self.device)
        return self._batch

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
