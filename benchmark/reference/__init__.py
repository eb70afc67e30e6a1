"""The plain reference that decides ``correct``: the aligner's semantics in
plain Python and numpy, worked out from the FASTA and GTF that the
benchmark wrote.  It imports nothing of the program and takes nothing
that the program made.

``Reference(fasta, gtf, config, reads).records(name, seq, qual)`` gives
the BAM records (the concatenated blobs, no header) that the aligner has
to write for one read: the upstream aligner's seed, extend, arbitrate and
filter steps (``oracle.align_read``), then the SAM fields, the tags and
the BAM encoding.
"""

from __future__ import annotations

from typing import Sequence

from .bam import encode_bam_record
from .genome import Genome
from .oracle import AlignOpts, align_read
from .sam import aln_to_sam_record, unmapped_sam_record
from .seeds import SampleSeeder


def align_opts(cfg: dict) -> AlignOpts:
    """The configuration's ``opts`` as the reference's options."""
    o = cfg["opts"]
    return AlignOpts(min_seed_len=o["min_seed_len"],
                     min_aln_score_percent=o["min_aln_score_percent"],
                     min_aln_score=o["min_aln_score"],
                     multimap_score_range=o["multimap_score_range"],
                     intron_mode=o["intron_mode"])


class Reference:
    """The reference aligner over ``genome`` for the reads ``reads``
    (their sequences: the seed scan looks for their k-mers only)."""

    def __init__(self, genome: Genome, cfg: dict, reads: Sequence[bytes]):
        self.genome = genome
        self.opts = align_opts(cfg)
        self.seeder = SampleSeeder(genome.seq_arr, reads,
                                   self.opts.min_seed_len,
                                   stride=cfg["seed_stride"])
        self.ref_ids = {n: i for i, (n, _) in enumerate(genome.unique_refs())}

    def records(self, name: bytes, seq: bytes, qual: bytes) -> bytes:
        alns = align_read(self.genome, seq, self.opts, self.seeder)
        if not alns:
            return encode_bam_record(unmapped_sam_record(name, seq, qual),
                                     self.ref_ids)
        return b"".join(
            encode_bam_record(aln_to_sam_record(self.genome, name, seq, qual,
                                                aln, len(alns), i + 1),
                              self.ref_ids)
            for i, aln in enumerate(alns))
