"""What decides ``correct``: the BAM records that the timed path wrote,
read back from the blocks the sink kept, against the plain reference's.

A run keeps the blocks of ``RETAIN_BATCHES`` batches, however many the
window runs: batch 0 and a reservoir (Algorithm R, ``Retention``) of the
rest over batches 1, 2, ..., drawn from the seed, so the sample spreads
over the whole window and the harness's share of the process's memory
does not follow the program's rate.  The run keeps each batch's stream
span only; its reads are made again from (seed, batch) once the window
has closed and the program's state is freed.  Then ``CHECK_READS`` reads
of those batches, drawn from the seed, are aligned by the reference from
its own index of the FASTA and GTF; a read whose records differ from the
program's by a byte counts as mismatched.  A batch whose stream does
not parse into records of its reads, in order, counts every one of its
reads as mismatched.

The compared number is ``mismatched_reads``, with the limit 0: the
program's records are the oracle's byte for byte (its bring-up held them
so), and the control (the reference without the genome-versus-
transcriptome arbitration, ``control_reference``) reads the exonic reads
whose transcript tags it drops as mismatched.
"""

from __future__ import annotations

import copy
import dataclasses
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .bamsink import BlockSink, read_name, split_records
from .reference import Reference
from .reference.genome import Genome
from .reference.txome import IntervalTable

CHECK_READS = 2000
RETAIN_BATCHES = 8
LIMIT_MISMATCHED = 0


class Retention:
    """Which batches a run keeps for the check, decided batch by batch as
    the window runs: batch 0, and a reservoir of ``RETAIN_BATCHES - 1``
    places (Algorithm R) over batches 1, 2, ..., whose draws come from
    ``default_rng([seed, 3])``.  Every batch after 0 is kept with the same
    chance, whatever the window's length."""

    def __init__(self, seed: int):
        self._rng = np.random.default_rng([seed, 3])
        self.kept: List[int] = []  # batch 0, then the reservoir's places
        self.offered = 0

    def offer(self, batch: int) -> Tuple[bool, Optional[int]]:
        """Batch ``batch``, the next in order from 0: -> (whether it is
        kept, the kept batch it evicts or None)."""
        if batch != self.offered:
            raise ValueError(f"batch {batch} offered after {self.offered - 1}")
        self.offered += 1
        if len(self.kept) < RETAIN_BATCHES:
            self.kept.append(batch)
            return True, None
        j = 1 + int(self._rng.integers(batch))  # batch = batches seen after 0
        if j >= RETAIN_BATCHES:
            return False, None
        evicted, self.kept[j] = self.kept[j], batch
        return True, evicted


def kept_batches(seed: int, batches: int) -> List[int]:
    """The batches, in order, that a run of ``batches`` batches keeps."""
    ret = Retention(seed)
    for b in range(batches):
        ret.offer(b)
    return sorted(ret.kept)


def header_len(data: bytes) -> int:
    """Length of the BAM header at the start of ``data``."""
    if data[:4] != b"BAM\x01":
        raise ValueError("the BAM stream does not start with its magic")
    l_text = int.from_bytes(data[4:8], "little")
    pos = 8 + l_text
    n_ref = int.from_bytes(data[pos : pos + 4], "little")
    pos += 4
    for _ in range(n_ref):
        pos += 4 + int.from_bytes(data[pos : pos + 4], "little") + 4
    return pos


def program_records(sink: BlockSink, lo: int, hi: int,
                    names: Sequence[bytes]) -> List[bytes]:
    """Each read's records (concatenated blobs) in the stream span
    [lo, hi) that the batch of ``names`` wrote; None for every read of
    a batch whose span does not parse into the records of its reads in
    order."""
    try:
        recs = split_records(sink.span(lo, hi))
    except ValueError as e:
        print(f"check: batch span {lo}-{hi}: {e}", file=sys.stderr)
        return [None] * len(names)
    out: List[bytes] = []
    p = 0
    for name in names:
        q = p
        while q < len(recs) and read_name(recs[q]) == name:
            q += 1
        out.append(b"".join(recs[p:q]) if q > p else None)
        p = q
    if p != len(recs):
        print(f"check: batch span {lo}-{hi}: {len(recs) - p} records of no "
              "read in order", file=sys.stderr)
        return [None] * len(names)
    return out


def sample(seed: int, batches: Sequence[Tuple[int, list]], n: int
           ) -> List[Tuple[int, int]]:
    """(batch slot, read index) of ``n`` reads drawn from the seed over
    the kept batches, with the longest read among them."""
    sizes = [len(recs) for _, recs in batches]
    total = sum(sizes)
    rng = np.random.default_rng([seed, 2])
    flat = rng.choice(total, size=min(n, total), replace=False)
    lens = np.concatenate([[len(r[1]) for r in recs] for _, recs in batches])
    flat = np.unique(np.append(flat, int(np.argmax(lens))))
    starts = np.cumsum([0] + sizes)
    slot = np.searchsorted(starts, flat, side="right") - 1
    return [(int(s), int(f - starts[s])) for s, f in zip(slot, flat)]


def control_reference(genome: Genome, cfg: dict, reads: Sequence[bytes]):
    """The control: the reference with the transcriptome arbitration left
    out (no exon maps to a transcript), which breaks the guarantee that an
    exonic read carries its transcript's tags."""
    bare = copy.copy(genome)
    bare.txome = dataclasses.replace(genome.txome,
                                     exon_to_tx=IntervalTable([], [], []))
    return Reference(bare, cfg, reads)


def judge(got: Dict[Tuple[int, int], bytes], reads: Dict[Tuple[int, int], tuple],
          genome: Genome, cfg: dict, make=Reference) -> Dict[str, float]:
    """Align ``reads`` ({key: (name, seq, qual)}) with the reference made
    by ``make`` and count the keys whose records differ from ``got``."""
    t0 = time.perf_counter()
    keys = sorted(reads)
    ref = make(genome, cfg, [reads[k][1] for k in keys])
    t1 = time.perf_counter()
    bad = sum(1 for k in keys if ref.records(*reads[k]) != got.get(k))
    t2 = time.perf_counter()
    return {"checked_reads": len(keys), "mismatched_reads": bad,
            "seed_scan_s": t1 - t0, "align_s": t2 - t1}


def check_run(sink: BlockSink, head: int, kept: list, seed: int,
              genome: dict, cfg: dict) -> Dict[str, float]:
    """The check of one run: ``kept`` holds (batch, lo, hi, records) of the
    batches whose blocks the sink kept, in batch order, ``head`` the BAM
    header's length.
    -> ``judge``'s counts, with the seconds of the reference's index."""
    try:
        if header_len(sink.span(0, head)) != head:
            raise ValueError("the BAM header is not where the writer put it")
    except ValueError as e:
        print(f"check: {e}", file=sys.stderr)
        kept = []  # nothing checked: not correct
    got, reads = {}, {}
    per_batch = {}
    for slot, i in sample(seed, [(b, recs) for b, _, _, recs in kept],
                          CHECK_READS):
        b, lo, hi, recs = kept[slot]
        if slot not in per_batch:
            per_batch[slot] = program_records(sink, lo, hi,
                                              [r[0] for r in recs])
        got[(b, i)] = per_batch[slot][i]
        reads[(b, i)] = recs[i]
    del per_batch
    t0 = time.perf_counter()
    ref_genome = Genome.from_files(genome["fasta"], genome["gtf"])
    t1 = time.perf_counter()
    verdict = judge(got, reads, ref_genome, cfg)
    verdict["reference_index_s"] = t1 - t0
    return verdict
