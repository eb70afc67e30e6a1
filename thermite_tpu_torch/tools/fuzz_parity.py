"""Adversarial parity fuzz: the batch pipeline against the oracle.

Aligns thousands of heavily mutated reads (substitutions, indels, N
bases, both strands; 90 bp, or 40-150 bp with ``--long``) through
``BatchAligner`` on the card and compares every read's alignments with
the sequential oracle (``OracleAligner.align_read``).  Five edge reads
ride along: poly-A, all N, a fold-back chimera, the chromosome's last
60 bp and a random read.  Long reads raise the pipeline's pinned shapes
(XMAX up to 160, YMAX up to 192, and 288 at full band, where they reach
the stream kernel's 32 x 8 group).

Usage (on the card):

    python -m thermite_tpu_torch.tools.fuzz_parity [N_READS] [SEED] [--long]
        [--pct=P] [--syn45]

N_READS defaults to 3000, SEED to 777, P (``-s``) to 0.  The genome is
GRCh38 chrM from ``data/`` (``tools/workloads.py::CHRM_FASTA``), or the
45 Mbp synthetic chromosome with ``--syn45``.  Exits 1 on any mismatch,
2 when the chrM FASTA is absent.
"""

from __future__ import annotations

import sys
import time
from typing import List

import numpy as np

from .workloads import bench_opts, chrm_index, first_chrom, syn45_index


def mutate(rng, r: bytes, n_max: int = 8, allow_indels: bool = True) -> bytes:
    """Up to ``n_max`` - 1 edits of ``r``: deletions (reads above 30 bp),
    insertions and substitutions of ACGT, and N bases."""
    r = bytearray(r)
    alpha = b"ACGT"
    for _ in range(int(rng.integers(0, n_max))):
        m = int(rng.integers(0, 4 if allow_indels else 2))
        q = int(rng.integers(1, max(len(r) - 1, 2)))
        if m == 0 and allow_indels and len(r) > 30:
            del r[q]
        elif m == 1 and allow_indels:
            r.insert(q, alpha[int(rng.integers(0, 4))])
        elif m == 2:
            r[q] = alpha[int(rng.integers(0, 4))]
        else:
            r[q] = ord("N")
    return bytes(r)


def fuzz_reads(chrom: bytes, n: int, seed: int = 777,
               long_reads: bool = False) -> List[bytes]:
    """``n`` mutated reads of ``chrom`` (90 bp, or 40-149 bp with
    ``long_reads``), half of them reverse-complemented, then the five
    edge reads."""
    from ..io.fastx import revcomp

    rng = np.random.default_rng(seed)
    reads = []
    for _ in range(n):
        L = int(rng.integers(40, 150)) if long_reads else 90
        p = int(rng.integers(0, len(chrom) - L - 1))
        r = mutate(rng, chrom[p : p + L])
        reads.append(revcomp(r) if rng.random() < 0.5 else r)
    reads += [
        b"A" * 60, b"N" * 80, chrom[:45] + revcomp(chrom[:45]), chrom[-60:],
        bytes(b"ACGT"[c] for c in rng.integers(0, 4, 90)),
    ]
    return reads


def oracle_alignments(index, opts, reads: List[bytes], seeder=None) -> list:
    """The oracle's alignments of every read (``OracleAligner.align_read``;
    ``seeder``: an SMEM engine of this index to reuse, else the oracle's
    own)."""
    from ..align.driver import OracleAligner, align_read

    if seeder is None:
        seeder = OracleAligner(index, opts).seeder
    return [align_read(index, r, opts, seeder) for r in reads]


def oracle_sam(index, recs, alns) -> bytes:
    """The SAM lines the oracle's alignments ``alns`` of ``recs``
    ((name, seq, qual) tuples) give through the Python writers."""
    from ..io.sam import aln_to_sam_record, unmapped_sam_record

    lines = []
    for (name, seq, qual), found in zip(recs, alns):
        if not found:
            lines.append(unmapped_sam_record(name, seq, qual).to_line())
        for i, aln in enumerate(found):
            lines.append(aln_to_sam_record(index, name, seq, qual, aln,
                                           len(found), i + 1).to_line())
    return "".join(line + "\n" for line in lines).encode()


def compare(reads: List[bytes], got: list, want: list):
    """-> (reads whose alignments are identical, the first three
    mismatches as (read index, read, got[:1], want[:1]))."""
    if len(got) != len(want):
        raise ValueError(f"{len(got)} results for {len(want)} reads")
    bad = [k for k, (g, w) in enumerate(zip(got, want)) if g != w]
    return len(reads) - len(bad), [(k, reads[k], got[k][:1], want[k][:1])
                                   for k in bad[:3]]


def fuzz_parity(aligner, reads: List[bytes], want: list) -> dict:
    """``reads`` through ``aligner.align_batch`` against the oracle's
    alignments ``want`` -> a dict: reads, identical, mismatches (the first
    three), cert_patches, chunks, the pipeline's shapes and the batch's
    seconds (its results are host lists, so the card is done when it
    returns)."""
    aligner.stats.reset()
    t0 = time.perf_counter()
    got = aligner.align_batch(reads)
    batch_s = time.perf_counter() - t0
    identical, bad = compare(reads, got, want)
    return {"reads": len(reads), "identical": identical, "mismatches": bad,
            "cert_patches": aligner.stats.cert_patches,
            "chunks": aligner.stats.chunks, "XMAX": aligner._XMAX,
            "YMAX": aligner._YMAX, "SMAX": aligner._SMAX, "batch_s": batch_s}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = [a for a in argv if not a.startswith("--")]
    n = int(args[0]) if args else 3000
    seed = int(args[1]) if len(args) > 1 else 777
    pct = 0.0
    for a in argv:
        if a.startswith("--pct="):
            pct = float(a.split("=", 1)[1])
    if "--syn45" in argv:
        index = syn45_index()
    else:
        try:
            index = chrm_index()
        except FileNotFoundError as e:
            print(f"fuzz_parity: {e}", file=sys.stderr)
            return 2
    from ..align.batch import BatchAligner

    reads = fuzz_reads(first_chrom(index), n, seed, "--long" in argv)
    opts = bench_opts(pct)
    aligner = BatchAligner(index, opts, device="cuda")
    t0 = time.perf_counter()
    want = oracle_alignments(index, opts, reads, aligner.seeder)
    oracle_s = time.perf_counter() - t0
    res = fuzz_parity(aligner, reads, want)
    for k, r, got, want in res["mismatches"]:
        print(f"MISMATCH read {k}: {r[:50]!r}")
        print("  got ", got)
        print("  want", want)
    print(f"fuzz: {res['identical']}/{res['reads']} identical to oracle "
          f"(cert patches {res['cert_patches']}, {res['chunks']} chunks, "
          f"XMAX {res['XMAX']} YMAX {res['YMAX']} SMAX {res['SMAX']}; "
          f"batch {res['batch_s']:.2f} s, oracle {oracle_s:.1f} s)")
    return 1 if res["identical"] != res["reads"] else 0


if __name__ == "__main__":
    sys.exit(main())
