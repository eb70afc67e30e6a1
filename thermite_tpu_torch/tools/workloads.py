"""The workloads the measurement tools run: the reads, pairs and index of
the repository bench (``bench.py``), whose timing harness is
``thermite_tpu_torch/bench.py``.

- ``make_reads``: 90 bp windows of a chromosome with 0-3 substitutions,
  both strands (``read_draws``: the same rng draws as ``bench.make_reads``,
  so the same reads for a seed; ``make_reads.py`` writes them as FASTQ).
- ``fr_pairs``: FR pairs of 90 bp mates from 300 bp fragments, quality
  ``I`` (bench.py's paired workload).
- ``syn45_index``: the 45 Mbp synthetic spliced chromosome (seed 1234),
  built once and cached as ``data/out/bench_syn45.npz``; artifacts are
  interchangeable with the JAX package's, so either package's cache
  serves both.
- ``chrm_index``: GRCh38 chrM from ``data/`` (the reference's small
  regression genome; not in the repository, so callers name the path it
  was looked for when it is absent).
"""

from __future__ import annotations

import os
import sys
import time
from typing import List, Tuple

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
OUT_DIR = os.path.join(ROOT, "data", "out")
SYN_BP = 45_000_000
CHRM_FASTA = os.path.join(ROOT, "data", "GRCh38-2020-A-chrM.fasta")
CHRM_GTF = os.path.join(ROOT, "data", "GRCh38-2020-A-chrM.gtf")


def bench_opts(pct: float = 0.0):
    """The bench's options: ``-k20 -s<pct> --intron-mode``, score >= 30."""
    from ..align.driver import AlignOpts

    return AlignOpts(min_seed_len=20, min_aln_score_percent=pct,
                     min_aln_score=30, intron_mode=True)


def first_chrom(index) -> bytes:
    """The forward text of the index's first chromosome."""
    ref = index.refs[0]
    return index.seq[ref.start_idx : ref.end_idx - 1]


def read_draws(chrom: bytes, n: int, seed: int):
    """Yield ``n`` (start, strand, read): 90 bp windows of ``chrom`` with
    0-3 substitutions, half of them reverse-complemented (strand ``-``)."""
    from ..io.fastx import revcomp

    rng = np.random.default_rng(seed)
    for _ in range(n):
        p = int(rng.integers(0, len(chrom) - 91))
        r = bytearray(chrom[p : p + 90])
        for _ in range(int(rng.integers(0, 4))):
            r[int(rng.integers(0, 90))] = b"ACGT"[int(rng.integers(0, 4))]
        r = bytes(r)
        if rng.random() < 0.5:
            yield p, "-", revcomp(r)
        else:
            yield p, "+", r


def make_reads(chrom: bytes, n: int, seed: int = 3) -> List[bytes]:
    """``n`` 90 bp reads of ``chrom`` (``read_draws``)."""
    return [r for _, _, r in read_draws(chrom, n, seed)]


def fr_pairs(chrom: bytes, n_pairs: int, seed: int = 51
             ) -> List[Tuple[tuple, tuple]]:
    """``n_pairs`` FR pairs ((name, seq, qual) R1, R2): 90 bp mates from
    300 bp fragments of ``chrom``, R2 reverse-complemented."""
    from ..io.fastx import revcomp

    rng = np.random.default_rng(seed)
    q = b"I" * 90
    pairs = []
    for i in range(n_pairs):
        p = int(rng.integers(0, len(chrom) - 300))
        frag = chrom[p : p + 300]
        pairs.append(((b"p%d" % i, frag[:90], q),
                      (b"p%d" % i, revcomp(frag[-90:]), q)))
    return pairs


def syn45_index():
    """Build or load the cached 45 Mbp synthetic index (the artifact
    carries the seed table, so a cached load skips its build)."""
    from ..index.build import Index
    from ..testing.synth import write_synth_genome

    art = os.path.join(OUT_DIR, f"bench_syn{SYN_BP // 1_000_000}.npz")
    if os.path.exists(art):
        t0 = time.time()
        idx = Index.load(art)
        print(f"syn45 index loaded in {time.time() - t0:.1f} s", file=sys.stderr)
        return idx
    os.makedirs(OUT_DIR, exist_ok=True)
    t0 = time.time()
    fasta, gtf = write_synth_genome(
        OUT_DIR, SYN_BP, seed=1234, basename=f"bench_syn{SYN_BP // 1_000_000}")
    idx = Index.create_from_files(fasta, gtf)
    idx.save(art)
    print(f"syn45 index built+saved in {time.time() - t0:.1f} s", file=sys.stderr)
    return idx


def chrm_index():
    """GRCh38 chrM indexed from ``CHRM_FASTA`` and ``CHRM_GTF``; raises
    FileNotFoundError naming the path when the FASTA is absent."""
    from ..index.build import Index

    if not os.path.exists(CHRM_FASTA):
        raise FileNotFoundError(f"chrM FASTA not found: {CHRM_FASTA}")
    return Index.create_from_files(CHRM_FASTA, CHRM_GTF)


def timed(run, device) -> float:
    """Seconds of ``run()`` on the host clock, ending in a synchronize of
    ``device`` when it is a card."""
    import torch

    t0 = time.perf_counter()
    run()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    return time.perf_counter() - t0
