"""The adversarial parity fuzz on the CPU (tolerance 0 throughout).

- The port's ``mutate`` and ``fuzz_reads`` give the reads of the
  reference tool (``tools/fuzz_parity.py``, loaded by path and run with
  its index and aligners stubbed), for three seeds, with and without
  ``--long``; ``workloads.make_reads`` gives ``bench.make_reads``'s.
- Mutated reads (90 bp and 40-150 bp with indels and Ns, and the edge
  reads) through the port's ``BatchAligner(device="cpu")`` equal the
  reference's ``BatchAligner(backend="pallas", interpret=True,
  use_native=True)`` field by field, with equal certificate patches and
  equal SAM and BAM bytes, narrowed at ``-s0`` and ``-s0.66`` and at full
  band at ``-s0.66`` (``-s0`` at full band: ``test_torch_fuzz_full_band.py``),
  with PROBLEM_BUDGET = 256; and without the C++ engine on one case.
- The tool's own check reports 0 mismatches against the port's oracle.
"""

import importlib.util
import os
import sys
import types

import pytest
import torch

from thermite_tpu.align.batch import BatchAligner as RefBatchAligner
from thermite_tpu_torch.align.batch import BatchAligner
from thermite_tpu_torch.testing.synth import write_synth_genome
from thermite_tpu_torch.tools import fuzz_parity
from thermite_tpu_torch.tools.workloads import bench_opts, first_chrom, make_reads
from torch_sides import align_opts, indexes, plain

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUDGET = 256


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF_TOOL = _load("tools/fuzz_parity.py", "ref_fuzz_parity")
BENCH = _load("bench.py", "ref_bench")


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """Each side's index of a 200 kbp synthetic genome, and 150 fuzz
    reads: 70 of 90 bp, then 70 of 40-150 bp, each set with the five
    edge reads."""
    fasta, gtf = write_synth_genome(str(tmp_path_factory.mktemp("fuzz")),
                                    200_000, seed=5)
    index = indexes(fasta, gtf)
    chrom = first_chrom(index.port)
    reads = (fuzz_parity.fuzz_reads(chrom, 70, 11)
             + fuzz_parity.fuzz_reads(chrom, 70, 12, long_reads=True))
    recs = [(b"f%d" % i, r, b"I" * len(r)) for i, r in enumerate(reads)]
    return index, reads, recs


def reference_tool_reads(monkeypatch, chrom, n, seed, long_reads):
    """The reads the reference tool's main() aligns, caught at its
    BatchAligner (its index is the chromosome alone)."""
    seen = []

    class Batch:
        def __init__(self, idx, opts):
            pass

        def align_batch(self, reads):
            seen.extend(reads)
            return [[] for _ in reads]

    class Oracle:
        def __init__(self, idx, opts):
            pass

        def align_read(self, read):
            return []

    idx = types.SimpleNamespace(seq=chrom + b"$", refs=[
        types.SimpleNamespace(start_idx=0, end_idx=len(chrom) + 1)])
    monkeypatch.setattr(REF_TOOL, "Index", types.SimpleNamespace(
        create_from_files=lambda fasta, gtf: idx))
    monkeypatch.setattr(REF_TOOL, "BatchAligner", Batch)
    monkeypatch.setattr(REF_TOOL, "OracleAligner", Oracle)
    monkeypatch.setattr(sys, "argv", ["fuzz_parity.py", str(n), str(seed)]
                        + (["--long"] if long_reads else []))
    assert REF_TOOL.main() == 0
    return seen


@pytest.mark.parametrize("long_reads", [False, True])
@pytest.mark.parametrize("seed", [1, 777, 2024])
def test_fuzz_reads_are_the_reference_tools(monkeypatch, case, seed,
                                            long_reads):
    chrom = first_chrom(case[0].port)
    want = reference_tool_reads(monkeypatch, chrom, 300, seed, long_reads)
    got = fuzz_parity.fuzz_reads(chrom, 300, seed, long_reads)
    assert got == want and len(got) == 305
    lens = {len(r) for r in got[:300]}
    if long_reads:
        assert min(lens) < 45 and max(lens) > 145
    else:
        assert min(lens) < 90 < max(lens)  # indels
    assert any(b"N" in r for r in got[:300])


@pytest.mark.parametrize("allow_indels", [True, False])
def test_mutate_draws_as_the_reference(case, allow_indels):
    import numpy as np

    chrom = first_chrom(case[0].port)
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    for p in range(0, 20000, 100):
        r = chrom[p : p + 120]
        assert (fuzz_parity.mutate(a, r, allow_indels=allow_indels)
                == REF_TOOL.mutate(b, r, allow_indels=allow_indels))


def test_make_reads_are_the_bench_reads(case):
    chrom = first_chrom(case[0].port)
    for seed in (3, 7, 42):
        assert make_reads(chrom, 500, seed) == BENCH.make_reads(chrom, 500, seed)


def _pair(index, pct, narrow_band, use_native=True):
    opts = align_opts(min_seed_len=20, min_aln_score_percent=pct,
                      min_aln_score=30, intron_mode=True)
    ref = RefBatchAligner(index.ref, opts.ref, backend="pallas",
                          interpret=True, use_native=use_native)
    port = BatchAligner(index.port, opts.port, device="cpu",
                        use_native=use_native)
    for a in (ref, port):
        a.PROBLEM_BUDGET = BUDGET
        a.narrow_band = narrow_band
    return ref, port


REGIMES = [(0.0, 15), (0.66, 15), (0.66, 0)]


def check_align_batch(case, pct, narrow_band):
    index, reads, _ = case
    ref, port = _pair(index, pct, narrow_band)
    want = ref.align_batch(reads)
    got = port.align_batch(reads)
    assert plain(got) == plain(want) and sum(map(len, got)) > 0
    assert port.stats.chunks == ref.stats.chunks > 1
    assert port.stats.cert_patches == ref.stats.cert_patches > 0
    # the long reads set the pinned shapes
    assert (port._XMAX, port._SMAX_HOST) == (ref._XMAX, ref._SMAX_HOST)
    assert port._XMAX == 160
    return port


def check_emit(case, pct, narrow_band, fmt_bam):
    index, _, recs = case
    ref, port = _pair(index, pct, narrow_band)
    want = ref.align_batch_emit(recs, fmt_bam)
    got = port.align_batch_emit(recs, fmt_bam)
    assert got == want and len(got) > 0
    assert port.stats.cert_patches == ref.stats.cert_patches


@pytest.mark.parametrize("pct,narrow_band", REGIMES)
def test_align_batch_equals_reference(case, pct, narrow_band):
    check_align_batch(case, pct, narrow_band)


@pytest.mark.parametrize("fmt_bam", [False, True])
@pytest.mark.parametrize("pct,narrow_band", REGIMES)
def test_emit_equals_reference(case, pct, narrow_band, fmt_bam):
    check_emit(case, pct, narrow_band, fmt_bam)


def test_no_engine_equals_reference(case):
    index, reads, recs = case
    ref, port = _pair(index, 0.66, 15, use_native=False)
    assert plain(port.align_batch(reads)) == plain(ref.align_batch(reads))
    assert port.stats.chunks == ref.stats.chunks > 1


def test_fuzz_function_finds_no_mismatch(case):
    index = case[0].port
    chrom = first_chrom(index)
    reads = (fuzz_parity.fuzz_reads(chrom, 145, 21)
             + fuzz_parity.fuzz_reads(chrom, 145, 22, long_reads=True))
    opts = bench_opts(0.0)
    aligner = BatchAligner(index, opts, device="cpu")
    want = fuzz_parity.oracle_alignments(index, opts, reads, aligner.seeder)
    res = fuzz_parity.fuzz_parity(aligner, reads, want)
    assert res["reads"] == len(reads) == 300
    assert res["identical"] == 300 and res["mismatches"] == []
    assert res["XMAX"] > 96  # flanks of the long reads


def test_compare_reports_mismatches(case):
    index = case[0].port
    reads = case[1][:20]
    opts = bench_opts(0.0)
    want = fuzz_parity.oracle_alignments(index, opts, reads)
    got = [list(a) for a in want]
    got[3], got[7] = got[3][:0], [None]
    same, bad = fuzz_parity.compare(reads, got, want)
    assert same == (20 - 2 if want[3] else 20 - 1)
    assert bad[-1][0] == 7 and bad[-1][1] == reads[7]


def test_shapes_grow_between_batches(case):
    """A batch pins its shapes up front (the 90 bp reads: XMAX 96); the
    next batch's long reads raise them (XMAX 160) on the same aligner,
    with the reference's alignments and counters."""
    index, reads, _ = case
    ref, port = _pair(index, 0.0, 15)
    for sub in (reads[:75], reads):
        assert plain(port.align_batch(sub)) == plain(ref.align_batch(sub))
        assert port.stats.cert_patches == ref.stats.cert_patches
        if sub is not reads:
            assert port._XMAX == ref._XMAX == 96
    assert (port._XMAX, port._YMAX, port._SMAX, port._SMAX_HOST) == \
        (ref._XMAX, ref._YMAX, ref._SMAX, ref._SMAX_HOST)
    assert (port._XMAX, port._YMAX) == (160, 192)
