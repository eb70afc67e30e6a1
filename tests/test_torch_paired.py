"""The port's paired-end path on the CPU (device="cpu": the plain PyTorch
kernels) gives the reference's bytes.

``BatchAligner.align_paired_emit`` equals the reference's
``align_paired_emit`` (pallas backend, interpret mode) for SAM and BAM
with mate rescue on and off, cut into chunks at a problem budget of 7,
with the C++ engine and without it, and both equal the independent
referee of tests/test_paired_emit.py (``align_batch`` on the interleaved
mates, then ``pair_records`` and the Python writers).  The CLI's
``--paired`` equals the reference CLI and refuses the same usage.  All on
the 60 kbp synthetic genome of tests/test_paired_emit.py."""

import os

import pytest
import torch

from test_paired_emit import _expected_bytes, make_mixed_pairs
from thermite_tpu.align.batch import BatchAligner as RefBatchAligner
from thermite_tpu.cli import main as ref_main
from thermite_tpu.testing.synth import write_fastq, write_synth_genome
from thermite_tpu_torch.align.batch import BatchAligner
from thermite_tpu_torch.cli import main as port_main
from torch_sides import align_opts, indexes

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_paired")
    fasta, gtf = write_synth_genome(str(d), 60_000, seed=43, basename="pe")
    return d, fasta, gtf, indexes(fasta, gtf)


@pytest.fixture(scope="module")
def opts():
    return align_opts(min_seed_len=20, min_aln_score_percent=0.0,
                      min_aln_score=30, intron_mode=True)


def _tuples(pairs):
    return [((r1.id, r1.seq, r1.qual), (r2.id, r2.seq, r2.qual))
            for r1, r2 in pairs]


def _counters(stats):
    return tuple(getattr(stats, k, 0) for k in
                 ("emit_cpp_chunks", "spliced_pairs", "emit_py_chunks"))


@pytest.mark.parametrize("fmt_bam", [False, True])
@pytest.mark.parametrize("rescue", [True, False])
def test_paired_emit_equals_reference(genome, opts, fmt_bam, rescue):
    index = genome[3]
    pairs = _tuples(make_mixed_pairs(index.ref))
    ref = RefBatchAligner(index.ref, opts.ref, backend="pallas",
                          interpret=True)
    want = ref.align_paired_emit(pairs, fmt_bam, max_insert=1000,
                                 mate_rescue=rescue)
    port = BatchAligner(index.port, opts.port, device="cpu")
    got = port.align_paired_emit(pairs, fmt_bam, max_insert=1000,
                                 mate_rescue=rescue)
    assert got == want and len(got) > 0
    cpp_chunks, spliced, py_chunks = _counters(port.stats)
    assert _counters(port.stats) == _counters(ref.stats)
    assert cpp_chunks >= 1 and py_chunks == 0
    if rescue:
        assert spliced >= 2


@pytest.mark.parametrize("use_native", [True, False])
def test_paired_emit_chunks_cut_at_pairs(genome, opts, use_native):
    """At a problem budget of 7 (odd on purpose) the batch crosses many
    chunks; no chunk splits a pair, with or without the C++ engine, and
    the bytes equal the reference's at the same budget and the
    unchunked referee's."""
    index = genome[3]
    pairs = make_mixed_pairs(index.ref, n=16, seed=29)
    ref = RefBatchAligner(index.ref, opts.ref, backend="pallas",
                          interpret=True, use_native=use_native)
    port = BatchAligner(index.port, opts.port, device="cpu",
                        use_native=use_native)
    for a in (ref, port):
        a.PROBLEM_BUDGET = 7
    want = ref.align_paired_emit(_tuples(pairs), False)
    got = port.align_paired_emit(_tuples(pairs), False)
    assert got == want
    assert port.stats.chunks == ref.stats.chunks >= 3
    assert _counters(port.stats) == _counters(ref.stats)
    assert (_counters(port.stats)[2] > 0) == (not use_native)
    assert got == _expected_bytes(index.ref, opts.ref, pairs, False, True)


def test_paired_emit_full_band_and_chunks(genome, opts, monkeypatch):
    """THERMITE_NARROW_BAND=0 (full band, the general-band kernel) gives
    the same paired bytes."""
    index = genome[3]
    pairs = _tuples(make_mixed_pairs(index.ref, n=12, seed=7))
    index, opts = index.port, opts.port
    want = BatchAligner(index, opts, device="cpu").align_paired_emit(pairs, True)
    monkeypatch.setenv("THERMITE_NARROW_BAND", "0")
    full = BatchAligner(index, opts, device="cpu")
    assert full.narrow_band == 0
    assert full.align_paired_emit(pairs, True) == want


def _write_mates(d, pairs, tag):
    fq1, fq2 = str(d / f"{tag}_1.fq"), str(d / f"{tag}_2.fq")
    write_fastq([(r1.id.decode(), r1.seq) for r1, _ in pairs], fq1)
    write_fastq([(r2.id.decode(), r2.seq) for _, r2 in pairs], fq2)
    return fq1, fq2


def test_paired_cli_equals_reference(genome, tmp_path):
    d, fasta, gtf, index = genome
    pairs = make_mixed_pairs(index.ref, n=20, seed=5)
    fq1, fq2 = _write_mates(tmp_path, pairs, "m")
    idx = str(tmp_path / "pe.tai.npz")
    assert port_main(["index", fasta, gtf, "-o", idx]) == 0
    flags = ["-a", "-k", "20", "-s", "0", "--intron-mode"]
    for ext, extra in ((".sam", []), (".bam", ["--no-mate-rescue"]),
                       (".sam", ["--max-insert", "200"])):
        ref_out = str(tmp_path / f"ref{ext}")
        port_out = str(tmp_path / f"port{ext}")
        assert ref_main(["align", idx, fq1, fq2, "--paired", "-o", ref_out,
                         *flags, *extra]) == 0
        assert port_main(["align", idx, fq1, fq2, "--paired", "-o", port_out,
                          *flags, *extra, "--device", "cpu"]) == 0
        with open(ref_out, "rb") as a, open(port_out, "rb") as b:
            want, got = a.read(), b.read()
        assert got == want and len(got) > 0, (ext, extra)


@pytest.mark.parametrize("argv", [
    ["--paired"],                          # one query file
    ["X2", "--paired", "-o", "o.paf"],      # PAF output
    ["X2", "--paired", "-a", "--num-hosts", "2"],  # no host id
    ["--num-hosts", "2", "--host-id", "2"],
])
def test_paired_usage_errors_match_reference(tmp_path, argv):
    """Usage errors are raised before the index is read, with the
    reference's messages."""
    fq = str(tmp_path / "r.fq")
    argv = [fq if a == "X2" else a for a in argv]
    args = ["align", str(tmp_path / "missing.tai.npz"), fq, *argv]
    with pytest.raises(SystemExit) as ref_err:
        ref_main(args)
    with pytest.raises(SystemExit) as port_err:
        port_main(args)
    assert str(port_err.value) == str(ref_err.value) != ""
    assert os.listdir(tmp_path) == []
