"""The port's other entry points on the CPU give the reference's bytes:
the embedding wrapper, ``--engine cpp`` (``CppAligner``), host shards
joined by ``merge``, and the flags that are not ported yet.

The wrapper (device="cpu") equals the reference wrapper on the cases of
tests/test_wrapper.py and tests/test_paired_emit.py; ``CppAligner``
equals the batch emit, the reference's ``CppAligner``, at any thread
count and at ``THERMITE_NARROW_BAND=0``, paired too; two shards merged
equal one run, for SAM and BAM, single-end and paired."""

import gzip

import pytest
import torch

from fixtures import READS, write_fixture
from test_paired_emit import make_mixed_pairs
from thermite_tpu.align.cpu import CppAligner as RefCppAligner
from thermite_tpu.align.driver import AlignOpts
from thermite_tpu.cli import main as ref_main
from thermite_tpu.index.build import Index
from thermite_tpu.io.bam import encode_bam_record
from thermite_tpu.io.sam import unique_refs
from thermite_tpu.testing.synth import make_truth_reads, write_fastq, write_synth_genome
from thermite_tpu.wrapper import ThermiteAligner as RefWrapper
from thermite_tpu_torch.align.batch import BatchAligner
from thermite_tpu_torch.align.cpu import CppAligner
from thermite_tpu_torch.cli import main as port_main
from thermite_tpu_torch.wrapper import ThermiteAligner

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The 60 kbp genome of tests/test_paired_emit.py, saved, with 300
    truth reads as a FASTQ."""
    d = tmp_path_factory.mktemp("torch_entry")
    fasta, gtf = write_synth_genome(str(d), 60_000, seed=43, basename="pe")
    index = Index.create_from_files(fasta, gtf)
    idx = str(d / "pe.tai.npz")
    index.build_seed_table(stride=1)
    index.save(idx)
    reads = make_truth_reads(index, 300, seed=9)
    fq = str(d / "reads.fq")
    write_fastq(reads, fq)
    recs = [(n.encode(), s, b"I" * len(s)) for n, s in reads]
    opts = AlignOpts(min_seed_len=20, min_aln_score_percent=0.0,
                     min_aln_score=30, intron_mode=True)
    return d, idx, fq, index, recs, opts


@pytest.fixture(scope="module")
def fixture_index(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_entry_fix")
    ref, gtf, _ = write_fixture(d)
    path = str(d / "fix.npz")
    Index.create_from_files(ref, gtf).save(path)
    return path


def _fixture_opts(w):
    # tests/test_wrapper.py's fixture-sized parameters
    w.align_opts.min_seed_len = 3
    w.align_opts.min_aln_score = 0
    w.align_opts.min_aln_score_percent = 0.0
    w.align_opts.intron_mode = True
    return w


@pytest.mark.parametrize("fmt_bam", [False, True])
def test_wrapper_records_equal_reference(fixture_index, fmt_bam):
    recs = [(n.encode(), s.encode(), b"9" * len(s)) for n, s in READS]
    recs.append((b"noqual", READS[2][1].encode(), b""))
    names, reads, quals = ([r[k] for r in recs] for k in range(3))
    ref = _fixture_opts(RefWrapper(fixture_index))
    port = _fixture_opts(ThermiteAligner(fixture_index, device="cpu"))
    want = ref.align_reads_records(names, reads, quals, fmt_bam=fmt_bam)
    got = port.align_reads_records(names, reads, quals, fmt_bam=fmt_bam)
    assert got == want
    # the object path serializes to the same bytes, tags stripped
    ref_ids = {n: i for i, (n, _) in enumerate(unique_refs(port.index))}
    objs = port.align_reads(names, reads, quals)
    assert b"".join(encode_bam_record(r, ref_ids) if fmt_bam
                    else (r.to_line() + "\n").encode()
                    for group in objs for r in group) == got
    if not fmt_bam:
        for tag in (b"TX:Z:", b"GX:Z:", b"GN:Z:", b"RE:A:"):
            assert tag not in got
        assert b"AS:i:" in got and got.count(b"\n") >= len(recs)
    # the per-read (oracle) surface is the reference's own
    assert [r.to_line() for r in port.align_read(*recs[0])] == \
        [r.to_line() for r in ref.align_read(*recs[0])]
    assert port.header() == ref.header()


def test_wrapper_pairs_equal_reference(synth, tmp_path):
    _, idx, _, index, _, opts = synth
    ref, port = RefWrapper(idx), ThermiteAligner(idx, device="cpu")
    for w in (ref, port):
        w.set_opts(opts)
    pairs = make_mixed_pairs(index, n=8, seed=21)
    args = ([r1.id for r1, _ in pairs], [r1.seq for r1, _ in pairs],
            [r1.qual for r1, _ in pairs], [r2.seq for _, r2 in pairs],
            [r2.qual for _, r2 in pairs])
    for fmt_bam in (False, True):
        want = ref.align_read_pairs_records(*args, fmt_bam=fmt_bam)
        assert port.align_read_pairs_records(*args, fmt_bam=fmt_bam) == want
    # == each pair's align_read_pair records through the Python writer
    sam = port.align_read_pairs_records(*args, mate_rescue=False)
    lines = [(rec.to_line() + "\n").encode()
             for r1, r2 in pairs
             for rec in port.align_read_pair(r1.id, r1.seq, r1.qual, r2.seq,
                                             r2.qual, mate_rescue=False)]
    assert sam == b"".join(lines)


def test_wrapper_cuda_without_card_raises(fixture_index):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        ThermiteAligner(fixture_index)


@pytest.mark.parametrize("fmt_bam", [False, True])
def test_cpp_engine_equals_batch_emit(synth, fmt_bam):
    _, _, _, index, recs, opts = synth
    want = BatchAligner(index, opts, device="cpu").align_batch_emit(recs, fmt_bam)
    got = CppAligner(index, opts, threads=1).align_records(recs, fmt_bam)
    assert got == want
    assert RefCppAligner(index, opts).align_records(recs, fmt_bam) == want


def test_cpp_engine_threads_and_full_band(synth, monkeypatch):
    """Thread-count invariant, and the same bytes with the narrow-band
    pass off, single-end and paired; paired == the batch paired emit."""
    _, _, _, index, recs, opts = synth
    pairs = [((r1.id, r1.seq, r1.qual), (r2.id, r2.seq, r2.qual))
             for r1, r2 in make_mixed_pairs(index, n=18, seed=3)]
    one = CppAligner(index, opts, threads=1)
    want = one.align_records(recs, False)
    want_p = one.align_records_paired(pairs, True)
    assert want_p == BatchAligner(index, opts, device="cpu").align_paired_emit(
        pairs, True)
    assert want_p == RefCppAligner(index, opts).align_records_paired(pairs, True)
    three = CppAligner(index, opts, threads=3)
    assert three.align_records(recs, False) == want
    assert three.align_records_paired(pairs, True) == want_p
    monkeypatch.setenv("THERMITE_NARROW_BAND", "0")
    full = CppAligner(index, opts, threads=2)
    assert full.narrow_band == 0
    assert full.align_records(recs, False) == want
    assert full.align_records_paired(pairs, True) == want_p


def _read(path, bam):
    with (gzip.open(path, "rb") if bam else open(path, "rb")) as f:
        return f.read()


@pytest.mark.parametrize("ext,paired", [(".sam", False), (".bam", False),
                                        (".sam", True)])
def test_shards_merged_equal_one_run(synth, ext, paired):
    """Two hosts (--num-hosts 2 --host-id 0/1) each align their block of
    reads (or of pairs) and write OUTPUT.shardNNN; ``merge`` joins them
    into the single run's records (BAM: the same decompressed stream)."""
    d, idx, fq, index, *_ = synth
    queries = [fq]
    if paired:
        pairs = make_mixed_pairs(index, n=30, seed=13)
        queries = [str(d / "s1.fq"), str(d / "s2.fq")]
        for path, k in zip(queries, (0, 1)):
            write_fastq([(p[k].id.decode(), p[k].seq) for p in pairs], path)
        queries.append("--paired")
    flags = ["-a", "-k", "20", "-s", "0", "--intron-mode", "--device", "cpu"]
    tag = ext[1:] + ("_paired" if paired else "")
    single, out = str(d / f"single_{tag}{ext}"), str(d / f"sharded_{tag}{ext}")
    assert port_main(["align", idx, *queries, "-o", single, *flags]) == 0
    for h in ("0", "1"):
        assert port_main(["align", idx, *queries, "-o", out, *flags,
                          "--num-hosts", "2", "--host-id", h]) == 0
    shards = [out + ".shard000", out + ".shard001"]
    assert _read(shards[0], ext == ".bam") != _read(single, ext == ".bam")
    merged = str(d / f"merged_{tag}{ext}")
    assert port_main(["merge", "-o", merged, *shards]) == 0
    assert _read(merged, ext == ".bam") == _read(single, ext == ".bam")
    ref_merged = str(d / f"ref_merged_{tag}{ext}")
    assert ref_main(["merge", "-o", ref_merged, *shards]) == 0
    with open(merged, "rb") as a, open(ref_merged, "rb") as b:
        assert a.read() == b.read()


def test_cli_cpp_engine_equals_reference(synth):
    d, idx, fq, *_ = synth
    flags = ["-a", "-k", "20", "-s", "0", "--intron-mode", "--engine", "cpp"]
    ref_out, port_out = str(d / "ref_cpp.sam"), str(d / "port_cpp.sam")
    assert ref_main(["align", idx, fq, "-o", ref_out, *flags]) == 0
    assert port_main(["align", idx, fq, "-o", port_out, *flags,
                      "--threads", "2"]) == 0
    with open(ref_out, "rb") as a, open(port_out, "rb") as b:
        want, got = a.read(), b.read()
    assert got == want and b"\tAS:i:" in got
    with pytest.raises(ValueError, match="SAM/BAM"):
        port_main(["align", idx, fq, "-o", str(d / "x.paf"), "--engine", "cpp"])


@pytest.mark.parametrize("flag,item", [
    (["--mesh", "2"], "7b"), (["--coordinator", "h:1"], "item 7"),
    (["--profile", "p"], "item 9"),
])
def test_flags_not_ported_raise(tmp_path, flag, item):
    with pytest.raises(NotImplementedError, match=item):
        port_main(["align", str(tmp_path / "i.npz"), "r.fq", *flag])
