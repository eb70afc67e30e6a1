"""The port's other entry points on the CPU give the reference's bytes:
the embedding wrapper, ``--engine cpp`` (``CppAligner``), host shards
joined by ``merge``, and the CLI surface the reference has: ``-v`` on
either side of the subcommand, the ``index`` flags, ``--mesh``,
``--profile``, ``--coordinator``, and the environment knobs
``THERMITE_PROBLEM_BUDGET``, ``THERMITE_PIPELINE_DEPTH`` and
``THERMITE_NO_EMIT``.

The wrapper (device="cpu") equals the reference wrapper on the cases of
tests/test_wrapper.py and tests/test_paired_emit.py; ``CppAligner``
equals the batch emit, the reference's ``CppAligner``, at any thread
count and at ``THERMITE_NARROW_BAND=0``, paired too; two shards merged
equal one run, for SAM and BAM, single-end and paired."""

import glob
import gzip
import inspect
import json
import os

import numpy as np
import pytest
import torch

from fixtures import READS, write_fixture
from test_paired_emit import make_mixed_pairs
from thermite_tpu.align.batch import BatchAligner as RefBatchAligner
from thermite_tpu.align.cpu import CppAligner as RefCppAligner
from thermite_tpu.align.run import align_reads_from_file as ref_align_file
from thermite_tpu.cli import main as ref_main
from thermite_tpu.index.build import Index
from thermite_tpu.testing.synth import make_truth_reads, write_fastq, write_synth_genome
from thermite_tpu.wrapper import ThermiteAligner as RefWrapper
from thermite_tpu_torch.align.batch import BatchAligner
from thermite_tpu_torch.align.cpu import CppAligner
from thermite_tpu_torch.align.run import FORMAT_SAM, align_reads_from_file
from thermite_tpu_torch.cli import _parser
from thermite_tpu_torch.cli import main as port_main
from thermite_tpu_torch.io.bam import encode_bam_record
from thermite_tpu_torch.io.sam import unique_refs
from thermite_tpu_torch.wrapper import ThermiteAligner
from torch_sides import align_opts, indexes

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """The 60 kbp genome of tests/test_paired_emit.py, saved, with 300
    truth reads as a FASTQ."""
    d = tmp_path_factory.mktemp("torch_entry")
    fasta, gtf = write_synth_genome(str(d), 60_000, seed=43, basename="pe")
    index = indexes(fasta, gtf)
    idx = str(d / "pe.tai.npz")
    for side in index:
        side.build_seed_table(stride=1)
    index.ref.save(idx)  # the reference's artifact, loaded by both
    reads = make_truth_reads(index.ref, 300, seed=9)
    fq = str(d / "reads.fq")
    write_fastq(reads, fq)
    recs = [(n.encode(), s, b"I" * len(s)) for n, s in reads]
    opts = align_opts(min_seed_len=20, min_aln_score_percent=0.0,
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
    # the per-read (oracle) surface gives the reference's records
    assert [r.to_line() for r in port.align_read(*recs[0])] == \
        [r.to_line() for r in ref.align_read(*recs[0])]
    assert port.header() == ref.header()


def test_wrapper_pairs_equal_reference(synth, tmp_path):
    _, idx, _, index, _, opts = synth
    ref, port = RefWrapper(idx), ThermiteAligner(idx, device="cpu")
    ref.set_opts(opts.ref)
    port.set_opts(opts.port)
    pairs = make_mixed_pairs(index.ref, n=8, seed=21)
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
    want = BatchAligner(index.port, opts.port,
                        device="cpu").align_batch_emit(recs, fmt_bam)
    got = CppAligner(index.port, opts.port, threads=1).align_records(
        recs, fmt_bam)
    assert got == want
    assert RefCppAligner(index.ref, opts.ref).align_records(
        recs, fmt_bam) == want


def test_cpp_engine_threads_and_full_band(synth, monkeypatch):
    """Thread-count invariant, and the same bytes with the narrow-band
    pass off, single-end and paired; paired == the batch paired emit."""
    _, _, _, index, recs, opts = synth
    pairs = [((r1.id, r1.seq, r1.qual), (r2.id, r2.seq, r2.qual))
             for r1, r2 in make_mixed_pairs(index.ref, n=18, seed=3)]
    ref_index, ref_opts = index.ref, opts.ref
    index, opts = index.port, opts.port
    one = CppAligner(index, opts, threads=1)
    want = one.align_records(recs, False)
    want_p = one.align_records_paired(pairs, True)
    assert want_p == BatchAligner(index, opts, device="cpu").align_paired_emit(
        pairs, True)
    assert want_p == RefCppAligner(ref_index, ref_opts).align_records_paired(
        pairs, True)
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
        pairs = make_mixed_pairs(index.ref, n=30, seed=13)
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


@pytest.mark.parametrize("flag", [
    ["--mesh", "2"], ["--coordinator", "h:1"], ["--profile", "p"],
])
def test_ported_flags_are_accepted(tmp_path, flag):
    """The CLI takes each of these flags and goes on to load the index,
    which is not there."""
    with pytest.raises(FileNotFoundError):
        port_main(["align", str(tmp_path / "i.npz"), "r.fq", *flag,
                   "--device", "cpu"])
    assert not os.path.exists("p")


# -- the CLI surface of the reference ----------------------------------


@pytest.mark.parametrize("argv,want", [
    (["align", "i", "r"], False),
    (["-v", "align", "i", "r"], True),
    (["align", "i", "r", "-v"], True),
    (["-v", "align", "i", "r", "--verbose"], True),
    (["index", "f", "g", "-o", "x", "-v"], True),
    (["-v", "index", "f", "g", "-o", "x"], True),
    (["merge", "-o", "x", "s0", "-v"], True),
    (["merge", "-o", "x", "s0"], False),
])
def test_verbose_before_or_after_the_subcommand(argv, want):
    assert _parser().parse_args(argv).verbose is want


def test_index_takes_the_reference_invocations(tmp_path):
    """``--sa-sampling-rate`` and ``--occ-sampling-rate`` are accepted
    and change nothing; without ``-o`` the port exits with the
    reference's words."""
    ref, gtf, _ = write_fixture(tmp_path)
    plain_out, flagged, ref_out = (str(tmp_path / n) for n in
                                   ("a.tai.npz", "b.tai.npz", "c.tai.npz"))
    assert port_main(["index", ref, gtf, "-o", plain_out]) == 0
    assert port_main(["index", ref, gtf, "--sa-sampling-rate", "16",
                      "--occ-sampling-rate", "64", "-o", flagged]) == 0
    assert ref_main(["index", ref, gtf, "--sa-sampling-rate", "16",
                     "--occ-sampling-rate", "64", "-o", ref_out]) == 0
    with np.load(plain_out) as a, np.load(flagged) as b, np.load(ref_out) as c:
        assert sorted(a.files) == sorted(b.files) == sorted(c.files)
        for k in a.files:
            assert a[k].tobytes() == b[k].tobytes() == c[k].tobytes(), k
    args = _parser().parse_args(["index", ref, gtf])
    assert (args.index, args.sa_sampling_rate, args.occ_sampling_rate) == \
        ("-", 32, 128)
    for main in (port_main, ref_main):
        with pytest.raises(SystemExit) as e:
            main(["index", ref, gtf])
        assert str(e.value) == \
            "index output to stdout not supported; pass -o FILE"


def _emit(synth, monkeypatch, **env):
    """(SAM bytes of the 300 reads, the aligner) with ``env`` set."""
    _, _, _, index, recs, opts = synth
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    a = BatchAligner(index.port, opts.port, device="cpu")
    return a.align_batch_emit(recs, False), a


def test_problem_budget_is_read(synth, monkeypatch):
    _, _, _, index, _, opts = synth
    want, default = _emit(synth, monkeypatch)
    assert default.PROBLEM_BUDGET == BatchAligner.PROBLEM_BUDGET == 65536 - 2048
    got, small = _emit(synth, monkeypatch, THERMITE_PROBLEM_BUDGET="128")
    assert small.PROBLEM_BUDGET == 128
    assert small.stats.chunks > default.stats.chunks == 1
    assert got == want
    # the reference reads the same knob into the same attribute
    assert RefBatchAligner(index.ref, opts.ref).PROBLEM_BUDGET == 128
    assert BatchAligner.PROBLEM_BUDGET == 65536 - 2048  # per aligner


def test_pipeline_depth_is_read(synth, monkeypatch):
    _, _, _, index, _, opts = synth
    monkeypatch.setenv("THERMITE_PROBLEM_BUDGET", "128")  # several chunks
    want, default = _emit(synth, monkeypatch)
    assert default.pipeline_depth == BatchAligner.PIPELINE_DEPTH == 2
    got, serial = _emit(synth, monkeypatch, THERMITE_PIPELINE_DEPTH="1")
    assert serial.pipeline_depth == 1 and serial.stats.chunks > 2
    assert got == want
    assert _emit(synth, monkeypatch, THERMITE_PIPELINE_DEPTH="3")[0] == want
    assert RefBatchAligner(index.ref, opts.ref).pipeline_depth == 3


def _paired_queries(synth, n=30, seed=13):
    d, _, _, index, *_ = synth
    pairs = make_mixed_pairs(index.ref, n=n, seed=seed)
    queries = [str(d / f"q{seed}_1.fq"), str(d / f"q{seed}_2.fq")]
    for path, k in zip(queries, (0, 1)):
        write_fastq([(p[k].id.decode(), p[k].seq) for p in pairs], path)
    return [*queries, "--paired"]


@pytest.mark.parametrize("ext,paired", [
    (".sam", False), (".bam", False), (".paf", False), (".sam", True),
    (".bam", True)])
def test_no_emit_gives_the_same_bytes(synth, monkeypatch, ext, paired):
    """``THERMITE_NO_EMIT`` routes a batch run through ``align_batch`` and
    the Python writers: the emit methods are not called, the bytes are
    the emitter's."""
    d, idx, fq, *_ = synth
    queries = _paired_queries(synth) if paired else [fq]
    flags = ["-k", "20", "-s", "0", "--intron-mode", "--device", "cpu"]
    if ext != ".paf":
        flags.append("-a")
    tag = ext[1:] + ("_paired" if paired else "")
    emit, objs = str(d / f"emit_{tag}{ext}"), str(d / f"noemit_{tag}{ext}")
    assert port_main(["align", idx, *queries, "-o", emit, *flags]) == 0
    monkeypatch.setenv("THERMITE_NO_EMIT", "1")

    def no_emit(*a, **k):
        raise AssertionError("the C++ emit path ran under THERMITE_NO_EMIT")

    monkeypatch.setattr(BatchAligner, "align_batch_emit", no_emit)
    monkeypatch.setattr(BatchAligner, "align_paired_emit", no_emit)
    assert port_main(["align", idx, *queries, "-o", objs, *flags]) == 0
    got = _read(objs, ext == ".bam")
    assert got == _read(emit, ext == ".bam") and len(got) > 0


def test_file_entry_defaults_follow_the_reference(synth, monkeypatch):
    """All but ``engine``, the port's one departure.  A call with the defaults runs the batch engine on the card, where
    the reference's default is the oracle (which touches no device): here
    without a card it raises, and with the defaults' device swapped for
    the CPU it builds a ``BatchAligner`` and gives the oracle's bytes.
    ``engine="oracle"`` asks for the oracle by name, as in the
    reference."""
    d, _, fq, index, _, opts = synth
    port_sig = inspect.signature(align_reads_from_file).parameters
    ref_sig = inspect.signature(ref_align_file).parameters
    assert port_sig["engine"].default == "batch"
    assert ref_sig["engine"].default == "oracle"
    assert port_sig["device"].default == "cuda"
    for name in ("profile_dir", "shard", "mesh"):
        assert port_sig[name].default is ref_sig[name].default is None
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            align_reads_from_file(index.port, [fq], str(d / "no_card.sam"),
                                  FORMAT_SAM, opts.port)
    built = []
    init = BatchAligner.__init__

    def on_cpu(self, *a, **k):
        built.append(k.pop("device"))
        init(self, *a, device="cpu", **k)

    monkeypatch.setattr(BatchAligner, "__init__", on_cpu)
    got, by_name, want = (str(d / n) for n in (
        "default_engine.sam", "oracle_by_name.sam", "ref_default.sam"))
    align_reads_from_file(index.port, [fq], got, FORMAT_SAM, opts.port)
    assert built == ["cuda"]
    align_reads_from_file(index.port, [fq], by_name, FORMAT_SAM, opts.port,
                          engine="oracle")
    assert built == ["cuda"]  # the oracle builds no batch aligner
    ref_align_file(index.ref, [fq], want, FORMAT_SAM, opts.ref)
    assert _read(got, False) == _read(by_name, False) == _read(want, False)


def test_emit_without_the_engine_needs_no_switch(synth):
    """An aligner without the C++ engine serializes in its emit methods by
    the Python writers: the file entry points have one switch,
    ``THERMITE_NO_EMIT``, and ask the aligner nothing."""
    _, _, _, index, recs, opts = synth
    want = BatchAligner(index.port, opts.port, device="cpu"
                        ).align_batch_emit(recs[:60], False)
    got = BatchAligner(index.port, opts.port, device="cpu", use_native=False
                       ).align_batch_emit(recs[:60], False)
    assert got == want and len(got) > 0
    assert not hasattr(BatchAligner, "can_emit")


@pytest.mark.parametrize("paired", [False, True], ids=["single", "paired"])
def test_profile_writes_a_trace_and_keeps_the_bytes(synth, paired):
    d, idx, fq, *_ = synth
    queries = _paired_queries(synth, n=12, seed=5) if paired else [fq]
    flags = ["-a", "-k", "20", "-s", "0", "--intron-mode", "--device", "cpu"]
    tag = "paired" if paired else "single"
    plain_out, prof_out = str(d / f"np_{tag}.sam"), str(d / f"p_{tag}.sam")
    trace_dir = str(d / f"trace_{tag}")
    assert port_main(["align", idx, *queries, "-o", plain_out, *flags]) == 0
    assert port_main(["align", idx, *queries, "-o", prof_out, *flags,
                      "--profile", trace_dir]) == 0
    assert _read(prof_out, False) == _read(plain_out, False)
    traces = glob.glob(os.path.join(trace_dir, "*.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)
    # the program's spans, each with its chunk's number
    chunks = {}
    for e in events:
        if e.get("name") in ("build", "dispatch", "finalize/emit"):
            chunks.setdefault(e["name"], set()).add(e["args"]["chunk"])
    assert set(chunks) == {"build", "dispatch", "finalize/emit"}
    assert chunks["build"] == chunks["dispatch"] == chunks["finalize/emit"]
    assert all(isinstance(c, int) and c >= 0 for c in chunks["build"])


def test_device_busy_is_per_card():
    """``device_busy`` unions the device intervals of each card apart:
    spans that overlap on one card count once, spans of two cards at the
    same time count on both, and host events count on none; nor does a
    user annotation on a card's timeline (a span over the work it
    launched)."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from thermite_tpu_torch.utils.profile import device_busy

    def ev(card, start, end, name, kind=DeviceType.CUDA, note=False):
        return NS(device_type=kind, device_index=card, name=name,
                  time_range=NS(start=start, end=end),
                  is_user_annotation=note)

    prof = NS(events=lambda: [
        ev(0, 0, 10, "k"), ev(0, 5, 12, "copy"), ev(0, 20, 21, "k"),
        ev(1, 0, 10, "k"), ev(0, 0, 100, "host op", DeviceType.CPU),
        ev(0, 30, 90, "build", note=True)])
    busy, by_name = device_busy(prof)
    assert busy == {0: 13, 1: 10}
    assert by_name == {"k": (21, 3), "copy": (7, 1)}


def test_coordinator_is_accepted_and_not_used(synth, capsys):
    """Two hosts with ``--coordinator``: one line on stderr each, the
    shards of a run without it, and ``merge`` gives the single run."""
    d, idx, fq, *_ = synth
    flags = ["-a", "-k", "20", "-s", "0", "--intron-mode", "--device", "cpu"]
    single, out = str(d / "coord_single.sam"), str(d / "coord.sam")
    assert port_main(["align", idx, fq, "-o", single, *flags]) == 0
    capsys.readouterr()
    for h in ("0", "1"):
        assert port_main(["align", idx, fq, "-o", out, *flags, "--num-hosts",
                          "2", "--host-id", h, "--coordinator",
                          "localhost:1234"]) == 0
    err = capsys.readouterr().err
    assert err.count("need no coordinator") == 2 and "localhost:1234" in err
    merged = str(d / "coord_merged.sam")
    assert port_main(["merge", "-o", merged, out + ".shard000",
                      out + ".shard001"]) == 0
    assert _read(merged, False) == _read(single, False)


@pytest.mark.parametrize("mesh,paired", [("2", False), ("-1", False),
                                         ("3", True)])
def test_cli_mesh_gives_one_device_bytes(synth, mesh, paired):
    d, idx, fq, *_ = synth
    queries = _paired_queries(synth) if paired else [fq]
    flags = ["-a", "-k", "20", "-s", "0", "--intron-mode", "--device", "cpu"]
    tag = f"{mesh}_{paired}"
    one, meshed = str(d / f"one_{tag}.bam"), str(d / f"mesh_{tag}.bam")
    assert port_main(["align", idx, *queries, "-o", one, *flags]) == 0
    assert port_main(["align", idx, *queries, "-o", meshed, *flags,
                      "--mesh", mesh]) == 0
    got = _read(meshed, True)
    assert got == _read(one, True) and len(got) > 0


def test_cli_mesh_on_absent_cards_raises(synth):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, idx, fq, *_ = synth
    with pytest.raises(RuntimeError, match="CUDA"):
        port_main(["align", idx, fq, "-a", "--mesh", "2"])
