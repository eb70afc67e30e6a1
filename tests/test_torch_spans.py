"""The port's span recorder (``utils/stats.py::PipelineStats``) on the CPU.

Spans nest under path keys with their CPU seconds at the top level; a
span's self time is never below 0; ``reset`` clears what was recorded;
``dsync`` and ``cpu`` name no span.  The BAM writer compresses a
write's blocks as one ``deflate`` span on the calling thread and counts
its blocks, pooled or not.  The main path (``align_batch_emit``
with the C++ engine) records the stages it had and the spans inside
them, each parent holding its children; the engine's exonic lifts are
the spans ``arbitrate/lift`` and ``finalize/lift`` where a chunk has
exonic alignments, and the transcriptome counters (problems in
transcript windows; reads whose primary record is exonic or spliced,
and unmapped reads) agree with the benchmark's plain reference.  Under ``torch.profiler`` each
span is an event named by its path; with no profiler recording a span
makes no call into the profiler."""

import io
import json
import os
import threading
import time
from contextlib import contextmanager
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from thermite_tpu_torch.align.batch import BatchAligner
from thermite_tpu_torch.align.driver import AlignOpts
from thermite_tpu_torch.index.build import Index
from thermite_tpu_torch.io.bam import BamWriter
from thermite_tpu_torch.testing.synth import make_truth_reads, write_synth_genome
from thermite_tpu_torch.utils.stats import PipelineStats

from bench_cells import BENCH, SEED, TINY, bam_fields
from benchmark import harness
from benchmark.gen import synth_genome, transcript_reads
from benchmark.reference import Reference
from benchmark.reference.genome import Genome

torch.set_num_threads(1)

OLD_KEYS = {"build", "arbitrate", "finalize", "arbitrate/dsync",
            "finalize/dsync", "text pack", "text upload"}
NEW_KEYS = {"dispatch", "build/seed", "finalize/emit", "arbitrate/patch",
            "prepare", "join", "build/cpu", "dispatch/cpu", "arbitrate/cpu",
            "finalize/cpu", "prepare/cpu", "join/cpu", "text pack/cpu",
            "text upload/cpu"}
LIFT_KEYS = {"arbitrate/lift", "finalize/lift"}
COUNTERS = ("tx_problems", "exonic_reads", "spliced_reads", "unmapped_reads")


def _spin(s: float) -> None:
    end = time.perf_counter() + s
    while time.perf_counter() < end:
        pass


def test_nested_spans_record_under_paths():
    st = PipelineStats()
    with st.stage("build"):
        with st.stage("seed"):
            with st.stage("probe"):
                pass
        with st.stage("seed"):
            pass
    with st.stage("finalize"):
        with st.dsync("finalize"):
            pass
        with st.stage("emit"):
            pass
    assert set(st.stage_s) == {
        "build", "build/cpu", "build/seed", "build/seed/probe",
        "finalize", "finalize/cpu", "finalize/dsync", "finalize/emit"}
    assert st.spans() == ["build", "build/seed", "build/seed/probe",
                          "finalize", "finalize/emit"]
    # a span opened after its parent closed is top-level again
    with st.stage("seed"):
        pass
    assert "seed" in st.stage_s and "seed/cpu" in st.stage_s


def test_self_time_never_below_zero():
    st = PipelineStats()
    for _ in range(50):
        with st.stage("arbitrate"):
            with st.dsync("arbitrate"):
                _spin(1e-5)
            with st.stage("patch"):
                _spin(1e-5)
                with st.stage("row"):
                    _spin(1e-5)
    for path in st.spans():
        assert st.self_s(path) >= 0.0
    s = st.stage_s
    assert s["arbitrate"] >= s["arbitrate/dsync"] + s["arbitrate/patch"]
    assert st.self_s("arbitrate/patch/row") == s["arbitrate/patch/row"]
    want = s["arbitrate/patch"] - s["arbitrate/patch/row"]
    assert st.self_s("arbitrate/patch") == pytest.approx(want, abs=1e-12)


def test_cpu_seconds_on_top_level_spans_only():
    st = PipelineStats()
    with st.stage("build"):
        with st.stage("seed"):
            _spin(0.02)
    assert "build/cpu" in st.stage_s
    assert not [k for k in st.stage_s if k.count("/") > 1
                or (k.endswith("/cpu") and k != "build/cpu")]
    # the spin is CPU time of the process, counted at the top level
    assert 0.0 < st.stage_s["build/cpu"]
    assert st.split() == {"build": st.stage_s["build"]}


def test_reset_clears_everything():
    st = PipelineStats()
    with st.stage("finalize"):
        with st.dsync("finalize"):
            pass
    st.reads = st.chunks = st.problems = st.tasks = st.winners = 3
    st.dp_cells = st.dp_cells_ref = st.cert_patches = 3
    st.stream_fallbacks = st.emit_cpp_chunks = st.spliced_pairs = 3
    st.emit_py_chunks = st.bgzf_blocks = st.bgzf_pooled_blocks = 3
    st.tx_problems = st.exonic_reads = st.spliced_reads = 3
    st.unmapped_reads = 3
    with st.stage("arbitrate"):
        st.timed("lift", 0.5)
    assert st.stage_s["arbitrate/lift"] == 0.5
    assert "of them in transcript windows\t3" in st.report()
    assert "primary exonic / spliced, unmapped\t3 / 3, 3" in st.report()
    t0 = st._t0
    st.reset()
    fresh = PipelineStats()
    for name in ("reads", "chunks", "problems", "tasks", "winners",
                 "dp_cells", "dp_cells_ref", "cert_patches",
                 "stream_fallbacks", "emit_cpp_chunks", "spliced_pairs",
                 "emit_py_chunks", "bgzf_blocks", "bgzf_pooled_blocks",
                 *COUNTERS):
        assert getattr(st, name) == getattr(fresh, name) == 0, name
    assert dict(st.stage_s) == {} and st.spans() == []
    assert "primary exonic" not in st.report()
    assert st._t0 > t0
    with st.stage("build"):  # the recorder works on after a reset
        pass
    assert set(st.stage_s) == {"build", "build/cpu"}


class _SpanLog(PipelineStats):
    """A recorder that also logs each span it opens, with its thread."""

    def __init__(self):
        super().__init__()
        self.opened = []

    @contextmanager
    def stage(self, name):
        self.opened.append((name, threading.get_ident()))
        with super().stage(name):
            yield


def test_bam_writer_spans_and_block_counters(monkeypatch):
    monkeypatch.setenv("THERMITE_THREADS", "4")
    st = _SpanLog()
    fh = io.BytesIO()
    index = SimpleNamespace(refs=[SimpleNamespace(name="chr1", len=1000)])
    writer = BamWriter(fh, index, st)  # the header: no block
    assert st.opened == [] and st.bgzf_blocks == st.bgzf_pooled_blocks == 0
    with st.stage("bam_write"):
        writer.write_raw(b"\x07" * 60_000)  # one full block: inline
    assert st.bgzf_blocks == 1 and st.bgzf_pooled_blocks == 0
    st.opened.clear()
    for _ in range(2):  # three full blocks each: the pool
        with st.stage("bam_write"):
            writer.write_raw(bytes(range(256)) * 800)
    me = threading.get_ident()
    assert st.opened == [("bam_write", me), ("deflate", me)] * 2
    assert st.bgzf_pooled_blocks == 6 and st.bgzf_blocks == 7
    assert set(st.stage_s) == {"bam_write", "bam_write/cpu",
                               "bam_write/deflate"}
    report = st.report()
    assert "  BGZF blocks\t7 (6 on the pool)" in report
    assert "    deflate\t" in report
    st.reset()
    assert st.bgzf_blocks == st.bgzf_pooled_blocks == 0
    assert "BGZF blocks" not in st.report()


@pytest.mark.parametrize("name", ["dsync", "cpu", "build/seed"])
def test_reserved_names_are_refused(name):
    st = PipelineStats()
    with pytest.raises(ValueError):
        with st.stage(name):
            pass
    with pytest.raises(ValueError):  # an engine-timed span needs a parent
        st.timed("lift", 1.0)
    with st.stage("build"):
        with pytest.raises(ValueError):
            with st.stage(name):
                pass
        with pytest.raises(ValueError):
            st.timed(name, 1.0)
    assert set(st.stage_s) == {"build", "build/cpu"}


@pytest.fixture(scope="module")
def aligner_case(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("spans"))
    fasta, gtf = write_synth_genome(d, 60_000, seed=43, basename="sp")
    index = Index.create_from_files(fasta, gtf)
    index.build_seed_table(stride=1)
    opts = AlignOpts(min_seed_len=20, min_aln_score_percent=0.0,
                     min_aln_score=30, intron_mode=True)
    reads = make_truth_reads(index, 200, seed=9)
    recs = [(n.encode(), s, b"I" * len(s)) for n, s in reads]
    return index, opts, recs


def _aligner(case):
    index, opts, recs = case
    a = BatchAligner(index, opts, device="cpu")
    a.PROBLEM_BUDGET = 256
    a.narrow_band = 4  # certificate failures, so patches run
    return a, recs


def test_main_path_records_old_and_new_keys(aligner_case):
    a, recs = _aligner(aligner_case)
    raw = a.align_batch_emit(recs, True)
    assert raw and a.native is not None and a.stats.cert_patches > 0
    assert a.stats.exonic_reads > 0  # lifts in arbitrate and finalize
    st = a.stats.stage_s
    want = OLD_KEYS | NEW_KEYS | LIFT_KEYS
    if "text pack" not in st:  # the artifact carried the packed text
        want -= {"text pack", "text pack/cpu"}
    assert set(st) == want
    for path in a.stats.spans():
        kids = [k for k in st if k.rpartition("/")[0] == path
                and not k.endswith("/cpu")]
        assert sum(st[k] for k in kids) <= st[path]
    assert a.stats.chunks > 2
    # a second batch: the text is resident, its keys do not grow
    text = st["text upload"]
    a.align_batch_emit(recs[:50], True)
    assert st["text upload"] == text
    assert a.stats.split().keys() == {
        "build", "dispatch", "arbitrate host", "arbitrate device wait+d2h",
        "finalize host", "finalize device wait+d2h", "prepare", "join",
        "text upload", *({"text pack"} & set(st))}
    report = a.stats.report()
    for line in ("  build\t", "    seed\t", "  dispatch\t", "    patch\t",
                 "    emit\t", "CPU/wall", "    lift\t"):
        assert line in report


def test_spans_are_profiler_events_named_by_path(aligner_case):
    from torch.profiler import ProfilerActivity, profile

    a, recs = _aligner(aligner_case)
    a.align_batch_emit(recs[:20], True)  # the resident text, before
    a.stats.reset()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        a.align_batch_emit(recs, True)
    events = [e for e in prof.events() if e.name in
              ("build", "build/seed", "dispatch", "arbitrate",
               "arbitrate/patch", "arbitrate/dsync", "finalize",
               "finalize/emit", "finalize/dsync")]
    names = {e.name for e in events}
    assert names == {"build", "build/seed", "dispatch", "arbitrate",
                     "arbitrate/patch", "arbitrate/dsync", "finalize",
                     "finalize/emit", "finalize/dsync"}
    assert sum(e.name == "build" for e in events) == a.stats.chunks
    # the chunk's number rides each span; one chunk's spans share it
    by_chunk = {}
    for e in events:
        by_chunk.setdefault(e.kwinputs["chunk"], set()).add(e.name)
    assert len(by_chunk) == a.stats.chunks
    for names in by_chunk.values():
        assert {"build", "build/seed", "dispatch", "arbitrate", "finalize",
                "finalize/emit"} <= names


def test_no_profiler_call_without_a_profiler(aligner_case, monkeypatch):
    import torch.autograd.profiler as autograd_profiler
    import torch.profiler

    def boom(*a, **k):
        raise AssertionError("a profiler call with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", boom)
    monkeypatch.setattr(autograd_profiler, "record_function", boom)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", boom)
    a, recs = _aligner(aligner_case)
    assert a.align_batch_emit(recs[:60], True)
    st = PipelineStats()
    with st.stage("build"):
        with st.stage("seed"):
            pass
        with st.dsync("build"):
            pass
    assert "build/seed" in st.stage_s


@pytest.fixture(scope="module")
def gex_case(tmp_path_factory):
    """A tiny genome's gex3p91 batch under syn45_cr's options: the port's
    index, the reference's genome, the records."""
    genome = synth_genome.ensure(str(tmp_path_factory.mktemp("gex")),
                                 TINY.TINY_CFG)
    index = Index.create_from_files(genome["fasta"], genome["gtf"])
    index.build_seed_table(stride=1)
    tr = json.load(open(os.path.join(BENCH, "traffic", "gex3p91.json")))
    tr["batch_reads"] = 400
    cfg = json.load(open(os.path.join(BENCH, "configs", "syn45_cr.json")))
    recs = transcript_reads.make_batch(genome, tr, SEED, 0, 1)
    src, org = transcript_reads.sources(
        genome, dict(tr, batch_reads=200), np.random.default_rng(5))
    intergenic = [(b"ig%d" % i, row.tobytes()[:91], b"F" * 91)
                  for i, row in enumerate(src[org["kind"] == 2])]
    return (index, Genome.from_files(genome["fasta"], genome["gtf"]), cfg,
            recs, intergenic)


@pytest.mark.parametrize("path", ["emit", "objects", "no engine"])
def test_transcriptome_counters_match_the_reference(gex_case, path):
    index, ref_genome, cfg, recs, _ = gex_case
    a = BatchAligner(index, harness.port_opts(cfg), device="cpu",
                     use_native=path != "no engine")
    a.PROBLEM_BUDGET = 512  # several chunks
    if path == "objects":
        a.align_batch([r[1] for r in recs])
    else:
        a.align_batch_emit(recs, True)
    ref = Reference(ref_genome, cfg, [r[1] for r in recs])
    want = dict.fromkeys(COUNTERS, 0)
    e2t = ref_genome.txome.exon_to_tx
    for rec in recs:
        flag, cig, exonic = bam_fields(ref.records(*rec))
        want["unmapped_reads"] += bool(flag & 4)
        want["exonic_reads"] += exonic
        want["spliced_reads"] += any(op == "N" for op, _ in cig)
        # a left and a right problem for each transcript a seed lies in
        want["tx_problems"] += 2 * sum(
            len(set(e2t.find(h.ref_idx, h.ref_idx + h.len).tolist()))
            for h in ref.seeder.all_smems(rec[1].upper()))
    got = {k: getattr(a.stats, k) for k in COUNTERS}
    assert got == want
    assert 0 < want["spliced_reads"] < want["exonic_reads"]
    assert want["unmapped_reads"] > 0
    report = a.stats.report()
    assert f"of them in transcript windows\t{want['tx_problems']}" in report
    assert (f"primary exonic / spliced, unmapped\t{want['exonic_reads']} / "
            f"{want['spliced_reads']}, {want['unmapped_reads']}") in report


def test_lift_spans_nest_in_their_stages(gex_case):
    from torch.profiler import ProfilerActivity, profile

    index, _, cfg, recs, intergenic = gex_case
    a = BatchAligner(index, harness.port_opts(cfg), device="cpu")
    a.PROBLEM_BUDGET = 512
    a.align_batch_emit(recs[:20], True)  # the resident text, before
    a.stats.reset()
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        a.align_batch_emit(recs, True)
    st = a.stats.stage_s
    assert LIFT_KEYS <= set(st)
    for key in LIFT_KEYS:
        stage = key.partition("/")[0]
        assert 0 < st[key] < st[stage] - st.get(stage + "/dsync", 0.0)
    marks = [e for e in prof.events() if e.name in LIFT_KEYS]
    assert {e.name for e in marks} == LIFT_KEYS
    assert all(set(e.kwinputs) == {"chunk", "us"} for e in marks)
    assert sum(e.kwinputs["us"] for e in marks) == pytest.approx(
        1e6 * sum(st[k] for k in LIFT_KEYS), abs=len(marks))
    # intron mode on, reads that touch no gene: no exonic alignment
    b = BatchAligner(index, harness.port_opts(
        dict(cfg, opts=dict(cfg["opts"], intron_mode=True,
                            min_aln_score_percent=0.0))), device="cpu")
    assert b.align_batch_emit(intergenic, True)
    assert b.stats.unmapped_reads < len(intergenic) / 2
    assert b.stats.exonic_reads == b.stats.tx_problems == 0
    assert not LIFT_KEYS & set(b.stats.stage_s)
