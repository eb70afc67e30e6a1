"""The port's own copies of the host modules give the reference's outputs.

Each case is one function that runs through BOTH packages
(``thermite_tpu`` and ``thermite_tpu_torch``) on the same numpy-seeded
inputs, each side with its own modules, classes and C++ engine library;
the results are compared as plain tuples, arrays and bytes.  Tolerance
0: every output is an integer or a byte.  The artifact cases cross the
packages: a ``.tai.npz`` saved by either loads in the other with equal
arrays, and shards written by either merge with either ``merge``."""

import contextlib
import gzip
import importlib
import io
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fixtures import READS, write_fixture
from torch_sides import plain

torch.set_num_threads(1)

PKGS = ("thermite_tpu", "thermite_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _opts(pkg, **kw):
    kw = kw or dict(min_seed_len=20, min_aln_score_percent=0.0,
                    min_aln_score=30, intron_mode=True)
    return _mod(pkg, "align.driver").AlignOpts(**kw)


def _genome(pkg, d, bp=60_000):
    """(index, fasta, gtf) of the package's own synthetic genome."""
    synth = _mod(pkg, "testing.synth")
    fasta, gtf = synth.write_synth_genome(os.path.join(d, pkg), bp, seed=43,
                                          basename="hp")
    return _mod(pkg, "index.build").Index.create_from_files(fasta, gtf), \
        fasta, gtf


def _npz(path):
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def _arrays_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


# -- cases: fn(pkg, workdir) -> comparable output ----------------------


def case_synth(pkg, d):
    """write_synth_genome / make_truth_reads / write_fastq: file bytes
    and the reads."""
    index, fasta, gtf = _genome(pkg, d)
    synth = _mod(pkg, "testing.synth")
    reads = synth.make_truth_reads(index, 50, seed=9)
    fq = os.path.join(d, pkg, "r.fq")
    synth.write_fastq(reads, fq)
    return [open(p, "rb").read() for p in (fasta, gtf, fq)], reads


def case_index_arrays(pkg, d):
    """Index.create_from_files + build_seed_table + save: every member
    of the artifact, and the parsed records."""
    index, _, _ = _genome(pkg, d)
    index.build_seed_table(stride=1)
    path = os.path.join(d, pkg, "hp.tai.npz")
    index.save(path)
    loaded = _mod(pkg, "index.build").Index.load(path)
    assert np.array_equal(loaded.seq_arr, index.seq_arr)
    z = _npz(path)
    return ({k: (str(v.dtype), v.shape, v.tobytes()) for k, v in z.items()},
            plain(index.refs), index.stats(),
            plain([(t.id, t.seq) for t in index.txome.txs]))


def case_fixture_io(pkg, d):
    """The readers (FASTA, GTF, FASTQ) and the SAM/BAM/PAF writers on
    the tiny fixture through the oracle: records and file bytes."""
    os.makedirs(os.path.join(d, pkg), exist_ok=True)
    from pathlib import Path

    ref, gtf, fq = write_fixture(Path(d) / pkg)
    index = _mod(pkg, "index.build").Index.create_from_files(ref, gtf)
    opts = _opts(pkg, min_seed_len=3, min_aln_score=0, intron_mode=True)
    run = _mod(pkg, "align.run")
    out = []
    for fmt, name in ((run.FORMAT_SAM, "o.sam"), (run.FORMAT_BAM, "o.bam"),
                      (run.FORMAT_PAF, "o.paf")):
        path = os.path.join(d, pkg, name)
        run.align_reads_from_file(index, [fq], path, fmt, opts,
                                  engine="oracle")
        with (gzip.open(path, "rb") if fmt == run.FORMAT_BAM
              else open(path, "rb")) as f:
            out.append(f.read())
    recs = list(_mod(pkg, "io.fastx").parse_fastx(fq))
    sam, bam = _mod(pkg, "io.sam"), _mod(pkg, "io.bam")
    oracle = _mod(pkg, "align.driver").OracleAligner(index, opts)
    ref_ids = {n: i for i, (n, _) in enumerate(sam.unique_refs(index))}
    blobs = []
    for r in recs:
        alns = oracle.align_read(r.seq)
        for i, a in enumerate(alns):
            rec = sam.aln_to_sam_record(index, r.id, r.seq, r.qual, a,
                                        len(alns), i + 1)
            blobs.append((rec.to_line(), bam.encode_bam_record(rec, ref_ids),
                          _mod(pkg, "io.paf").paf_line(r.id, r.seq, a,
                                                       len(alns))))
        if not alns:
            rec = sam.unmapped_sam_record(r.id, r.seq, r.qual)
            blobs.append((rec.to_line(), bam.encode_bam_record(rec, ref_ids)))
    assert len(recs) == len(READS) and sam.build_sam_header(index)
    return out, blobs, sam.build_sam_header(index), plain(
        [(r.id, r.seq, r.qual) for r in recs])


def _mixed_pairs(pkg, index, n, seed):
    """FR pairs from 300 bp fragments; every fourth pair has a mate that
    seeds cannot find (a substitution every 14 bases: mate rescue), and
    every seventh a random mate (unmapped)."""
    rng = np.random.default_rng(seed)
    revcomp = _mod(pkg, "io.fastx").revcomp
    ref = next(r for r in index.refs if r.strand)
    pairs = []
    for i in range(n):
        p = int(rng.integers(0, ref.len - 301))
        frag = bytes(index.seq[ref.start_idx + p: ref.start_idx + p + 300])
        m1, m2 = frag[:90], revcomp(frag[-90:])
        if i % 4 == 1:
            b = bytearray(m2)
            for k in range(5, 90, 14):
                b[k] = b"ACGT"[(b"ACGT".index(b[k]) + 1) % 4] \
                    if b[k] in b"ACGT" else b[k]
            m2 = bytes(b)
        if i % 7 == 3:
            m2 = bytes(rng.choice(list(b"ACGT"), 90).astype(np.uint8))
        pairs.append(((f"p{i}".encode(), m1, b"I" * 90),
                      (f"p{i}".encode(), m2, b"I" * 90)))
    return pairs


def case_pair_records(pkg, d):
    """pair_records (selection, mate fields, mate rescue) over oracle
    alignments: the records' SAM lines, rescue on and off."""
    index, _, _ = _genome(pkg, d)
    opts = _opts(pkg)
    oracle = _mod(pkg, "align.driver").OracleAligner(index, opts)
    paired = _mod(pkg, "align.paired")
    out = []
    for r1, r2 in _mixed_pairs(pkg, index, 14, seed=5):
        a1, a2 = oracle.align_read(r1[1]), oracle.align_read(r2[1])
        for rescue in (opts, None):
            recs = paired.pair_records(index, _R(*r1), _R(*r2), a1, a2, 1000,
                                       rescue_opts=rescue)
            out.append([r.to_line() for r in recs])
    # mate rescue changed at least one pair, and unmapped mates remain
    assert any(on != off for on, off in zip(out[::2], out[1::2]))
    assert all(len(lines) >= 2 for lines in out)
    return out


class _R:
    def __init__(self, rid, seq, qual):
        self.id, self.seq, self.qual = rid, seq, qual


def case_swg_extend(pkg, d):
    """SwgExtend (the scalar banded affine-gap SWG with X-drop) on
    random windows with substitutions and indels."""
    rng = np.random.default_rng(11)
    SwgExtend = _mod(pkg, "ops.swg_ref").SwgExtend
    out = []
    for k in range(40):
        n = int(rng.integers(1, 60))
        y = rng.choice(list(b"ACGT"), n + 20).astype(np.uint8)
        x = y[:n].copy()
        for _ in range(int(rng.integers(0, 4))):
            x[int(rng.integers(0, n))] = b"ACGT"[int(rng.integers(0, 4))]
        if k % 3 == 0 and n > 10:
            x = np.delete(x, int(rng.integers(2, n - 2)))
        band = int(rng.integers(1, 20))
        out.append(plain(SwgExtend(band).extend(
            x.tobytes(), y.tobytes(), band, int(rng.integers(1, 30)))))
    return out


def case_decode(pkg, d):
    """decode_stream_batch and decode_runs_one on random valid rows,
    certificate-failed rows (-2 - n) and flagged rows (-1)."""
    rng = np.random.default_rng(17)
    runs = _mod(pkg, "ops.runs")
    N, PW = 24, 6
    out = np.zeros((N, 4 + PW), np.int32)
    out[:, 4:] = rng.integers(-(1 << 31), 1 << 31, (N, PW), dtype=np.int64
                              ).astype(np.int32)
    n = rng.integers(0, PW * 16, N)
    out[:, 0] = rng.integers(0, 90, N)
    out[:, 1] = rng.integers(0, 60, N)
    out[:, 2] = rng.integers(0, 80, N)
    out[:, 3] = np.where(np.arange(N) % 5 == 1, -2 - n,
                         np.where(np.arange(N) % 7 == 2, -1, n))
    xl = out[:, 1] + rng.integers(0, 5, N)
    yl = out[:, 2] + rng.integers(0, 5, N)
    streams = plain(runs.decode_stream_batch(out, xl, yl))
    R = 8
    rows = ((rng.integers(0, 4, (N, R)) << runs.RUN_OP_SHIFT)
            | rng.integers(1, 30, (N, R))).astype(np.int32)
    ones = [plain(runs.decode_runs_one(rows[k], int(rng.integers(-1, R + 1)),
                                       int(out[k, 0]), int(out[k, 1]),
                                       int(out[k, 2]), int(xl[k]), int(yl[k])))
            for k in range(N)]
    return streams, ones


def _engine(pkg, index, opts):
    """The package's C++ engine over ``index`` (its own library), as its
    batch pipeline assembles it; -> (engine, reference text)."""
    seeder = _mod(pkg, "seed.native").make_seeder(
        index.seq_arr, opts.min_seed_len,
        table=getattr(index, "seed_table", None),
        stride_known=getattr(index, "seed_stride", None))
    txs = index.txome.txs
    tx_off = np.zeros(len(txs) + 1, np.int64)
    tx_off[1:] = np.cumsum([len(t.seq) for t in txs])
    tx_off += len(index.seq_arr)
    text = np.concatenate([index.seq_arr]
                          + [np.frombuffer(t.seq, np.uint8) for t in txs])
    k = min(_mod(pkg, "seed.kmer").MAX_ANCHOR_K, opts.min_seed_len)
    eng = _mod(pkg, "align.native_batch").NativeBatchEngine(
        index, opts, tx_off, text, opts.min_seed_len, k, seeder=seeder)
    return eng, text


def case_engine_chunk(pkg, d):
    """The C++ engine on one chunk: prep_reads, nib_pack_reads,
    build_chunk, patch_rows (the scalar SWG on every problem),
    arbitrate, finalize and emit_chunk in SAM, BAM and PAF; the seeder's
    SMEMs too."""
    index, _, _ = _genome(pkg, d)
    opts = _opts(pkg)
    reads = _mod(pkg, "testing.synth").make_truth_reads(index, 120, seed=9)
    eng, text = _engine(pkg, index, opts)
    seqs = [s for _, s in reads]
    smems = [plain(eng._seeder.all_smems(s)) for s in seqs[:10]]
    pad, lens = eng.prep_reads(seqs, 256, 96)
    nib = eng.nib_pack_reads(pad)
    ch, consumed, meta, tasks = eng.build_chunk(pad, lens, len(seqs), 4096)
    assert consumed == len(seqs) and len(meta) > 0
    full = np.zeros((len(meta), 4 + 16), np.int32)
    eng.patch_rows(meta, np.arange(len(meta)), pad, text, full)
    sel, pids = eng.arbitrate(ch, full[:, 0], full[:, 1], full[:, 2])
    fin = eng.finalize(ch, full, meta)
    names = [n.encode() for n, _ in reads]
    quals = [b"I" * len(s) for s in seqs]
    emits = [eng.emit_chunk(ch, fmt, names, seqs, quals, strip_tags=strip)
             for fmt, strip in ((False, False), (True, False), (2, False),
                                (False, True))]
    eng.free_chunk(ch)
    assert all(e for e in emits) and len(sel) > 100
    arrays = [pad[:len(seqs)], lens[:len(seqs)], nib, meta, tasks, full, sel,
              pids, *fin]
    return smems, [(str(a.dtype), a.shape, a.tobytes()) for a in arrays], emits


def case_shard_bounds(pkg, d):
    mh = _mod(pkg, "parallel.multihost")
    return [mh.shard_bounds(n, h, i) for n in (0, 1, 7, 100, 101)
            for h in (1, 2, 3, 8) for i in range(h)]


def _truth_bams(pkg, d):
    """The BAMs of tests/test_truth_metrics.py (a 40 kbp genome, 80 truth
    reads with up to 2 substitutions), written by the package's own file
    runner: the cpp engine's, and the oracle's on reads half of which
    lost their tail (so the two files differ)."""
    synth = _mod(pkg, "testing.synth")
    os.makedirs(os.path.join(d, pkg), exist_ok=True)
    fasta, gtf = synth.write_synth_genome(os.path.join(d, pkg), 40_000,
                                          seed=5, basename="tg")
    index = _mod(pkg, "index.build").Index.create_from_files(fasta, gtf)
    reads = synth.make_truth_reads(index, 80, seed=9, max_subst=2)
    run = _mod(pkg, "align.run")
    bams = []
    for name, engine, cut in (("a.bam", "cpp", 0), ("b.bam", "oracle", 30)):
        fq = os.path.join(d, pkg, name + ".fq")
        synth.write_fastq([(n, s[: len(s) - cut * (i % 2)])
                           for i, (n, s) in enumerate(reads)], fq)
        bams.append(os.path.join(d, pkg, name))
        run.align_reads_from_file(index, [fq], bams[-1], run.FORMAT_BAM,
                                  _opts(pkg), engine=engine)
    return bams


def case_alignment_metrics(pkg, d):
    """testing/alignment_metrics.py on the cases of
    tests/test_truth_metrics.py: the truth score of a BAM and its table,
    two BAMs compared read by read and their table, ``main`` in both
    modes, and the refusal of a name that encodes no truth."""
    am = _mod(pkg, "testing.alignment_metrics")
    a, b = _truth_bams(pkg, d)
    truth = am.truth_compare(a)
    assert truth.n_reads == truth.n_aligned == truth.n_true_overlap == 80
    assert truth.n_true_identical >= 60
    assert "|aligned reads | 1.0|" in am.truth_to_markdown(truth)
    cmp_ab, cmp_aa = am.compare(a, b), am.compare(a, a)
    assert cmp_aa.n_identical_align == cmp_aa.n_reads == 80
    assert cmp_ab.n_identical_align < 80 <= cmp_ab.n_overlapping_align + 5
    printed = []
    for argv in (["--truth", a], [a, b]):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert am.main(argv) == 0
        printed.append(out.getvalue().replace(os.path.join(d, pkg), ""))
    with pytest.raises(SystemExit):
        am._parse_truth("synth0")
    with pytest.raises(SystemExit):
        am.main([a])  # in2 is required without --truth
    return (plain(truth), am.truth_to_markdown(truth), plain(cmp_ab),
            am.to_markdown(cmp_ab), plain(cmp_aa), printed,
            plain(am.truth_compare(b)), am._parse_truth("r:chr1:5:95:-"))


CASES = {f.__name__[5:]: f for f in (
    case_synth, case_index_arrays, case_fixture_io, case_pair_records,
    case_swg_extend, case_decode, case_engine_chunk, case_shard_bounds,
    case_alignment_metrics)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_host_module_parity(case, tmp_path):
    ref, port = (CASES[case](pkg, str(tmp_path)) for pkg in PKGS)
    assert plain(port) == plain(ref)


@pytest.mark.parametrize("pkg", PKGS)
def test_alignment_metrics_runs_as_a_module(pkg, tmp_path):
    """``python -m <package>.testing.alignment_metrics --truth BAM``, as
    tests/test_truth_metrics.py::test_truth_cli runs the reference's."""
    bam, _ = _truth_bams(pkg, str(tmp_path))
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    out = subprocess.run(
        [sys.executable, "-m", f"{pkg}.testing.alignment_metrics", "--truth",
         bam], capture_output=True, text=True, check=True, env=env,
    ).stdout
    assert "|aligned reads | 1.0|" in out
    assert "|primary overlaps truth | 1.0|" in out


# -- artifacts cross the packages --------------------------------------


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """Each package's saved index of the same genome, with 80 reads."""
    d = str(tmp_path_factory.mktemp("host_parity"))
    paths = {}
    for pkg in PKGS:
        index, _, _ = _genome(pkg, d)
        index.build_seed_table(stride=1)
        paths[pkg] = os.path.join(d, pkg, "x.tai.npz")
        index.save(paths[pkg])
    synth = _mod(PKGS[0], "testing.synth")
    fq = os.path.join(d, "reads.fq")
    synth.write_fastq(synth.make_truth_reads(index, 80, seed=2), fq)
    return d, paths, fq


@pytest.mark.parametrize("saver,loader", [PKGS, PKGS[::-1]])
def test_artifact_loads_in_the_other_package(artifacts, saver, loader):
    """A ``.tai.npz`` saved by one package loads in the other: equal
    arrays, equal re-saved members, and equal oracle SAM."""
    d, paths, fq = artifacts
    Index = _mod(loader, "index.build").Index
    own, other = Index.load(paths[loader]), Index.load(paths[saver])
    assert np.array_equal(own.seq_arr, other.seq_arr)
    assert plain(own.refs) == plain(other.refs)
    for a, b in zip(own.seed_table[1:], other.seed_table[1:]):
        assert np.array_equal(a, b)
    again = os.path.join(d, f"{saver}_via_{loader}.tai.npz")
    other.save(again)
    _arrays_equal(_npz(again), _npz(paths[saver]))
    run = _mod(loader, "align.run")
    outs = []
    for tag, index in (("own", own), ("other", other)):
        out = os.path.join(d, f"{loader}_{tag}.sam")
        run.align_reads_from_file(index, [fq], out, run.FORMAT_SAM,
                                  _opts(loader), engine="oracle")
        outs.append(open(out, "rb").read())
    assert outs[0] == outs[1] and outs[0].count(b"\tAS:i:") > 60


@pytest.mark.parametrize("fmt", ["sam", "bam", "paf"])
@pytest.mark.parametrize("writer,merger", [PKGS, PKGS[::-1]])
def test_shards_merge_with_either_package(artifacts, writer, merger, fmt):
    """Three shards written by one package's file runner (oracle engine)
    merge with the other package's ``merge_shards`` into the single
    run's records; ``sniff_shard_format`` agrees."""
    d, paths, fq = artifacts
    run = _mod(writer, "align.run")
    index = _mod(writer, "index.build").Index.load(paths[writer])
    opts = _opts(writer)
    base = os.path.join(d, f"{writer}_{merger}.{fmt}")
    run.align_reads_from_file(index, [fq], base, fmt, opts, engine="oracle")
    shards = []
    for h in range(3):
        shards.append(f"{base}.shard{h:03d}")
        run.align_reads_from_file(index, [fq], shards[-1], fmt, opts,
                                  engine="oracle", shard=(h, 3))
    mh = _mod(merger, "parallel.multihost")
    assert mh.sniff_shard_format(shards[0]) == fmt
    merged = base + ".merged"
    mh.merge_shards(shards, merged, fmt)

    def read(p):
        with (gzip.open(p, "rb") if fmt == "bam" else open(p, "rb")) as f:
            return f.read()

    assert read(merged) == read(base) and len(read(base)) > 0
