"""The benchmark cells ``syn45_cr.gex3p91`` and ``syn45.mix150`` at a tiny
size on the CPU.

Their read generators (``benchmark/gen/transcript_reads.py``,
``mixed_windows.py`` and the error routine both use, ``errors.py``) give
the same reads for a seed and batch, and the origins, shares, strands,
windows, names, qualities, lengths and error rates their traffic files
state.  The port's batch path writes, under each cell's options, the BAM
records of the benchmark's plain reference (``benchmark/reference/``)
byte for byte.  A tiny cell of each, added as files and entries beside
``benchmark/tests/conftest.py``'s tiny cell, runs through the harness
with ``correct`` true and the lift metric read."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.gen import errors, mixed_windows, synth_genome, transcript_reads
from benchmark.reference import Reference
from benchmark.reference.genome import Genome
from benchmark.reference.gtf import parse_gtf
from thermite_tpu_torch.align.batch import BatchAligner
from thermite_tpu_torch.index.build import Index

from bench_cells import BENCH, REPO, SEED, TINY, bam_fields, by_read

torch.set_num_threads(1)

CELLS = {"gex3p91": "syn45_cr", "mix150": "syn45"}  # traffic: configuration
GEN = {"gex3p91": transcript_reads, "mix150": mixed_windows}


def _json(*parts):
    return json.load(open(os.path.join(BENCH, *parts)))


def _traffic(mix, n):
    tr = _json("traffic", mix + ".json")
    tr["batch_reads"] = n
    return tr


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    return synth_genome.ensure(str(tmp_path_factory.mktemp("g")), TINY.TINY_CFG)


@pytest.fixture(scope="module")
def indexes(genome):
    """(the port's index with its stride-1 seed table, the reference's
    genome) of the tiny genome."""
    idx = Index.create_from_files(genome["fasta"], genome["gtf"])
    idx.build_seed_table(stride=1)
    return idx, Genome.from_files(genome["fasta"], genome["gtf"])


@pytest.fixture(scope="module")
def annotation(genome):
    """The GTF's first transcript of each gene, as the reference parses it."""
    genes, txs = parse_gtf(genome["gtf"])
    first = {}
    for t in txs:
        first.setdefault(t.gene_idx, t)
    return [first[g] for g in range(len(genes))]


def _chrom_seqs(genome):
    data = open(genome["fasta"], "rb").read()
    return {c["name"]: data[c["offset"] : c["offset"] + c["len"]]
            for c in genome["chroms"]}


def _revcomp(s: bytes) -> bytes:
    return s.translate(bytes.maketrans(b"ACGTN", b"TGCAN"))[::-1]


@pytest.mark.parametrize("mix", sorted(CELLS))
def test_same_reads_for_a_seed_and_batch(genome, mix):
    tr = _traffic(mix, 300)
    gen = GEN[mix]
    a = gen.make_batch(genome, tr, SEED, 0, 4)
    assert a == gen.make_batch(genome, tr, SEED, 0, 4)
    for other in (gen.make_batch(genome, tr, SEED, 0, 5),
                  gen.make_batch(genome, tr, SEED, 1, 4),
                  gen.make_batch(genome, tr, SEED + 1, 0, 4)):
        assert sum(x[1] == y[1] for x, y in zip(a, other)) < 30
    names = [r[0] for r in a]
    assert len(set(names)) == len(names) == 300
    assert all(len(r[1]) == len(r[2]) for r in a)


def test_gex_origins_and_junction_share(genome, annotation):
    tr = _traffic("gex3p91", 20000)
    _, org = transcript_reads.sources(genome, tr, np.random.default_rng(7))
    kind = org["kind"]
    for k, want in enumerate((0.7, 0.2, 0.1)):
        assert abs(np.mean(kind == k) - want) < 0.015
    # an mRNA read crosses a junction where its window spans an exon end
    m = kind == 0
    ends = [np.cumsum([b - a for a, b in t.exons])[:-1] for t in annotation]
    start, L = org["start"][m], tr["read_len"]
    cross = [any(s < e < s + L for e in ends[g])
             for g, s in zip(org["gene"][m], start)]
    assert 0.55 < np.mean(cross) < 0.61  # 180 of the 310 starts
    # Zipf with exponent 1: the gene of rank r takes 1 / (r H) of the reads
    counts = np.sort(np.bincount(org["gene"][m], minlength=len(annotation)))
    ng = len(annotation)
    want = 1 / np.arange(1, ng + 1) / sum(1 / np.arange(1, ng + 1))
    assert np.abs(counts[::-1] / m.sum() - want).max() < 0.015


def test_gex_sense_strand_and_windows(genome, annotation):
    tr = _traffic("gex3p91", 3000)
    src, org = transcript_reads.sources(genome, tr, np.random.default_rng(11))
    chroms = _chrom_seqs(genome)
    W, L = src.shape[1], tr["read_len"]
    strands = set()
    spans = [(t.chrom, t.start, t.end) for t in annotation]
    for row, k, g, s, c, rev in zip(src, org["kind"], org["gene"],
                                    org["start"], org["chrom"],
                                    org["reverse"]):
        row = row.tobytes()
        if k == 0:  # the sense transcript, 91-400 bp from its 3' end
            t = annotation[g]
            tx = t.spliced_seq(chroms[t.chrom])
            assert row == tx[s : s + W]
            assert W <= len(tx) - s <= 400
            strands.add(t.strand)
        elif k == 1:  # the sense span, over an intron
            t = annotation[g]
            span = chroms[t.chrom][t.start : t.end]
            assert row == (span if t.strand else _revcomp(span))[s : s + W]
            lo = t.start + s if t.strand else t.end - s - L
            introns = [(b, a2) for (_, b), (a2, _) in zip(t.exons, t.exons[1:])]
            assert any(lo < b and a < lo + L for a, b in introns)
        else:  # a window of either strand that touches no gene
            ch = genome["chroms"][c]["name"]
            fwd = chroms[ch][s : s + W]
            assert row == (_revcomp(fwd) if rev else fwd)
            assert not any(n == ch and s < e and b < s + W
                           for n, b, e in spans)
    assert strands == {True, False}
    assert org["reverse"][org["kind"] == 2].any()


def test_gex_names_and_quality_bins(genome):
    tr = _traffic("gex3p91", 4000)
    recs = transcript_reads.make_batch(genome, tr, SEED, 0, 9)
    names = [r[0] for r in recs]
    assert len(set(names)) == len(names)
    assert all(len(n.split(b":")) == 7 and 34 <= len(n) <= 42 for n in names)
    quals = set()
    for _, seq, qual in recs:
        assert len(seq) == len(qual) == 91
        quals.update(qual)
        assert [i for i, b in enumerate(qual) if b == ord("#")] == \
            [i for i, b in enumerate(seq) if b == ord("N")]
    assert quals == set(b"F:,#")


@pytest.mark.parametrize("mix", sorted(CELLS))
def test_error_rates(mix):
    spec = _json("traffic", mix + ".json")["errors"]
    rng = np.random.default_rng(3)
    n = 49152
    lens = rng.integers(40, 151, n)
    src = errors.ACGT[rng.integers(0, 4, (n, 150 + errors.SRC_PAD))]
    seq, npos, indel = errors.mutate(rng, src, lens, spec)
    assert abs(np.mean(indel != 0) - spec["indel_share"]) < 0.006
    assert abs(np.mean(npos >= 0) - spec["n_share"]) < 0.003
    k = np.abs(indel[indel != 0])
    assert set(k.tolist()) == set(range(spec["indel_len"][0],
                                        spec["indel_len"][1] + 1))
    assert np.mean(indel[indel != 0] > 0) == pytest.approx(0.5, abs=0.08)
    plain = np.flatnonzero((indel == 0) & (npos < 0))
    pos = np.arange(seq.shape[1])
    diff = ((seq[plain] != src[plain, : seq.shape[1]])
            & (pos < lens[plain, None])).sum(1)
    assert diff.max() <= spec["substitutions"][1]
    assert (seq[np.flatnonzero(npos >= 0), npos[npos >= 0]] == ord("N")).all()
    # without substitutions and Ns, an indel read is its source with k
    # bases taken out, or put in, at one place inside it
    bare = dict(spec, substitutions=[0, 0], n_share=0.0)
    seq, _, indel = errors.mutate(np.random.default_rng(4), src, lens, bare)
    for i in np.flatnonzero(indel)[:200]:
        L, k, row, s = int(lens[i]), int(abs(indel[i])), seq[i].tobytes(), \
            src[i].tobytes()
        if indel[i] < 0:
            assert any(row[:L] == (s[:p] + s[p + k:])[:L] for p in range(1, L))
        else:
            assert any(row[:p] == s[:p] and row[p + k : L] == s[p : L - k]
                       for p in range(1, L))


def test_mix150_lengths(genome):
    tr = _traffic("mix150", 49152)
    recs = mixed_windows.make_batch(genome, tr, SEED, 0, 0)
    lens = np.array([len(r[1]) for r in recs])
    assert abs(np.mean(lens == 150) - 0.7) < 0.01
    short = lens[lens != 150]
    assert short.min() == 40 and short.max() == 149
    assert abs(short.mean() - 94.5) < 1.5
    assert all(r[2] == b"I" * len(r[1]) for r in recs[:2000])
    assert [r[0] for r in recs[:3]] == [b"r0", b"r1", b"r2"]


@pytest.mark.parametrize("mix", sorted(CELLS))
def test_reads_match_the_reference(genome, indexes, mix):
    cfg = _json("configs", CELLS[mix] + ".json")
    n = {"gex3p91": 600, "mix150": 300}[mix]
    recs = GEN[mix].make_batch(genome, _traffic(mix, n), SEED, 0, 0)
    idx, ref_genome = indexes
    aligner = BatchAligner(idx, harness.port_opts(cfg), device="cpu")
    aligner.PROBLEM_BUDGET = 1024  # several chunks
    got = by_read(aligner.align_batch_emit(recs, True), [r[0] for r in recs])
    ref = Reference(ref_genome, cfg, [r[1] for r in recs])
    seen = {"unmapped": 0, "short side": 0, "indel": 0, "N": 0, "exonic": 0}
    for rec, mine in zip(recs, got):
        assert b"".join(mine) == ref.records(*rec), rec[0]
        flag, cig, exonic = bam_fields(mine[0])
        seen["unmapped"] += bool(flag & 4)
        seen["exonic"] += exonic
        seen["indel"] += any(op in "ID" for op, _ in cig)
        seen["N"] += b"N" in rec[1]
        ops = [(op, k) for op, k in cig if op != "S"]
        seen["short side"] += any(
            op == "N" and (ops[j - 1][1] < 20 or ops[j + 1][1] < 20)
            for j, (op, k) in enumerate(ops))
    assert seen["indel"] and seen["N"]
    if mix == "gex3p91":  # intronic and intergenic reads are dropped
        assert seen["short side"] and seen["exonic"] > n / 2
        assert 0.2 * n < seen["unmapped"] < 0.4 * n
    else:
        lens = {len(r[1]) for r in recs}
        assert 150 in lens and min(lens) < 100


@pytest.mark.parametrize("mix", sorted(CELLS))
def test_tiny_cell_runs_correct(tmp_path, mix):
    root = TINY.copy_checkout(str(tmp_path))
    TINY.add_tiny_cell(root)
    cfg = _json("configs", CELLS[mix] + ".json")
    # a gene every 1.5-2.5 kbp: exonic winners in every window
    cfg.update(TINY.TINY_CFG, name="tiny_" + mix, index="artifact",
               gene_every=2_000)
    with open(os.path.join(root, "benchmark", "configs",
                           f"tiny_{mix}.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "benchmark", "traffic",
                           f"tiny_{mix}.json"), "w") as f:
        json.dump(_traffic(mix, 256), f)
    spec_path = os.path.join(root, "BENCHMARK.json")
    spec = json.load(open(spec_path))
    cell = f"tiny_{mix}.{mix}"
    spec["configs"].append({"name": f"tiny_{mix}", "source": "tests",
                            "file": f"benchmark/configs/tiny_{mix}.json",
                            "reduced": [], "why": "tests"})
    spec["workloads"].append({"name": cell, "config": f"tiny_{mix}",
                              "traffic": f"tiny_{mix}", "chips": 1,
                              "why": "tests"})
    for m in spec["per_layer"]:
        if m["name"] == "lift_s_per_mread":
            m["workloads"].append(cell)
    json.dump(spec, open(spec_path, "w"))
    # a process of its own: this one has JAX loaded, which the harness
    # refuses
    run = ("import json, sys, time, torch; torch.set_num_threads(1); "
           "from benchmark import harness; print(json.dumps(harness.run_cell("
           f"{root!r}, {cell!r}, {SEED}, 0.5, True, time.time(), "
           "device='cpu')))")
    proc = subprocess.run([sys.executable, "-c", run], capture_output=True,
                          text=True, timeout=600, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.splitlines()[-1])
    assert out["correct"] is True and out["failed"] == 0
    assert out["check"]["mismatched_reads"] == {"value": 0, "limit": 0}
    assert out["metrics"]["lift_s_per_mread"]["value"] > 0
