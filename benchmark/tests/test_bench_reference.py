"""The plain reference against the program's own CPU path on a small
genome: the same seeds as the program's numpy seeder at strides 1 and 4,
the same BAM records as the program's oracle and writer, and a control
that fails."""

import os

import pytest

from benchmark import check
from benchmark.gen import synth_genome, windows
from benchmark.reference.genome import Genome
from benchmark.reference.seeds import SampleSeeder
from conftest import REPO


CFG = {"name": "refg", "total_bp": 600_000, "n_chroms": 3, "genome_seed": 8,
       "gene_every": 6_000}


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    return synth_genome.ensure(str(tmp_path_factory.mktemp("g")), CFG)


@pytest.fixture(scope="module")
def reads(genome):
    import json

    tr = json.load(open(os.path.join(REPO, "benchmark", "traffic", "se90.json")))
    tr["batch_reads"] = 300
    recs = windows.make_batch(genome, tr, 2**32 + 1, 0, 0)
    g = Genome.from_files(genome["fasta"], genome["gtf"])
    # edge reads: a chromosome's first and last bases, a repeat, too short
    edges = [g.seq[0:90], g.seq[g.refs[0].end_idx - 91 : g.refs[0].end_idx - 1],
             b"AC" * 45, b"ACGT" * 4]
    return recs + [(b"edge%d" % i, s, b"F" * len(s)) for i, s in enumerate(edges)]


@pytest.mark.parametrize("stride", [1, 4])
def test_seeds_match_program(genome, reads, stride):
    from thermite_tpu_torch.seed.smem import SmemEngine

    g = Genome.from_files(genome["fasta"], genome["gtf"])
    mine = SampleSeeder(g.seq_arr, [r[1] for r in reads], 20, stride)
    theirs = SmemEngine(g.seq_arr, 20, stride=stride)

    def t(ms):
        return [(m.ref_idx, m.query_idx, m.len) for m in ms]

    for _, seq, _ in reads:
        assert t(mine.all_smems(seq)) == t(theirs.all_smems(seq))


@pytest.mark.parametrize("stride", [1, 4])
def test_records_match_program(genome, reads, stride):
    """Byte-identical BAM records to the program's sequential oracle
    through its Python writer (which the program's tests hold equal to
    its C++ emitter), and a control that differs."""
    from thermite_tpu_torch.align.driver import OracleAligner
    from thermite_tpu_torch.index.build import Index
    from thermite_tpu_torch.io.bam import encode_bam_record
    from thermite_tpu_torch.io.sam import (aln_to_sam_record, unique_refs,
                                           unmapped_sam_record)
    from thermite_tpu_torch.tools.workloads import bench_opts

    idx = Index.create_from_files(genome["fasta"], genome["gtf"])
    idx.build_seed_table(stride=stride)
    oracle = OracleAligner(idx, bench_opts())
    ids = {n: i for i, (n, _) in enumerate(unique_refs(idx))}

    def program(name, seq, qual):
        alns = oracle.align_read(seq)
        if not alns:
            return encode_bam_record(unmapped_sam_record(name, seq, qual), ids)
        return b"".join(encode_bam_record(aln_to_sam_record(
            idx, name, seq, qual, a, len(alns), i + 1), ids)
            for i, a in enumerate(alns))

    cfg = {"seed_stride": stride,
           "opts": {"min_seed_len": 20, "min_aln_score_percent": 0.0,
                    "min_aln_score": 30, "multimap_score_range": 1,
                    "intron_mode": True}}
    got = {i: program(*r) for i, r in enumerate(reads)}
    byk = dict(enumerate(reads))
    g = Genome.from_files(genome["fasta"], genome["gtf"])
    assert check.judge(got, byk, g, cfg)["mismatched_reads"] == 0
    ctl = check.judge(got, byk, g, cfg, make=check.control_reference)
    assert ctl["mismatched_reads"] > 0
    # the control left the reference's own genome as it was
    assert check.judge(got, byk, g, cfg)["mismatched_reads"] == 0


def test_control_readings_fail(tiny_root):
    from benchmark.control import control_readings

    for r in control_readings(tiny_root, "tiny.se90", 40, [1, 2, 3]):
        assert r["checked_reads"] > 0
        assert r["mismatched_reads"] > check.LIMIT_MISMATCHED
