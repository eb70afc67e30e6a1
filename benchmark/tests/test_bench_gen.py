"""The generators: the genome is the program's synthetic genome, byte for
byte, and its sidecar's offsets point at each chromosome; reads are the
same for a seed and batch, and differ from batch to batch and seed to
seed."""

import json
import os

import numpy as np
import pytest

from benchmark.gen import synth_genome, windows
from conftest import REPO, TINY_CFG


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    return synth_genome.ensure(str(tmp_path_factory.mktemp("g")), TINY_CFG)


def _traffic(n=256):
    tr = json.load(open(os.path.join(REPO, "benchmark", "traffic", "se90.json")))
    tr["batch_reads"] = n
    return tr


def test_genome_is_the_programs(genome, tmp_path):
    from thermite_tpu_torch.testing.synth import write_synth_genome

    fa, gtf = write_synth_genome(str(tmp_path), TINY_CFG["total_bp"],
                                 seed=TINY_CFG["genome_seed"],
                                 n_chroms=TINY_CFG["n_chroms"],
                                 basename=TINY_CFG["name"])
    assert open(fa, "rb").read() == open(genome["fasta"], "rb").read()
    assert open(gtf, "rb").read() == open(genome["gtf"], "rb").read()
    data = open(genome["fasta"], "rb").read()
    for c in genome["chroms"]:
        seq = data[c["offset"] : c["offset"] + c["len"]]
        assert set(seq) <= set(b"ACGT") and data[c["offset"] + c["len"]] == 10
        assert data[: c["offset"]].endswith(f">{c['name']}\n".encode())


def test_genome_is_reused(genome):
    again = synth_genome.ensure(os.path.dirname(genome["fasta"]), TINY_CFG)
    assert again == genome


def test_reads_deterministic_and_distinct(genome):
    tr = _traffic()
    a = windows.make_batch(genome, tr, 2**33 + 5, 0, 4)
    assert a == windows.make_batch(genome, tr, 2**33 + 5, 0, 4)
    for other in (windows.make_batch(genome, tr, 2**33 + 5, 0, 5),
                  windows.make_batch(genome, tr, 2**33 + 5, 1, 4),
                  windows.make_batch(genome, tr, 2**33 + 6, 0, 4)):
        assert len({r[1] for r in a} & {r[1] for r in other}) < 3
    names = [r[0] for r in a]
    assert len(set(names)) == len(names) == tr["batch_reads"]
    assert all(len(r[1]) == len(r[2]) == tr["read_len"] for r in a)
    assert all(r[2] == tr["quality_char"].encode() * tr["read_len"] for r in a)
    assert names[:2] == [b"r0", b"r1"]


def test_reads_are_windows_with_substitutions(genome):
    from thermite_tpu_torch.io.fastx import revcomp

    tr = _traffic(400)
    data = open(genome["fasta"], "rb").read()
    chroms = [data[c["offset"] : c["offset"] + c["len"]] for c in genome["chroms"]]
    subs = []
    strands = []
    for _, seq, _ in windows.make_batch(genome, tr, 77, 0, 0):
        best = None
        for s, fwd in ((0, seq), (1, revcomp(seq))):
            for ch in chroms:
                # a 20-mer of it matches exactly: 3 substitutions touch
                # at most 6 of these 8 windows
                for k in range(0, 71, 10):
                    p = ch.find(fwd[k : k + 20])
                    if p >= k:
                        d = sum(x != y for x, y in zip(fwd, ch[p - k : p - k + 90]))
                        best = min(best or (99, s), (d, s))
        assert best is not None and best[0] <= 3
        subs.append(best[0])
        strands.append(best[1])
    assert 0.35 < np.mean(strands) < 0.65
    assert set(subs) == {0, 1, 2, 3}
