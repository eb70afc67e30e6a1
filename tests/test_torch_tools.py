"""The port's measurement tools (``thermite_tpu_torch/tools/``) against
the reference's (``tools/``, ``data/make_reads.py``) on the CPU.

- ``golden_diff``: the same exit code and the same offending rows as the
  reference script on the golden chrM metrics table and perturbed copies.
- ``make_reads``: the reference script's FASTQ bytes.
- ``table_bench``: the same seed-table positions on the packed and the
  pair path, and as the reference's engine builds them.
- ``seed_bench``, ``build_split``, ``profile_pipeline`` and ``depth_ab``:
  their functions on a 200 kbp synthetic index with ``device="cpu"``.
- The static import check of ``test_torch_standalone.py`` covers every
  new tool and fails on a tool that imports the reference.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_standalone as standalone
from thermite_tpu.seed.native import NativeSmemEngine as RefSmemEngine
from thermite_tpu_torch.align.batch import BatchAligner
from thermite_tpu_torch.index.build import Index
from thermite_tpu_torch.testing.synth import write_synth_genome
from thermite_tpu_torch.tools import (build_split, depth_ab, golden_diff,
                                      make_reads, profile_pipeline,
                                      seed_bench, table_bench)
from thermite_tpu_torch.tools.workloads import first_chrom
from thermite_tpu_torch.tools.workloads import make_reads as workload_reads

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "data", "golden_chrM_metrics.md")
NEW_TOOLS = ("workloads", "make_reads", "fuzz_parity", "profile_pipeline",
             "build_split", "seed_bench", "table_bench", "depth_ab",
             "golden_diff")


def _run(argv, stdin=None):
    p = subprocess.run([sys.executable] + argv, input=stdin, cwd=ROOT,
                       capture_output=True, text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=ROOT))
    return p.returncode, p.stdout, p.stderr


def _perturbed():
    with open(GOLDEN) as f:
        lines = f.read().splitlines(keepends=True)
    row = lines[2]  # |file1 identical alignment to ref | 0.998|
    name = row.split("|")[1]
    return {
        "same": lines,
        "within tol": [row.replace("0.998", "0.994")] + lines[:2] + lines[3:],
        "past tol": lines[:2] + [row.replace("0.998", "0.990")] + lines[3:],
        "missing row": lines[:2] + lines[3:],
        "unexpected row": lines + ["|new metric | 0.5|\n"],
        "text value": lines[:2] + [f"|{name}| n/a|\n"] + lines[3:],
    }


@pytest.mark.parametrize("case", list(_perturbed()))
@pytest.mark.parametrize("tol", [None, "0.02"])
def test_golden_diff_matches_reference(case, tol):
    table = "".join(_perturbed()[case])
    extra = ["--tol", tol] if tol else []
    want = _run(["tools/golden_diff.py", GOLDEN] + extra, table)
    got = _run(["-m", "thermite_tpu_torch.tools.golden_diff", GOLDEN] + extra,
               table)
    assert got == want
    assert want[0] == (0 if case in ("same", "within tol")
                       or (case == "past tol" and tol) else 1)


def test_golden_compare_names_the_rows():
    want = golden_diff.parse_table(open(GOLDEN))
    got = dict(want, extra=1.0)
    got["file1 unaligned reads"] = 0.5
    del got["file2 unaligned reads"]
    bad = golden_diff.compare(want, got, 0.005)
    assert len(bad) == 3 and "missing row: 'file2 unaligned reads'" in bad


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    fasta, gtf = write_synth_genome(str(tmp_path_factory.mktemp("tools")),
                                    200_000, seed=5)
    return fasta, gtf, Index.create_from_files(fasta, gtf)


@pytest.mark.parametrize("seed", [None, "11"])
def test_make_reads_writes_the_reference_fastq(genome, tmp_path, seed):
    fasta = genome[0]
    extra = [seed] if seed else []
    ref_out, port_out = str(tmp_path / "ref.fq"), str(tmp_path / "port.fq")
    assert _run(["data/make_reads.py", fasta, "300", ref_out] + extra)[0] == 0
    assert make_reads.main([fasta, "300", port_out] + extra) == 0
    with open(ref_out, "rb") as a, open(port_out, "rb") as b:
        want, got = a.read(), b.read()
    assert got == want and want.count(b"\n") == 1200


@pytest.mark.parametrize("stride", [1, 4])
def test_table_positions_equal_on_both_paths_and_the_reference(stride):
    arr = table_bench.random_text(1_000_000)
    packed, _ = table_bench.build_table(arr, 20, stride)
    pair, _ = table_bench.build_table(arr, 20, stride, pair=True)
    assert "THERMITE_TABLE_PAIR" not in os.environ
    ref = RefSmemEngine(arr, 20, stride=stride)
    tables = [e.export_table() for e in (packed, pair, ref)]
    for t in tables[1:]:
        assert t[0] == tables[0][0]
        for a, b in zip(t[1:], tables[0][1:]):
            np.testing.assert_array_equal(a, b)
    assert len(tables[0][3]) == (len(arr) - 20 + stride) // stride


def test_table_bench_reports_its_path():
    for pair in (False, True):
        res = table_bench.table_bench(0.2, 4, 20, pair)
        assert res["path"] == ("pair" if pair else "packed")
        assert res["positions"] == (200_000 - 20 + 4) // 4
        assert res["build_s"] > 0 and res["ns_per_pos"] > 0


def test_seed_bench(genome):
    index = genome[2]
    reads = workload_reads(first_chrom(index), 400, seed=42)
    res = seed_bench.seed_bench(index, reads, passes=2)
    assert len(res["passes"]) == 2
    assert all(us > 0 and rps > 0 for us, rps in res["passes"])
    assert res["mems_per_read"] >= 1


def test_build_split(genome):
    index = genome[2]
    reads = workload_reads(first_chrom(index), 600, seed=77)
    res = build_split.build_split(index, reads, device="cpu", trials=2)
    assert res["reads"] == 600 and res["mems"] >= 600
    assert res["problems"] >= 600
    assert res["seed_us_per_read"] > 0 and res["build_us_per_read"] > 0


def test_profile_pipeline(genome):
    index = genome[2]
    chrom = first_chrom(index)
    res = profile_pipeline.profile_pipeline(
        index, workload_reads(chrom, 300, seed=7),
        workload_reads(chrom, 300, seed=8), device="cpu", emit=True,
        sort="cumulative", top=15, emit_top=10)
    for name, top in (("align_batch", 15), ("align_batch_emit", 10)):
        part = res[name]
        assert part["reads_s"] > 0 and "pipeline stats" in part["report"]
        assert len(part["top"]) == top
        cum = [r["cumtime"] for r in part["top"]]
        assert cum == sorted(cum, reverse=True)
    assert any("align_batch" in r["function"] for r in res["align_batch"]["top"])


def test_depth_ab(genome):
    index = genome[2]
    chrom = first_chrom(index)
    res = depth_ab.depth_ab(index, workload_reads(chrom, 200, seed=5),
                            [workload_reads(chrom, 200, seed=30 + t)
                             for t in range(2)], device="cpu",
                            budgets=(None, 256))
    assert list(res) == [BatchAligner.PROBLEM_BUDGET, 256]
    for by_depth in res.values():
        assert list(by_depth) == [2, 1]
        for r in by_depth.values():
            assert len(r["rates"]) == 2 and r["lo"] <= r["median"] <= r["hi"]


def test_chrm_tools_name_the_missing_fasta(monkeypatch, tmp_path, capsys):
    from thermite_tpu_torch.tools import fuzz_parity, workloads

    missing = str(tmp_path / "chrM.fasta")
    monkeypatch.setattr(workloads, "CHRM_FASTA", missing)
    assert fuzz_parity.main(["10"]) == 2
    monkeypatch.delenv("PP_SYN", raising=False)
    assert profile_pipeline.main(["10"]) == 2
    assert capsys.readouterr().err.count(missing) == 2


def test_standalone_check_covers_the_tools(tmp_path):
    rel = {os.path.relpath(p, standalone.PORT) for p in standalone.SOURCES}
    for name in NEW_TOOLS:
        assert f"tools/{name}.py" in rel, name
    bad = tmp_path / "tool.py"
    bad.write_text("from thermite_tpu.align.batch import BatchAligner\n")
    with pytest.raises(AssertionError):
        standalone.test_source_imports_nothing_of_the_reference(str(bad))
