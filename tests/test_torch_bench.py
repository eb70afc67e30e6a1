"""The port's bench (``thermite_tpu_torch/bench.py``) against the
repository's ``bench.py`` on the CPU; every comparison exact.

- The line ``main(["--device", "cpu", ...])`` prints last has exactly the
  keys of the dict literal that the reference's ``main()`` passes to its
  last ``json.dumps`` (read from its source with ``ast``, not run), on a
  200 kbp synthetic index standing in for syn45; the chrM keys are
  ``null`` without the chrM FASTA and measured with one.
- The counters behind the two GCUPS (``dp_cells``, ``dp_cells_ref``) after
  one ``align_batch`` equal the reference pipeline's.
- The emit and paired timers hand the aligner the records and pairs the
  reference's timers hand it, call for call, and get the reference's
  bytes.
- Without a card and without ``--device cpu`` the bench prints the outage
  line and exits 3; past ``BENCH_DEADLINE_S`` it prints the partial line
  and exits 4; unmappable reads make the steady-state timer raise.
"""

import ast
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import test_torch_standalone as standalone
from thermite_tpu.align.batch import BatchAligner as RefBatchAligner
from thermite_tpu_torch import bench
from thermite_tpu_torch.align.batch import BatchAligner
from thermite_tpu_torch.testing.synth import write_synth_genome
from thermite_tpu_torch.tools import workloads
from torch_sides import align_opts, indexes, plain

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--device", "cpu", "--reads", "512", "--trials", "2"]


def _load(rel, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference_main():
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    return next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")


def _calls(tree, func: str):
    return [n for n in ast.walk(tree) if isinstance(n, ast.Call)
            and ast.unparse(n.func) == func]


def reference_line_keys():
    """Keys of the dict literal in the last ``json.dumps`` of the
    reference bench's ``main()``, read from its source."""
    last = max(_calls(_reference_main(), "json.dumps"), key=lambda n: n.lineno)
    assert isinstance(last.args[0], ast.Dict)
    return [k.value for k in last.args[0].keys]


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """A 200 kbp synthetic genome: its files, each side's index, and the
    port's index saved as an artifact."""
    tmp = tmp_path_factory.mktemp("bench")
    fasta, gtf = write_synth_genome(str(tmp), 200_000, seed=5)
    index = indexes(fasta, gtf)
    art = str(tmp / "small.tai.npz")
    index.port.save(art)
    return fasta, gtf, index, art


def _small_main(monkeypatch, capsys, genome, with_chrm):
    fasta, gtf, index, _ = genome
    monkeypatch.setattr(workloads, "syn45_index", lambda: index.port)
    if with_chrm:  # the small genome stands in for chrM
        monkeypatch.setattr(workloads, "CHRM_FASTA", fasta)
        monkeypatch.setattr(workloads, "CHRM_GTF", gtf)
    else:
        monkeypatch.setattr(workloads, "CHRM_FASTA",
                            os.path.join(ROOT, "no-such-dir", "chrM.fasta"))
    assert bench.main(SMALL) == 0
    out, err = capsys.readouterr()
    return json.loads(out.strip().splitlines()[-1]), err


@pytest.mark.parametrize("with_chrm", [False, True])
def test_line_has_the_reference_keys(monkeypatch, capsys, genome, with_chrm):
    want = reference_line_keys()
    assert len(want) == 21
    assert list(bench.SYN45_KEYS + bench.CHRM_KEYS) == want
    line, err = _small_main(monkeypatch, capsys, genome, with_chrm)
    assert list(line) == want
    assert line["metric"] == "e2e_align_reads_per_s_syn45Mbp_90bp"
    assert line["trials"] == 2 and line["unit"] == "reads/s"
    for key in want:
        if key.startswith("syn45_") or key in ("value", "vs_baseline",
                                               "vs_cpp_baseline"):
            assert np.all(np.asarray(line[key]) > 0), key
    lo, hi = line["syn45_spread_reads_per_s"]
    assert lo <= line["value"] <= hi
    assert "pipeline stats:" in err
    if with_chrm:
        assert all(line[k] is not None for k in bench.CHRM_KEYS)
    else:
        assert all(line[k] is None for k in bench.CHRM_KEYS)
        assert os.path.join("no-such-dir", "chrM.fasta") in err


def test_bench_opts_are_the_reference_benchs():
    """Both ``AlignOpts`` of the reference bench's ``main()`` (-s0 and
    -s0.66), read from its source."""
    calls = _calls(_reference_main(), "AlignOpts")
    assert len(calls) == 2
    for call in calls:
        kw = {k.arg: ast.literal_eval(k.value) for k in call.keywords}
        got = workloads.bench_opts(kw["min_aln_score_percent"])
        assert plain(got) == plain(align_opts(**kw).ref)


def _pair(index):
    opts = align_opts(min_seed_len=20, min_aln_score_percent=0.0,
                      min_aln_score=30, intron_mode=True)
    return (RefBatchAligner(index.ref, opts.ref, backend="pallas",
                            interpret=True, use_native=True),
            BatchAligner(index.port, workloads.bench_opts(), device="cpu"))


def test_gcups_counters_equal_the_reference(genome):
    index = genome[2]
    reads = workloads.make_reads(workloads.first_chrom(index.port), 256,
                                 seed=20)
    ref, port = _pair(index)
    for a in (ref, port):
        a.stats.reset()
        a.align_batch(reads)
    assert port.stats.chunks == ref.stats.chunks == 1
    assert port.stats.dp_cells_ref == ref.stats.dp_cells_ref > 0
    assert port.stats.dp_cells == ref.stats.dp_cells > 0


class Recorder:
    """An aligner whose emit calls are recorded: (method, inputs, bytes).
    Calls with inputs seen before return the bytes computed then."""

    def __init__(self, inner):
        self.inner, self.calls, self._memo = inner, [], {}
        self.device = getattr(inner, "device", None)

    def __getattr__(self, name):  # can_emit() and the rest
        return getattr(self.inner, name)

    def _call(self, method, items, fmt_bam):
        key = (method, tuple(items), fmt_bam)
        if key not in self._memo:
            self._memo[key] = getattr(self.inner, method)(items, fmt_bam)
        self.calls.append((method, list(items), fmt_bam, self._memo[key]))
        return self._memo[key]

    def align_batch_emit(self, recs, fmt_bam):
        return self._call("align_batch_emit", recs, fmt_bam)

    def align_paired_emit(self, pairs, fmt_bam):
        return self._call("align_paired_emit", pairs, fmt_bam)


def test_timers_align_the_reference_inputs_to_its_bytes(genome):
    index = genome[2]
    ref_bench = _load("bench.py", "ref_bench")
    chrom = workloads.first_chrom(index.port)
    reads = workloads.make_reads(chrom, 300, seed=33)
    ref, port = (Recorder(a) for a in _pair(index))
    assert ref_bench._emit_rps(ref, reads) > 0
    assert ref_bench._paired_rps(ref, chrom, 150) > 0
    assert bench.emit_rps(port, reads) > 0
    assert bench.paired_rps(port, chrom, 150) > 0
    assert len(port.calls) == len(ref.calls) == 8
    for got, want in zip(port.calls, ref.calls):
        assert got[:3] == want[:3]
        assert got[3] == want[3] and len(got[3]) > 0


def _run(argv, env):
    p = subprocess.run([sys.executable] + argv, cwd=ROOT, capture_output=True,
                       text=True, timeout=300,
                       env=dict(os.environ, PYTHONPATH=ROOT, **env))
    return p.returncode, p.stdout, p.stderr


def test_no_card_is_an_outage_not_a_cpu_run():
    rc, out, err = _run(["-m", "thermite_tpu_torch.bench"],
                        {"CUDA_VISIBLE_DEVICES": ""})
    assert rc == 3, err
    line = json.loads(out.strip().splitlines()[-1])
    assert line["value"] == 0 and line["backend_outage"] is True
    assert line["metric"] == "e2e_align_reads_per_s_syn45Mbp_90bp"
    assert "is_available() is False" in line["error"]
    assert "syn45 index" not in err and "pipeline stats" not in err


def test_deadline_prints_the_partial_line(genome):
    script = (
        "import sys\n"
        "from thermite_tpu_torch import bench\n"
        "from thermite_tpu_torch.index.build import Index\n"
        "from thermite_tpu_torch.tools import workloads\n"
        "workloads.syn45_index = lambda: Index.load(sys.argv[1])\n"
        f"sys.exit(bench.main({SMALL!r}))\n"
    )
    rc, out, err = _run(["-c", script, genome[3]], {"BENCH_DEADLINE_S": "1"})
    assert rc == 4, err
    line = json.loads(out.strip().splitlines()[-1])
    assert "deadline 1s exceeded" in line["error"]
    assert line["backend_outage"] is True
    assert line["value"] == line.get("syn45_median", 0)


def test_unmappable_reads_fail_the_steady_state_timer(genome):
    port = BatchAligner(genome[2].port, workloads.bench_opts(), device="cpu")
    rng = np.random.default_rng(7)

    def junk(t):
        return [bytes(rng.choice(list(b"ACGT"), 90).astype(np.uint8))
                for _ in range(200)]

    with pytest.raises(AssertionError, match="mapping rate"):
        bench.steady_state(port, junk, 2)


def test_standalone_check_covers_the_bench():
    rel = {os.path.relpath(p, standalone.PORT) for p in standalone.SOURCES}
    assert "bench.py" in rel
