"""The port stands alone: it imports nothing of ``thermite_tpu`` and no
``jax``.

A static check reads every source of ``thermite_tpu_torch/`` and
``chip_smoke.py`` for such an import (and for any patching of
``sys.modules``).  A dynamic check runs the port in a subprocess with
``sys.modules["thermite_tpu"] = None`` and ``sys.modules["jax"] = None``
(an import of either raises ImportError): ``index``, ``align`` with the
batch engine on ``--device cpu`` (also under ``--mesh 2 --profile``),
the cpp and oracle engines, ``--paired``, two shards and ``merge``, the
embedding wrapper, the mesh dry run, the metrics module and the
genome-scale tool (``tools/genome_scale.py``, which reaches
``tools/thread_tax.py``) at a small size.  Its
files must equal, byte for byte, those the reference CLI and wrapper
write in another subprocess; the C++ engine's library must come from the
port's own ``_build/`` directory."""

import ast
import glob
import os
import subprocess
import sys

import pytest

from thermite_tpu.testing.synth import make_truth_reads, write_fastq, write_synth_genome
from thermite_tpu.index.build import Index

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "thermite_tpu_torch")
SOURCES = sorted(glob.glob(os.path.join(PORT, "**", "*.py"), recursive=True)
                 ) + [os.path.join(ROOT, "chip_smoke.py")]
BLOCKED = ("thermite_tpu", "jax", "jaxlib")


def _imports(tree):
    """Top-level names of every absolute import in ``tree``."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0], node.lineno


@pytest.mark.parametrize("path", SOURCES,
                         ids=[os.path.relpath(p, ROOT) for p in SOURCES])
def test_source_imports_nothing_of_the_reference(path):
    with open(path) as f:
        src = f.read()
    tree = ast.parse(src)
    bad = [(name, line) for name, line in _imports(tree) if name in BLOCKED]
    assert not bad, bad
    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and ast.unparse(node.func).endswith(
                ("import_module", "__import__")):
            for arg in node.args:
                if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                    assert arg.value.split(".")[0] not in BLOCKED, \
                        f"{path}:{node.lineno} imports {arg.value}"
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.Delete)):
            targets = [node.target] if isinstance(node, ast.AugAssign) \
                else node.targets
            for t in targets:
                assert "sys.modules" not in ast.unparse(t), \
                    f"{path}:{node.lineno} patches sys.modules"


def test_port_sources_are_found():
    rel = {os.path.relpath(p, PORT) for p in SOURCES[:-1]}
    for must in ("cli.py", "wrapper.py", "constants.py", "align/batch.py",
                 "align/driver.py", "align/native_batch.py", "index/build.py",
                 "io/bam.py", "seed/native.py", "ops/swg_ref.py",
                 "parallel/multihost.py", "testing/synth.py",
                 "parallel/mesh.py", "parallel/dryrun.py",
                 "testing/alignment_metrics.py", "utils/profile.py",
                 "tools/genome_scale.py", "tools/thread_tax.py"):
        assert must in rel, must
    for src in ("thermite_native.cpp", "thermite_objbuild.c"):
        assert os.path.exists(os.path.join(PORT, "csrc", "host", src))


# The same script drives either package: PKG is the package's name, and
# the port side first blocks the reference package and JAX.
CHILD = r"""
import os, sys
pkg, out, idx_src, fasta, gtf, fq, fq1, fq2 = sys.argv[1:9]
port = pkg == "thermite_tpu_torch"
if port:
    sys.modules["thermite_tpu"] = None
    sys.modules["jax"] = None
import importlib
main = importlib.import_module(pkg + ".cli").main
dev = ["--device", "cpu"] if port else []
flags = ["-a", "-k", "20", "-s", "0", "--intron-mode"]
idx = os.path.join(out, "x.tai.npz")
assert main(["index", fasta, gtf, "-o", idx]) == 0
def o(name):
    return os.path.join(out, name)
assert main(["align", idx, fq, "-o", o("batch.sam"), *flags, *dev]) == 0
assert main(["align", idx, fq, "-o", o("batch.bam"), *flags, *dev]) == 0
assert main(["align", idx, fq, "-o", o("batch.paf"), "-k", "20", "-s", "0",
             "--intron-mode", *dev]) == 0
assert main(["align", idx, fq, "-o", o("cpp.sam"), *flags, "--engine", "cpp"]) == 0
assert main(["align", idx, fq, "-o", o("oracle.sam"), *flags,
             "--engine", "oracle"]) == 0
assert main(["align", idx, fq1, fq2, "--paired", "-o", o("paired.sam"),
             *flags, *dev]) == 0
for h in ("0", "1"):
    assert main(["align", idx, fq, "-o", o("sharded.sam"), *flags, *dev,
                 "--num-hosts", "2", "--host-id", h]) == 0
assert main(["merge", "-o", o("merged.sam"), o("sharded.sam.shard000"),
             o("sharded.sam.shard001")]) == 0
# the other package's artifact loads too
assert main(["align", idx_src, fq, "-o", o("batch_other_idx.sam"), *flags,
             *dev]) == 0

wrapper = importlib.import_module(pkg + ".wrapper")
AlignOpts = importlib.import_module(pkg + ".align.driver").AlignOpts
parse_fastx = importlib.import_module(pkg + ".io.fastx").parse_fastx
w = wrapper.ThermiteAligner(idx, device="cpu") if port \
    else wrapper.ThermiteAligner(idx)
w.set_opts(AlignOpts(min_seed_len=20, min_aln_score_percent=0.0,
                     min_aln_score=30, intron_mode=True))
recs = list(parse_fastx(fq))[:40]
m1, m2 = list(parse_fastx(fq1))[:12], list(parse_fastx(fq2))[:12]
names, seqs, quals = ([getattr(r, k) for r in recs] for k in ("id", "seq", "qual"))
with open(o("wrapper.bin"), "wb") as f:
    f.write(w.header().encode())
    f.write(w.align_reads_records(names, seqs, quals))
    f.write(w.align_reads_records(names, seqs, quals, fmt_bam=True))
    f.write(w.align_read_pairs_records(
        [r.id for r in m1], [r.seq for r in m1], [r.qual for r in m1],
        [r.seq for r in m2], [r.qual for r in m2]))
    for r in recs[:5]:
        for rec in w.align_read(r.id, r.seq, r.qual):
            f.write(rec.to_line().encode() + b"\n")
    for a, b in zip(m1[:4], m2[:4]):
        for rec in w.align_read_pair(a.id, a.seq, a.qual, b.seq, b.qual):
            f.write(rec.to_line().encode() + b"\n")
if port:
    # the mesh, the profiler and the metrics module need neither name
    assert main(["align", idx, fq, "-o", o("mesh.sam"), *flags, *dev,
                 "--mesh", "2", "--profile", o("trace"), "-v"]) == 0
    with open(o("mesh.sam"), "rb") as a, open(o("batch.sam"), "rb") as b:
        assert a.read() == b.read()
    assert len(os.listdir(o("trace"))) == 1
    importlib.import_module(pkg + ".parallel.dryrun").dryrun_multichip(2)
    metrics = importlib.import_module(pkg + ".testing.alignment_metrics")
    assert metrics.compare(o("batch.bam"), o("batch.bam")).n_reads == 160
    # the genome-scale tool and its thread accounting, at a small size
    gs = importlib.import_module(pkg + ".tools.genome_scale")
    r = gs.run_genome_scale(300_000, 32, 4, o("genome"), device="cpu",
                            n_warm=8, n_spot=8, log=lambda msg: None)
    assert r["oracle_spot_mismatches"] == 0 and r["bam_threads"]
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("thermite_tpu", "jax", "jaxlib")
                    and sys.modules[m] is not None)
    assert not loaded, loaded
    native = importlib.import_module(pkg + ".seed.native")
    build = importlib.import_module(pkg + ".ops._build")
    assert os.path.dirname(build.native_engine()) == build.BUILD_DIR
    assert native._lib._name == build.native_engine()
print("STANDALONE-OK")
"""

OUTPUTS = ("x.tai.npz", "batch.sam", "batch.bam", "batch.paf", "cpp.sam",
           "oracle.sam", "paired.sam", "sharded.sam.shard000",
           "sharded.sam.shard001", "merged.sam", "batch_other_idx.sam",
           "wrapper.bin")


def _read(path):
    import gzip

    if path.endswith(".npz"):  # zip members carry timestamps: compare arrays
        import numpy as np

        with np.load(path, allow_pickle=False) as z:
            return sorted((k, str(z[k].dtype), z[k].shape, z[k].tobytes())
                          for k in z.files)
    with (gzip.open(path, "rb") if path.endswith(".bam")
          else open(path, "rb")) as f:
        return f.read()


def test_port_alone_gives_the_reference_cli_bytes(tmp_path):
    d = str(tmp_path)
    fasta, gtf = write_synth_genome(d, 60_000, seed=43, basename="sa")
    index = Index.create_from_files(fasta, gtf)
    index.build_seed_table(stride=1)
    idx_src = os.path.join(d, "src.tai.npz")  # a reference-saved artifact
    index.save(idx_src)
    reads = make_truth_reads(index, 160, seed=4)
    fq, fq1, fq2 = (os.path.join(d, n) for n in ("r.fq", "r1.fq", "r2.fq"))
    write_fastq(reads, fq)
    write_fastq(reads[:60], fq1)
    write_fastq([(n, s) for (n, _), (_, s) in zip(reads[:60], reads[60:120])],
                fq2)
    env = dict(os.environ, OMP_NUM_THREADS="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = {}
    for pkg in ("thermite_tpu", "thermite_tpu_torch"):
        outs[pkg] = os.path.join(d, "out_" + pkg)
        os.makedirs(outs[pkg])
        r = subprocess.run(
            [sys.executable, "-c", CHILD, pkg, outs[pkg], idx_src, fasta, gtf,
             fq, fq1, fq2],
            capture_output=True, text=True, timeout=600, env=env, cwd=ROOT,
        )
        assert r.returncode == 0 and "STANDALONE-OK" in r.stdout, \
            (pkg, r.stderr[-3000:])
    for name in OUTPUTS:
        want = _read(os.path.join(outs["thermite_tpu"], name))
        got = _read(os.path.join(outs["thermite_tpu_torch"], name))
        assert got == want and len(got) > 0, name
    sam = _read(os.path.join(outs["thermite_tpu_torch"], "batch.sam"))
    assert sam.count(b"\tAS:i:") > 140
    assert sam == _read(os.path.join(outs["thermite_tpu_torch"], "merged.sam"))
