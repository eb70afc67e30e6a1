"""The port's CPU paths run with JAX blocked.

A subprocess installs a meta-path finder that refuses every ``jax`` and
``jaxlib`` import, then runs the port's CLI: index from FASTA/GTF, save,
load, and ``align --device cpu`` to SAM, ``--paired`` (the reads as both
mates) and ``--engine cpp``; two host shards joined by ``merge``; the
full-band path (``THERMITE_NARROW_BAND=0``), the path without the C++
engine (``use_native=False``) and the embedding wrapper on the loaded
index, whose SAM records must equal the main path's.  No jax module may
load, and the CLI's SAM bytes (single-end, paired, cpp) must equal the
reference CLI's in this (JAX) process."""

import os
import subprocess
import sys

from fixtures import write_fixture
from thermite_tpu.cli import main as ref_main

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = r"""
import importlib.abc, sys

class _BlockJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib"):
            raise ModuleNotFoundError(f"blocked import of {name}")
        return None

sys.meta_path.insert(0, _BlockJax())
from thermite_tpu_torch.cli import main

ref, gtf, fq, idx, out = sys.argv[1:6]
flags = ["-a", "-k", "3", "--min-aln-score", "0", "--intron-mode"]
assert main(["index", ref, gtf, "-o", idx]) == 0
assert main(["align", idx, fq, "-o", out, *flags, "--device", "cpu"]) == 0
assert main(["align", idx, fq, fq, "--paired", "-o", out + ".paired.sam",
             *flags, "--device", "cpu"]) == 0
assert main(["align", idx, fq, "-o", out + ".cpp.sam", *flags,
             "--engine", "cpp"]) == 0
for h in ("0", "1"):
    assert main(["align", idx, fq, "-o", out + ".sharded", *flags,
                 "--device", "cpu", "--num-hosts", "2", "--host-id", h]) == 0
assert main(["merge", "-o", out + ".merged.sam", out + ".sharded.shard000",
             out + ".sharded.shard001"]) == 0
with open(out, "rb") as a, open(out + ".merged.sam", "rb") as b:
    assert a.read() == b.read()

import os
from thermite_tpu.align.driver import AlignOpts
from thermite_tpu.index.build import Index
from thermite_tpu.io.fastx import parse_fastx
from thermite_tpu_torch.align.batch import BatchAligner

index = Index.load(idx)
opts = AlignOpts(min_seed_len=3, min_aln_score=0, intron_mode=True)
recs = [(r.id, r.seq, r.qual) for r in parse_fastx(fq)]
main_sam = BatchAligner(index, opts, device="cpu").align_batch_emit(recs, False)
os.environ["THERMITE_NARROW_BAND"] = "0"
full = BatchAligner(index, opts, device="cpu")
assert full.narrow_band == 0
assert full.align_batch_emit(recs, False) == main_sam
no_native = BatchAligner(index, opts, device="cpu", use_native=False)
assert no_native.align_batch_emit(recs, False) == main_sam
assert main_sam.count(b"\tAS:i:") > 0

from thermite_tpu_torch.wrapper import ThermiteAligner

w = ThermiteAligner(idx, device="cpu")
w.set_opts(opts)
names, seqs, quals = ([r[k] for r in recs] for k in range(3))
assert w.align_reads_records(names, seqs, quals).count(b"\n") >= len(recs)
assert w.align_read_pairs_records(names, seqs, quals, seqs, quals).count(
    b"\n") >= 2 * len(recs)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib"))
assert not loaded, loaded
print("NOJAX-OK")
"""


def test_port_cli_runs_without_jax(tmp_path):
    ref, gtf, fq = write_fixture(tmp_path)
    port_idx, port_sam = str(tmp_path / "p.tai.npz"), str(tmp_path / "p.sam")
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-c", CHILD, ref, gtf, fq, port_idx, port_sam],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT,
    )
    assert r.returncode == 0 and "NOJAX-OK" in r.stdout, r.stderr[-3000:]

    ref_idx, ref_sam = str(tmp_path / "r.tai.npz"), str(tmp_path / "r.sam")
    flags = ["-a", "-k", "3", "--min-aln-score", "0", "--intron-mode"]
    assert ref_main(["index", ref, gtf, "-o", ref_idx]) == 0
    assert ref_main(["align", ref_idx, fq, "-o", ref_sam, *flags]) == 0
    assert ref_main(["align", ref_idx, fq, fq, "--paired", "-o",
                     ref_sam + ".paired.sam", *flags]) == 0
    assert ref_main(["align", ref_idx, fq, "-o", ref_sam + ".cpp.sam",
                     *flags, "--engine", "cpp"]) == 0
    for suffix in ("", ".paired.sam", ".cpp.sam"):
        with open(port_sam + suffix, "rb") as a, open(ref_sam + suffix, "rb") as b:
            got, want = a.read(), b.read()
        assert got == want and b"\tAS:i:" in got, suffix
