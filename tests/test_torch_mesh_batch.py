"""The port's batch pipeline under a device mesh
(``BatchAligner(mesh=...)``) gives the single-device results and the
reference's under its 8-device CPU mesh: narrowed, at full band, without
the C++ engine, the emitted SAM/BAM/PAF bytes, and paired.

Both sides run on the CPU from the same numpy-seeded inputs (the 50 kbp
genome and the 300 truth reads of tests/test_mesh_batch.py).  The port's
mesh of N is N entries of the CPU device, so the split of every launch's
rows, the per-device wrapper calls (the plain PyTorch versions on CPU
tensors), the per-device winners gather and the merge in input order all
run here.  The reference runs ``BatchAligner(backend="pallas",
interpret=True, mesh=make_mesh(8))``: its ``shard_map`` kernels in
interpret mode.  Tolerance 0: alignments, counters and record bytes."""

import pytest
import torch

from test_paired_emit import make_mixed_pairs
from thermite_tpu.align.batch import BatchAligner as RefBatchAligner
from thermite_tpu.parallel import mesh as ref_mesh
from thermite_tpu.testing.synth import make_truth_reads, write_synth_genome
from thermite_tpu_torch.align.batch import BatchAligner
from thermite_tpu_torch.ops.swg_forward import swg_forward
from thermite_tpu_torch.ops.swg_stream import swg_stream, swg_stream_wide
from thermite_tpu_torch.parallel import mesh as port_mesh
from thermite_tpu_torch.parallel.dryrun import dryrun_multichip
from torch_sides import align_opts, indexes, plain

torch.set_num_threads(1)

BUDGET = 256  # problems a chunk: the reads cross several chunks
BUDGETS = {"narrowed": BUDGET, "full_band": BUDGET, "no_native": 64}
MODES = {
    "narrowed": dict(narrow_band=15),
    "full_band": dict(narrow_band=0),
    "no_native": dict(narrow_band=15, use_native=False),
}
# reads a mode runs: the plain kernels are slow at band 60 and on the
# forward pass over every problem
N_READS = {"narrowed": 300, "full_band": 120, "no_native": 40}


# -- the pipeline under a mesh -----------------------------------------


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_mesh")
    fasta, gtf = write_synth_genome(str(d), 50_000, seed=3, basename="m")
    index = indexes(fasta, gtf)
    opts = align_opts(min_seed_len=20, min_aln_score_percent=0.0,
                      min_aln_score=30, intron_mode=True)
    reads = make_truth_reads(index.ref, 300, seed=8)
    recs = [(n.encode(), s, b"I" * len(s)) for n, s in reads]
    return index, opts, recs


def _port(small, mode, mesh=None, budget=None):
    index, opts, _ = small
    kw = dict(MODES[mode])
    narrow = kw.pop("narrow_band")
    a = BatchAligner(index.port, opts.port, device="cpu", mesh=mesh, **kw)
    a.PROBLEM_BUDGET, a.narrow_band = budget or BUDGETS[mode], narrow
    return a


@pytest.fixture(scope="module")
def singles(small):
    """Per mode, what the runs under a mesh are held against: the port's
    single-device alignments and counters, and the reference's
    alignments under its 8-device mesh."""
    out = {}
    for mode, kw in MODES.items():
        index, opts, recs = small
        reads = [r[1] for r in recs][: N_READS[mode]]
        port = _port(small, mode)
        got = port.align_batch(reads)
        kw = dict(kw)
        narrow = kw.pop("narrow_band")
        ref = RefBatchAligner(index.ref, opts.ref, backend="pallas",
                              interpret=True, mesh=ref_mesh.make_mesh(8), **kw)
        ref.PROBLEM_BUDGET, ref.narrow_band = BUDGETS[mode], narrow
        out[mode] = (reads, plain(got), port.stats, plain(ref.align_batch(reads)),
                     ref.stats)
    return out


@pytest.mark.parametrize("n_dev", [1, 3, 8])
@pytest.mark.parametrize("mode", sorted(MODES))
def test_batch_mesh_equals_single_and_reference(small, singles, mode, n_dev):
    reads, single, single_stats, ref, ref_stats = singles[mode]
    counts = (swg_stream.launches, swg_stream_wide.launches,
              swg_forward.launches)
    port = _port(small, mode, port_mesh.make_mesh(n_dev, "cpu"))
    got = plain(port.align_batch(reads))
    assert got == single
    assert got == ref
    assert sum(1 for a in got if a) > 0.9 * len(reads)
    s = port.stats
    for k in ("chunks", "reads", "problems", "tasks", "winners",
              "cert_patches", "stream_fallbacks", "dp_cells_ref"):
        assert getattr(s, k) == getattr(single_stats, k), k
        assert getattr(s, k) == getattr(ref_stats, k), k
    assert s.chunks > 1
    if 128 % n_dev == 0:  # the same padded rows as one device
        assert s.dp_cells == single_stats.dp_cells
    else:  # the bucket rounded up to the mesh size, summed over devices
        assert s.dp_cells > single_stats.dp_cells
    if mode == "full_band":
        assert s.cert_patches > 0
    # CPU tensors take the plain versions: no kernel launch is counted
    assert (swg_stream.launches, swg_stream_wide.launches,
            swg_forward.launches) == counts


def test_launch_rows_divide_by_the_mesh(small):
    """Every launch's rows are a multiple of the mesh size, padded as one
    launch before the split, so each device runs the same shape."""
    port = _port(small, "narrowed", port_mesh.make_mesh(3, "cpu"))
    assert port._nsh == 3 and port.device == torch.device("cpu")
    port.align_batch([r[1] for r in small[2]])
    assert port._NFWD1 % 3 == 0 and port._NFWD1 >= 128
    assert port._rows_bucket(1, 0) == 129 and port._rows_bucket(200, 0) == 258
    one = _port(small, "narrowed", port_mesh.make_mesh(1, "cpu"))
    none = _port(small, "narrowed")
    for n in (1, 128, 129, 5000):
        assert one._rows_bucket(n, 0) == none._rows_bucket(n, 0)
    # no mesh given: the mesh of the one device, on the same code
    assert none.mesh == one.mesh == (torch.device("cpu"),) and none._nsh == 1


@pytest.mark.parametrize("fmt_bam", [False, True, 2], ids=["sam", "bam", "paf"])
def test_mesh_emit_bytes_equal_single_and_reference(small, fmt_bam):
    index, opts, recs = small
    want = _port(small, "narrowed").align_batch_emit(recs, fmt_bam)
    got = _port(small, "narrowed", port_mesh.make_mesh(8, "cpu")
                ).align_batch_emit(recs, fmt_bam)
    assert got == want and len(got) > 0
    ref = RefBatchAligner(index.ref, opts.ref, backend="pallas", interpret=True,
                          mesh=ref_mesh.make_mesh(8))
    ref.PROBLEM_BUDGET = BUDGET
    assert ref.align_batch_emit(recs, fmt_bam) == got


@pytest.mark.parametrize("mode", ["narrowed", "full_band"])
def test_mesh_paired_bytes_equal_single_and_reference(small, mode):
    index, opts, _ = small
    pairs = [((r1.id, r1.seq, r1.qual), (r2.id, r2.seq, r2.qual))
             for r1, r2 in make_mixed_pairs(index.ref, n=40, seed=13)]
    want = _port(small, mode, budget=64).align_paired_emit(pairs, True)
    meshed = _port(small, mode, port_mesh.make_mesh(8, "cpu"), budget=64)
    got = meshed.align_paired_emit(pairs, True)
    assert got == want and len(got) > 0 and meshed.stats.chunks > 1
    ref = RefBatchAligner(index.ref, opts.ref, backend="pallas", interpret=True,
                          mesh=ref_mesh.make_mesh(8))
    ref.PROBLEM_BUDGET, ref.narrow_band = 64, MODES[mode]["narrow_band"]
    assert ref.align_paired_emit(pairs, True) == got


def test_mesh_names_the_devices(small):
    """``mesh`` decides where the run goes (``device`` is not read), and
    a CUDA mesh without a card raises as every entry point does."""
    index, opts, _ = small
    a = BatchAligner(index.port, opts.port, mesh=port_mesh.make_mesh(2, "cpu"))
    assert a.device.type == "cpu" and a.mesh == (torch.device("cpu"),) * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            BatchAligner(index.port, opts.port, mesh=("cuda:0", "cuda:0"))


def test_dryrun_multichip_passes():
    dryrun_multichip(8)
    dryrun_multichip(1)
