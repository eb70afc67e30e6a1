"""The port's BatchAligner (device="cpu": the plain PyTorch kernel path)
equals the reference pipeline BatchAligner(backend="pallas",
interpret=True): align_batch results field by field (the
port's result classes are its own), and the SAM and BAM bytes of
align_batch_emit.  Each side runs on its own package's Index and
AlignOpts, built from the same files and arguments.  Both run with PROBLEM_BUDGET = 256, so batches cross
several chunks of the pipeline."""

import numpy as np
import pytest
import torch

from fixtures import READS, write_fixture
from thermite_tpu.align.batch import BatchAligner as RefBatchAligner
from thermite_tpu.testing.synth import make_truth_reads, write_synth_genome
from torch_sides import align_opts, indexes, plain
from thermite_tpu_torch.align.batch import BatchAligner
from thermite_tpu_torch.ops.swg_stream import swg_stream

# The suite runs several xdist workers on a few cores; the plain path's
# small tensor ops gain nothing from intra-op threads and lose much to
# oversubscription.
torch.set_num_threads(1)

BUDGET = 256


@pytest.fixture(scope="module")
def fixture_case(tmp_path_factory):
    ref, gtf, _ = write_fixture(tmp_path_factory.mktemp("tb_fix"))
    index = indexes(ref, gtf)
    opts = align_opts(min_seed_len=3, min_aln_score=0, intron_mode=True)
    recs = [(n.encode(), s.encode(), b"9" * len(s)) for n, s in READS] * 30
    return index, opts, recs


@pytest.fixture(scope="module")
def synth_case(tmp_path_factory):
    fasta, gtf = write_synth_genome(
        str(tmp_path_factory.mktemp("tb_syn")), 200_000, seed=5
    )
    index = indexes(fasta, gtf)
    opts = align_opts(min_seed_len=20, min_aln_score_percent=0.0,
                      min_aln_score=30, intron_mode=True)
    reads = make_truth_reads(index.ref, 300, seed=9)
    recs = [(n.encode(), s, b"I" * len(s)) for n, s in reads]
    return index, opts, recs


def _pair(index, opts, narrow_band=15):
    """Each side on its own package's Index and AlignOpts."""
    ref = RefBatchAligner(index.ref, opts.ref, backend="pallas",
                          interpret=True)
    port = BatchAligner(index.port, opts.port, device="cpu")
    for a in (ref, port):
        a.PROBLEM_BUDGET = BUDGET
        a.narrow_band = narrow_band
    return ref, port


@pytest.mark.parametrize("case,narrow_band", [
    ("fixture_case", 15), ("fixture_case", 4), ("synth_case", 15),
])
def test_align_batch_equals_reference(request, case, narrow_band):
    index, opts, recs = request.getfixturevalue(case)
    ref, port = _pair(index, opts, narrow_band)
    reads = [r[1] for r in recs]
    want = ref.align_batch(reads)
    got = port.align_batch(reads)
    assert plain(got) == plain(want)
    assert sum(map(len, got)) > 0
    assert port.stats.chunks == ref.stats.chunks > 1
    assert port.stats.cert_patches == ref.stats.cert_patches
    if narrow_band == 4:
        assert port.stats.cert_patches > 0


@pytest.mark.parametrize("case", ["fixture_case", "synth_case"])
@pytest.mark.parametrize("fmt_bam", [False, True])
def test_align_batch_emit_equals_reference(request, case, fmt_bam):
    index, opts, recs = request.getfixturevalue(case)
    ref, port = _pair(index, opts)
    want = ref.align_batch_emit(recs, fmt_bam)
    got = port.align_batch_emit(recs, fmt_bam)
    assert got == want and len(got) > 0


def test_synth_reads_map_and_certificates_patch(synth_case):
    """The 200 kbp synthetic case maps nearly every read and exercises
    the full-band patch path; no CUDA kernel ran on CPU tensors."""
    index, opts, recs = synth_case
    launches = swg_stream.launches
    port = BatchAligner(index.port, opts.port, device="cpu")
    port.PROBLEM_BUDGET = BUDGET
    out = port.align_batch([r[1] for r in recs])
    assert np.mean([len(a) > 0 for a in out]) > 0.9
    assert port.stats.cert_patches > 0
    assert swg_stream.launches == launches


def test_cuda_requested_without_card_raises(fixture_case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    index, opts, _ = fixture_case
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchAligner(index.port, opts.port)
