"""The port's batch path without the C++ engine (use_native=False)
equals the reference's: Python build and arbitration, the forward-scores
kernel on every nontrivial problem, the stream kernel's fused rows for
the winners, decoded, stitched and lifted in Python.

Both sides run on the CPU: the port with its plain kernels
(device="cpu"), the reference as BatchAligner(backend="pallas",
interpret=True, use_native=False), with PROBLEM_BUDGET = 256 so batches
cross several chunks.  Alignments, SAM and BAM bytes and the pipeline
counters are compared exactly."""

import numpy as np
import pytest
import torch

from test_torch_batch import fixture_case, synth_case  # noqa: F401 (fixtures)
from thermite_tpu.align.batch import BatchAligner as RefBatchAligner
from thermite_tpu_torch.align.batch import BatchAligner
from thermite_tpu_torch.ops.swg_forward import swg_forward
from thermite_tpu_torch.ops.swg_stream import swg_stream, swg_stream_wide

torch.set_num_threads(1)

BUDGET = 256
CASES = ["fixture_case", "synth_case"]


def _pair(index, opts):
    ref = RefBatchAligner(index, opts, backend="pallas", interpret=True,
                          use_native=False)
    port = BatchAligner(index, opts, device="cpu", use_native=False)
    for a in (ref, port):
        a.PROBLEM_BUDGET = BUDGET
    return ref, port


def _same_counters(ref, port):
    for k in ("chunks", "reads", "problems", "tasks", "winners", "dp_cells",
              "cert_patches", "stream_fallbacks"):
        assert getattr(port.stats, k) == getattr(ref.stats, k), k


@pytest.mark.parametrize("case", CASES)
def test_align_batch_equals_reference(request, case):
    index, opts, recs = request.getfixturevalue(case)
    ref, port = _pair(index, opts)
    reads = [r[1] for r in recs]
    want = ref.align_batch(reads)
    got = port.align_batch(reads)
    assert got == want and sum(map(len, got)) > 0
    assert port.stats.chunks > 1
    _same_counters(ref, port)


@pytest.mark.parametrize("fmt_bam", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_align_batch_emit_equals_reference(request, case, fmt_bam):
    index, opts, recs = request.getfixturevalue(case)
    ref, port = _pair(index, opts)
    want = ref.align_batch_emit(recs, fmt_bam)
    got = port.align_batch_emit(recs, fmt_bam)
    assert got == want and len(got) > 0


def test_no_native_path_has_no_engine_and_launches_nothing_on_cpu(
        synth_case):  # noqa: F811
    index, opts, recs = synth_case
    counts = (swg_stream.launches, swg_stream_wide.launches,
              swg_forward.launches)
    port = BatchAligner(index, opts, device="cpu", use_native=False)
    assert port.native is None
    port.PROBLEM_BUDGET = BUDGET
    out = port.align_batch([r[1] for r in recs[:100]])
    assert np.mean([len(a) > 0 for a in out]) > 0.9
    assert port.stats.winners > 0 and port.stats.cert_patches == 0
    assert (swg_stream.launches, swg_stream_wide.launches,
            swg_forward.launches) == counts
