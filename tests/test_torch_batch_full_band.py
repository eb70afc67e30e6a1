"""The port's full-band batch path equals the reference pipeline, and
the narrow-band knob is honoured.

``THERMITE_NARROW_BAND=0`` (or ``narrow_band = 0``) submits every
problem at its original band: 60 for the 90 bp synthetic reads, so the
general-band stream kernel runs.  Both sides run on the CPU: the port
with its plain kernels (device="cpu"), the reference as
BatchAligner(backend="pallas", interpret=True), with PROBLEM_BUDGET =
256 so batches cross several chunks.  Alignments, SAM and BAM bytes,
kernel shapes and the pipeline counters are compared exactly."""

import pytest
import torch

from test_torch_batch import fixture_case, synth_case  # noqa: F401 (fixtures)
from thermite_tpu.align.batch import BatchAligner as RefBatchAligner
from thermite_tpu_torch.align.batch import BatchAligner
from thermite_tpu_torch.ops.swg_stream import swg_stream
from thermite_tpu_torch.parallel import mesh as port_mesh
from torch_sides import plain

torch.set_num_threads(1)

BUDGET = 256
CASES = ["fixture_case", "synth_case"]


def _pair(index, opts, narrow_band=15, use_native=True):
    ref = RefBatchAligner(index.ref, opts.ref, backend="pallas",
                          interpret=True, use_native=use_native)
    port = BatchAligner(index.port, opts.port, device="cpu",
                        use_native=use_native)
    for a in (ref, port):
        a.PROBLEM_BUDGET = BUDGET
        a.narrow_band = narrow_band
    return ref, port


def _same_counters(ref, port):
    for k in ("chunks", "reads", "problems", "tasks", "winners", "dp_cells",
              "cert_patches", "stream_fallbacks"):
        assert getattr(port.stats, k) == getattr(ref.stats, k), k


@pytest.mark.parametrize("case", CASES)
def test_align_batch_equals_reference(request, case):
    index, opts, recs = request.getfixturevalue(case)
    ref, port = _pair(index, opts, narrow_band=0)
    reads = [r[1] for r in recs]
    want = ref.align_batch(reads)
    got = port.align_batch(reads)
    assert plain(got) == plain(want) and sum(map(len, got)) > 0
    assert port.stats.chunks > 1
    _same_counters(ref, port)


@pytest.mark.parametrize("fmt_bam", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_align_batch_emit_equals_reference(request, case, fmt_bam):
    index, opts, recs = request.getfixturevalue(case)
    ref, port = _pair(index, opts, narrow_band=0)
    want = ref.align_batch_emit(recs, fmt_bam)
    got = port.align_batch_emit(recs, fmt_bam)
    assert got == want and len(got) > 0


def test_narrow_band_knob_is_read(monkeypatch, synth_case):  # noqa: F811
    """THERMITE_NARROW_BAND is read at construction, as the reference
    reads it; at 0 the full-band path gives the reference's bytes."""
    index, opts, recs = synth_case
    assert BatchAligner(index.port, opts.port, device="cpu").narrow_band == 15
    monkeypatch.setenv("THERMITE_NARROW_BAND", "40")
    assert BatchAligner(index.port, opts.port, device="cpu").narrow_band == 40
    monkeypatch.setenv("THERMITE_NARROW_BAND", "0")
    port = BatchAligner(index.port, opts.port, device="cpu")
    ref = RefBatchAligner(index.ref, opts.ref, backend="pallas",
                          interpret=True, use_native=True)
    assert port.narrow_band == ref.narrow_band == 0
    for a in (ref, port):
        a.PROBLEM_BUDGET = BUDGET
    sub = recs[:120]
    assert port.align_batch_emit(sub, True) == ref.align_batch_emit(sub, True)
    assert port.stats.cert_patches == ref.stats.cert_patches


@pytest.mark.parametrize("use_native,narrow_band",
                         [(True, 15), (True, 0), (False, 15)])
def test_pinned_shapes_equal_reference(synth_case, use_native,  # noqa: F811
                                       narrow_band):
    """_pin_shapes pins the kernel shapes to the band the device sees:
    the narrowed band only while narrowing (C++ engine and
    narrow_band > 0), else the original band."""
    index, opts, recs = synth_case
    ref, port = _pair(index, opts, narrow_band, use_native)
    reads = [r[1] for r in recs]
    ref._pin_shapes(reads)
    port._pin_shapes(reads)
    for k in ("_XMAX", "_YMAX", "_W", "_SMAX", "_SMAX_HOST", "_NFWD1",
              "_NFWD", "_NTB", "_NREADS"):
        assert getattr(port, k) == getattr(ref, k), k
    assert port._YMAX == (160 if narrow_band == 0 or not use_native else 128)


def test_full_band_meta_reaches_the_kernel_unnarrowed(monkeypatch,
                                                      synth_case):  # noqa: F811
    """At narrow_band 0 the device gets the original bands (60 here),
    not bands capped at 0; the C++ patches equal the reference's."""
    index, opts, recs = synth_case
    seen = []

    def spy(*args, **kw):
        seen.append((int(kw["band_max"]), int(args[3][:, 7].max())
                     if args[3].shape[1] == 9 else None))
        return swg_stream(*args, **kw)

    # the pipeline launches through the mesh, of one device here
    monkeypatch.setattr(port_mesh, "swg_stream", spy)
    ref, port = _pair(index, opts, narrow_band=0)
    reads = [r[1] for r in recs[:100]]
    assert plain(port.align_batch(reads)) == plain(ref.align_batch(reads))
    assert seen and max(b for b, _ in seen) == 60
    assert port.stats.cert_patches == ref.stats.cert_patches


def test_dp_cells_use_the_reference_lane_width(synth_case):  # noqa: F811
    """dp_cells counts padded rows x YMAX x the reference's lane width:
    64 (two problems per 128-lane row) on the narrowed path."""
    index, opts, recs = synth_case
    ref, port = _pair(index, opts)
    reads = [r[1] for r in recs]
    assert plain(port.align_batch(reads)) == plain(ref.align_batch(reads))
    assert port.stats.dp_cells == ref.stats.dp_cells
    assert port.stats.dp_cells == port.stats.chunks * port._NFWD1 * port._YMAX * 64
