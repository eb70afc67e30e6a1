"""The adversarial parity fuzz at full band and ``-s0`` on the CPU
(tolerance 0): the fuzz reads of ``test_torch_fuzz_parity.py`` at their
original bands (up to 122 on a 152 bp read), where the stream kernel's
widest pipeline group (32 lanes x 8 slots) serves them.  Alignments,
certificate patches, SAM and BAM bytes equal the reference pipeline's.
A file of its own: the plain general-band path at YMAX 288 is the
slowest of the fuzz on the CPU."""

import pytest
import torch

from test_torch_fuzz_parity import case, check_align_batch, check_emit  # noqa: F401
from thermite_tpu_torch.ops.swg_stream import stream_group
from thermite_tpu_torch.parallel import mesh as port_mesh

torch.set_num_threads(1)


def test_align_batch_equals_reference(monkeypatch, case):  # noqa: F811
    seen = []
    wide = port_mesh.swg_stream

    def spy(*args, **kw):
        seen.append((int(kw["band_max"]), int(args[4])))
        return wide(*args, **kw)

    monkeypatch.setattr(port_mesh, "swg_stream", spy)
    check_align_batch(case, 0.0, 0)
    assert seen and max(b for b, _ in seen) > 63
    assert {stream_group(b, x) for b, x in seen} == {(32, 8)}


@pytest.mark.parametrize("fmt_bam", [False, True])
def test_emit_equals_reference(case, fmt_bam):  # noqa: F811
    check_emit(case, 0.0, 0, fmt_bam)
