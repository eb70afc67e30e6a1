"""A dry run of the multi-device layout at a small size.

``dryrun_multichip(n)`` runs, on a mesh of ``n`` devices, the two steps
that prove the layout: the ``dp_gather_align_step`` (text and read block
replicated, problems split, forward scores per device, one count summed
on the host) on a 4096-byte text, and the whole batch pipeline under the
mesh (``BatchAligner(mesh=...)``: build, per-device launches, arbitrate,
finalize) on 512 reads of a 60 kbp synthetic genome, whose alignments
must equal the single-device run's.  On ``device="cpu"`` the mesh is ``n``
entries of the CPU device and the kernels' plain versions run; on
``"cuda"`` it needs ``n`` cards.

    python -m thermite_tpu_torch.parallel.dryrun 8 [cpu|cuda]
"""

from __future__ import annotations

import sys
import tempfile

import numpy as np

from ..ops.layout import meta_row
from .mesh import dp_gather_align_step, make_mesh


def _render(alns):
    return [
        (g.ref_name, g.strand, g.aln_type, g.primary, g.gx_aln.score,
         g.gx_aln.ystart, g.gx_aln.yend, g.gx_aln.xstart, g.gx_aln.xend,
         tuple(g.gx_aln.operations))
        for g in alns
    ]


def dryrun_multichip(n_devices: int, device="cpu") -> None:
    """Raises AssertionError where the layout fails; returns nothing."""
    mesh = make_mesh(n_devices, device)

    # 1) resident text, replicated reads, problems split over the mesh:
    # a right extension and a reversed left one per read
    XMAX, YMAX, RPAD = 32, 64, 32
    B = 8 * n_devices
    step = dp_gather_align_step(mesh, XMAX, YMAX)
    rng = np.random.default_rng(0)
    # ACGT only: the nibble-packed text has no code for other letters
    ref_text = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 4096)]
    reads = np.zeros((B, RPAD), np.uint8)
    meta = np.zeros((2 * B, 9), np.int32)
    for i in range(B):
        p = int(rng.integers(0, len(ref_text) - RPAD))
        reads[i] = ref_text[p : p + RPAD]
        meta[2 * i] = meta_row(p + 4, 1, 40, i * RPAD + 4, 1, RPAD - 4, 8, 8)
        meta[2 * i + 1] = meta_row(
            p + 3, -1, min(p + 4, 40), i * RPAD + 3, -1, 4, 8, 8
        )
    score, _, _, n_pass = step(ref_text, reads, meta, 5)
    assert score.shape == (2 * B,)
    assert n_pass > 0, "the split gather + DP step found no alignments"

    # 2) the whole pipeline under the mesh == the single-device run
    from ..align.batch import BatchAligner
    from ..align.driver import AlignOpts
    from ..index.build import Index
    from ..testing.synth import make_truth_reads, write_synth_genome

    with tempfile.TemporaryDirectory() as d:
        fasta, gtf = write_synth_genome(d, 60_000, seed=17, basename="dr")
        idx = Index.create_from_files(fasta, gtf)
    opts = AlignOpts(
        min_seed_len=20, min_aln_score_percent=0.0, min_aln_score=30,
        intron_mode=True,
    )
    seqs = [r[1] for r in make_truth_reads(idx, 512, seed=23)]
    meshed = BatchAligner(idx, opts, mesh=mesh).align_batch(seqs)
    single = BatchAligner(idx, opts, device=mesh[0]).align_batch(seqs)
    n_mapped = sum(1 for a in meshed if a)
    assert n_mapped > 0.9 * len(seqs), f"mesh run mapped only {n_mapped}"
    for i, (a, b) in enumerate(zip(meshed, single)):
        assert _render(a) == _render(b), f"mesh/single divergence at read {i}"


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                     sys.argv[2] if len(sys.argv) > 2 else "cpu")
    print("dry run passed")
