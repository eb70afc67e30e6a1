"""The genome-scale path of the port at a size the CPU runs:
``thermite_tpu_torch.tools.genome_scale`` on a 2 Mbp synthetic genome
with a stride-4 seed table (forced into the packed form that genome-scale
tables take, ``THERMITE_PACKED_MIN=1``), held against the reference
package on the same files and artifacts, and the pieces that only a real
genome reaches: text anchors past 2^31 nibbles through the plain gather
and the kernels' meta unpacking, and the per-thread CPU accounting of ``tools/thread_tax``."""

import os
import types

import numpy as np
import pytest
import torch

from test_torch_kernel_host import host_lib  # noqa: F401 (fixture)
from thermite_tpu.align.batch import BatchAligner as RefBatchAligner
from thermite_tpu.align.driver import OracleAligner as RefOracleAligner
from thermite_tpu.index.build import Index as RefIndex
from thermite_tpu_torch.align.batch import BatchAligner
from thermite_tpu_torch.align.driver import OracleAligner
from thermite_tpu_torch.index.build import Index
from thermite_tpu_torch.ops import layout
from thermite_tpu_torch.ops.swg_stream import gather_span_nib, meta9
from thermite_tpu_torch.seed.native import PackedSeedTable
from thermite_tpu_torch.tools import genome_scale as gs
from thermite_tpu_torch.tools.thread_tax import format_rows, thread_tax
from torch_sides import align_opts, plain

torch.set_num_threads(1)

GENOME_BP = 2_000_000
N_READS = 256
REF_KEYS = ("metric", "genome_bp", "text_bytes", "seed_stride", "value",
            "unit", "mapped_fraction", "truth_overlap_primary",
            "oracle_spot_mismatches", "table_build_s", "text_upload_s",
            "artifact_save_s", "artifact_load_s")
OPTS = dict(min_seed_len=20, min_aln_score_percent=0.0, min_aln_score=30,
            intron_mode=True)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One run of the tool on the CPU, artifact round trip included."""
    out_dir = str(tmp_path_factory.mktemp("genome_scale"))
    mp = pytest.MonkeyPatch()
    mp.setenv("THERMITE_PACKED_MIN", "1")
    keep = {}
    try:
        result = gs.run_genome_scale(GENOME_BP, N_READS, 4, out_dir,
                                     device="cpu", n_warm=64, keep=keep)
        yield out_dir, result, keep
    finally:
        mp.undo()


@pytest.fixture(scope="module")
def ref_side(run):
    """The reference on the same FASTA and GTF: its own Index, stride-4
    table and interpret-mode pipeline with the C++ engine."""
    out_dir, _, keep = run
    mp = pytest.MonkeyPatch()
    mp.setenv("THERMITE_PACKED_MIN", "1")
    try:
        idx = RefIndex.create_from_files(os.path.join(out_dir, "wg.fasta"),
                                         os.path.join(out_dir, "wg.gtf"))
        idx.build_seed_table(stride=4)
        opts = align_opts(**OPTS).ref
        aligner = RefBatchAligner(idx, opts, backend="pallas", interpret=True,
                                  use_native=True)
        seqs = [r[1] for r in keep["recs"]]
        yield idx, opts, aligner.align_batch(seqs)
    finally:
        mp.undo()


def test_tool_runs_at_small_scale(run):
    out_dir, result, keep = run
    assert all(k in result for k in REF_KEYS)
    assert result["oracle_spot_mismatches"] == 0
    assert result["oracle_spot_reads"] == N_READS
    assert result["truth_overlap_primary"] >= 0.99
    assert result["genome_bp"] == GENOME_BP and result["seed_stride"] == 4
    assert result["artifact_bytes"] > 0 and result["artifact_load_s"] >= 0
    assert result["bam_bytes"] == len(keep["bam"]) > 0
    # the CPU path launches no kernel; the tensors say why
    assert result["bam_stream_launches"] == 0
    assert result["device"] == "cpu"
    assert set(result["stages"]) >= {"build", "arbitrate host",
                                     "finalize host"}
    assert any(t["main"] for t in result["bam_threads"])
    # the run aligned on the reloaded, memory-mapped artifact
    idx = keep["index"]
    assert isinstance(idx.seed_table, PackedSeedTable)
    assert idx.seed_table.stride == 4
    assert isinstance(idx.text_nib_arr, np.memmap)
    assert os.path.exists(os.path.join(out_dir, "genome_scale.json"))


def test_main_path_equals_reference(run, ref_side):
    """The port's align_batch on the tool's aligner == the reference's
    interpret-mode pipeline on its own index of the same files, field by
    field."""
    _, _, keep = run
    _, _, want = ref_side
    got = keep["aligner"].align_batch([r[1] for r in keep["recs"]])
    assert plain(got) == plain(want)
    assert sum(1 for a in got if a) > 0.9 * len(got)


@pytest.mark.parametrize("saved_by", ["port", "reference"])
def test_stride4_artifact_crosses_packages(run, ref_side, tmp_path, saved_by):
    """A stride-4 packed artifact saved by one package loads in the other
    and gives the same alignments: the port's batch path on the
    reference's artifact equals the reference's pipeline; the reference's
    oracle on the port's artifact equals the port's oracle."""
    out_dir, _, keep = run
    ref_idx, ref_opts, want = ref_side
    seqs = [r[1] for r in keep["recs"]]
    opts = align_opts(**OPTS)
    if saved_by == "reference":
        path = str(tmp_path / "ref.npz")
        ref_idx.save(path)
        idx = Index.load(path, mmap=True)
        assert isinstance(idx.seed_table, PackedSeedTable)
        assert idx.seed_table.stride == 4
        got = BatchAligner(idx, opts.port, device="cpu").align_batch(seqs)
        assert plain(got) == plain(want)
    else:
        path = os.path.join(out_dir, "wg_index.npz")
        idx = RefIndex.load(path, mmap=True)
        assert idx.seed_table.stride == 4
        ref = RefOracleAligner(idx, ref_opts)
        port = OracleAligner(keep["index"], opts.port)
        for s in seqs[:64]:
            assert plain(ref.align_read(s)) == plain(port.align_read(s))


def test_artifact_maps_without_numpy_private_api(run, monkeypatch, capsys):
    """The artifact's members are memory-mapped through numpy's public
    .npy header readers: with the private reader gone, as in newer numpy
    releases, a load still maps the text, its nibble words and the packed
    table, and warns of nothing."""
    out_dir, _, _ = run
    # the public surface of np.lib.format alone, as newer numpy has it
    shim = types.ModuleType("numpy.lib.format")
    for name in dir(np.lib.format):
        if not name.startswith("_"):
            setattr(shim, name, getattr(np.lib.format, name))
    monkeypatch.setattr(np.lib, "format", shim)
    idx = Index.load(os.path.join(out_dir, "wg_index.npz"), mmap=True)
    for arr in (idx.ref_text_arr, idx.text_nib_arr, idx.seed_table.kv,
                idx.seed_table.bucket_off):
        assert isinstance(arr, np.memmap)
    assert "not memory-mapped" not in capsys.readouterr().err


# -- anchors past 2^31 --------------------------------------------------

def test_gather_past_2_31_nibbles():
    """gather_span_nib at anchors near 6e9 nibbles (a 3 Gbp fwd+rc text)
    in both directions, on a words tensor of about 8e8 words that holds
    no memory (one word expanded), against numpy with Python ints; and at
    the last word, where the word index clamps."""
    lw = 800_000_000
    word = 0x76543210  # nibble i holds i: the sub-word shift shows
    words = torch.tensor([word], dtype=torch.int32).expand(lw)
    assert words.stride() == (0,)
    span = 24
    anchors = [6_000_000_003, 6_000_000_000 - 1, (1 << 31) + 5,
               (1 << 31) - 2, 8 * lw - 3, 8 * lw + 40]
    dirs = [1, -1, 1, -1, 1, -1]
    got = gather_span_nib(words, torch.tensor(anchors, dtype=torch.int64),
                          torch.tensor(dirs, dtype=torch.int32), span)
    for r, (a, d) in enumerate(zip(anchors, dirs)):
        want = [(word >> (4 * ((a + d * m) % 8))) & 0xF for m in range(span)]
        assert got[r].tolist() == want, (a, d)

    # a constant word hides the word index; words whose value is a
    # function of their index, computed on demand, show it
    class IndexWords:
        shape, device = (lw,), torch.device("cpu")

        @staticmethod
        def value(w):
            return (w * 2654435761) & 0x7FFFFFFF

        def __getitem__(self, idx):
            return self.value(idx).to(torch.int32)

    got = gather_span_nib(IndexWords(), torch.tensor(anchors, dtype=torch.int64),
                          torch.tensor(dirs, dtype=torch.int32), span)
    for r, (a, d) in enumerate(zip(anchors, dirs)):
        want = []
        for m in range(span):
            pos = a + d * m
            w = IndexWords.value(min(max(pos // 8, 0), lw - 1))
            want.append((w >> (4 * (pos % 8))) & 0xF)
        assert got[r].tolist() == want, (a, d)


@pytest.mark.parametrize("cols", [9, 4])
def test_meta_anchor_past_2_31(host_lib, cols):  # noqa: F811
    """A problem whose text position lies past 2^31 (and past 2^32)
    through the port's meta rows (layout.meta_row, pack_meta_host, meta9)
    and the kernels' unpack_meta built with g++ gives the int64 anchor."""
    y_bases = [(1 << 31) + 17, 3 * (1 << 31) + 6, 6_199_999_911, 5]
    rows = np.array([layout.meta_row(y, (-1) ** i, 90, 128 * i, 1, 90, 15, 60)
                     for i, y in enumerate(y_bases)], np.int32)
    if cols == 4:
        rows = layout.pack_meta_host(rows)
    out = np.zeros((len(rows), 8), np.int64)
    host_lib.thermite_swg_host_unpack_meta(
        rows.ctypes.data, cols, len(rows), out.ctypes.data)
    want = [y + layout._WPAD for y in y_bases]
    assert out[:, 0].tolist() == want
    m9 = meta9(torch.from_numpy(rows)).to(torch.int64)
    assert (8 * m9[:, 0] + m9[:, 1]).tolist() == want
    assert (m9[:, 2] == torch.tensor([1, -1, 1, -1])).all()


# -- thread accounting -------------------------------------------------

def test_thread_tax_counts_the_main_thread():
    result, wall, rows = thread_tax(lambda: sum(range(2_000_000)), min_s=0.0)
    assert result == sum(range(2_000_000)) and wall > 0
    mine = [r for r in rows if r[1] == os.getpid()]
    assert len(mine) == 1 and mine[0][0] >= 0
    assert all(r[0] >= 0 for r in rows)
    lines = format_rows(rows, wall)
    assert lines[0].startswith("total thread CPU") and "[main]" in "".join(lines)
