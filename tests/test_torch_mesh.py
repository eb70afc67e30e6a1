"""The port's mesh module (``thermite_tpu_torch/parallel/mesh.py``): the
mesh, the row split and merge, and the per-device kernel calls, which
give the unsplit call's rows and the reference's under its 8-device CPU
mesh.  (The batch pipeline under a mesh: tests/test_torch_mesh_batch.py.)

Both sides run on the CPU from the same numpy-seeded inputs.  The port's
mesh of N is N entries of the CPU device, so the whole split (rows
round-robin over the devices), the per-device wrapper calls (the plain
PyTorch versions on CPU tensors) and the merge in input order run here.
The reference runs its ``shard_map`` kernels in interpret mode, which cut
the rows into contiguous blocks.  Tolerance 0 everywhere: kernel rows are
integers.  The kernel inputs are the 64-row stream-kernel case of
tests/test_mesh_batch.py and the step of ``__graft_entry__.py``'s dry
run."""

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from thermite_tpu.ops.swg_pallas import meta_row
from thermite_tpu.parallel import mesh as ref_mesh
from thermite_tpu_torch import device as port_device
from thermite_tpu_torch.ops.layout import (
    pack_reads_nib_host,
    pack_text_nib_host,
)
from thermite_tpu_torch.ops.swg_forward import swg_forward
from thermite_tpu_torch.ops.swg_stream import swg_stream
from thermite_tpu_torch.parallel import mesh as port_mesh

torch.set_num_threads(1)



# -- the mesh and the row split ----------------------------------------


def test_make_mesh_cpu_is_n_entries_of_the_cpu():
    assert port_mesh.make_mesh(3, "cpu") == (torch.device("cpu"),) * 3
    assert port_mesh.make_mesh(None, "cpu") == (torch.device("cpu"),)
    with pytest.raises(ValueError, match="0-device mesh"):
        port_mesh.make_mesh(0, "cpu")


def test_make_mesh_raises_beyond_the_device_count(monkeypatch):
    """The reference's message: one card, two asked for."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert port_mesh.make_mesh(1) == (torch.device("cuda", 0),)
    assert port_mesh.make_mesh(None) == (torch.device("cuda", 0),)
    want = "requested a 2-device mesh but only 1 local device"
    with pytest.raises(ValueError, match=want):
        port_mesh.make_mesh(2)
    with pytest.raises(ValueError, match="requested a 9-device mesh but only 8"):
        ref_mesh.make_mesh(9)


def test_make_mesh_cuda_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        port_mesh.make_mesh(1)
    with pytest.raises(RuntimeError, match="CUDA"):
        port_mesh.make_mesh(None, "cuda")


def test_mesh_of_cpu_and_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="all cards or all CPU"):
        port_mesh.check_mesh(["cpu", "cuda:0"])
    with pytest.raises(ValueError, match="at least one device"):
        port_mesh.check_mesh([])


@pytest.mark.parametrize("n_rows,n_dev", [(7, 2), (10, 3), (1, 8), (0, 4),
                                          (129, 8), (128, 8)])
def test_split_rows_is_round_robin(n_rows, n_dev):
    parts = port_mesh.split_rows(n_rows, n_dev)
    assert len(parts) == n_dev
    for d, rows in enumerate(parts):
        assert rows.tolist() == list(range(n_rows))[d::n_dev]
        # row r lives on device r % n at local row r // n
        assert (rows % n_dev == d).all()
        assert (rows // n_dev == np.arange(len(rows))).all()
    assert sorted(np.concatenate(parts).tolist()) == list(range(n_rows))


@settings(max_examples=60, deadline=None)
@given(st.integers(0, 300), st.integers(1, 9), st.integers(1, 5),
       st.integers(0, 2 ** 31 - 1))
def test_split_then_merge_is_the_identity(n_rows, n_dev, cols, seed):
    rows = np.random.default_rng(seed).integers(
        -(1 << 31), 1 << 31, (n_rows, cols)).astype(np.int32)
    parts = [rows[i] for i in port_mesh.split_rows(n_rows, n_dev)]
    assert all(len(p) in (n_rows // n_dev, n_rows // n_dev + 1) for p in parts)
    back = port_mesh.merge_rows(parts, n_rows)
    assert back.dtype == rows.dtype and np.array_equal(back, rows)
    # scatter_rows uploads the same parts
    mesh = port_mesh.make_mesh(n_dev, "cpu")
    for got, want in zip(port_mesh.scatter_rows(mesh, rows), parts):
        assert np.array_equal(got.numpy(), want)


def test_merge_rows_at_given_indices():
    """The winners' gather merges at explicit positions."""
    rows = np.arange(40, dtype=np.int32).reshape(10, 4)
    at = [np.array([0, 9, 3]), np.array([], np.int64), np.array([1, 2, 4, 5, 6, 7, 8])]
    back = port_mesh.merge_rows([rows[i] for i in at], 10, at)
    assert np.array_equal(back, rows)


def test_replicate_uploads_once_per_distinct_device():
    mesh = port_mesh.make_mesh(4, "cpu")
    reps = port_mesh.replicate(mesh, np.arange(5, dtype=np.int32))
    assert len(reps) == 4 and all(r is reps[0] for r in reps)
    assert port_device.upload(np.arange(3), torch.device("cpu")).tolist() == [0, 1, 2]


def test_release_pinned_waits_for_each_card_then_empties(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda d: calls.append(d))
    monkeypatch.setattr(torch.accelerator, "empty_host_cache",
                        lambda: calls.append("empty"), raising=False)
    port_device.release_pinned(port_mesh.make_mesh(4, "cpu"))
    assert calls == []  # no card: no call into CUDA
    cards = (torch.device("cuda", 0),) * 3 + (torch.device("cuda", 1),)
    port_device.release_pinned(cards)
    assert sorted(map(str, calls[:2])) == ["cuda:0", "cuda:1"]
    assert calls[2:] == ["empty"]


# -- kernel level: split rows == the unsplit call == the reference -----


def _stream_case():
    """The inputs of tests/test_mesh_batch.py::
    test_sharded_stream_kernel_matches_unsharded: 16 real problems and
    48 empty padding rows over a 4000-byte text."""
    rng = np.random.default_rng(11)
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), 4000)
    RPAD, B, N = 32, 8, 64
    reads = np.zeros((B, RPAD), np.uint8)
    meta = np.zeros((N, 9), np.int32)
    for i in range(B):
        p = int(rng.integers(100, len(text) - 100))
        reads[i] = text[p : p + RPAD]
        meta[2 * i] = meta_row(p + 4, 1, 40, i * RPAD + 4, 1, RPAD - 4, 8, 8)
        meta[2 * i + 1] = meta_row(p + 3, -1, 12, i * RPAD + 3, -1, 4, 8, 8)
    for r in range(2 * B, N):
        meta[r] = (64, 0, 1, 0, 0, 1, 0, 1, 1)
    return text, reads, meta


def _port_inputs(mesh, text, reads, meta):
    return (port_mesh.replicate(mesh, pack_text_nib_host(text)),
            port_mesh.replicate(mesh, pack_reads_nib_host(reads.reshape(-1))),
            port_mesh.scatter_rows(mesh, meta))


@pytest.mark.parametrize("n_dev", [1, 3, 8])
@pytest.mark.parametrize("fused", [True, False], ids=["fused", "split"])
def test_sharded_stream_equals_unsplit_and_reference(fused, n_dev):
    from thermite_tpu.ops.swg_pallas import nib_lw
    from thermite_tpu.ops.swg_pallas import pack_text_nib_host as ref_pack

    text, reads, meta = _stream_case()
    XMAX, YMAX, W, SMAX, BBLK = 32, 64, 128, 128, 8
    maker = ref_mesh.sharded_stream_kernel if fused \
        else ref_mesh.sharded_stream_split_kernel
    ref = maker(ref_mesh.make_mesh(8), BBLK, XMAX, YMAX, W, interpret=True,
                SMAX=SMAX)(ref_pack(text), np.int32(nib_lw(len(text))), reads,
                           meta)
    want = [np.asarray(ref)] if fused else [np.asarray(r) for r in ref]

    mesh = port_mesh.make_mesh(n_dev, "cpu")
    texts, blocks, metas = _port_inputs(mesh, text, reads, meta)
    outs = port_mesh.sharded_stream(mesh, texts, blocks, metas, XMAX, YMAX,
                                    SMAX, band_max=8, fused=fused)
    assert len(outs) == n_dev
    whole = swg_stream(texts[0], texts[0].shape[0], blocks[0],
                       torch.from_numpy(meta), XMAX, YMAX, SMAX, band_max=8,
                       fused=fused)
    if fused:
        outs, whole = [(o,) for o in outs], (whole,)
    for k, ref_rows in enumerate(want):
        got = port_mesh.merge_rows([o[k].numpy() for o in outs], len(meta))
        assert np.array_equal(got, whole[k].numpy())
        assert got.shape == ref_rows.shape and np.array_equal(got, ref_rows)
    assert (want[0][:16, 0] != 0).any()  # some real scores


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_forward_equals_unsplit(n_dev):
    text, reads, meta = _stream_case()
    mesh = port_mesh.make_mesh(n_dev, "cpu")
    texts, blocks, metas = _port_inputs(mesh, text, reads, meta)
    outs = port_mesh.sharded_forward(mesh, texts, blocks, metas, 32, 64,
                                     band_max=8)
    whole = swg_forward(texts[0], texts[0].shape[0], blocks[0],
                        torch.from_numpy(meta), 32, 64, band_max=8)
    got = port_mesh.merge_rows([o.numpy() for o in outs], len(meta))
    assert np.array_equal(got, whole.numpy()) and (got[:16, 0] > 0).any()
    # the fused stream rows carry the same scores and end cells
    fused = swg_stream(texts[0], texts[0].shape[0], blocks[0],
                       torch.from_numpy(meta), 32, 64, 128, band_max=8,
                       fused=True)
    assert np.array_equal(got[:, :3], fused.numpy()[:, :3])


@pytest.mark.parametrize("n_dev", [1, 4, 8])
def test_dp_gather_align_step_equals_reference(n_dev):
    """The dry run's step: the same text, reads and 2*B problems through
    the reference's step on its 8-device mesh; ``n_pass`` is summed on
    the host here and by ``psum`` there."""
    XMAX, YMAX, RPAD, B = 32, 64, 32, 64
    rng = np.random.default_rng(0)
    text = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, 4096)]
    reads = np.zeros((B, RPAD), np.uint8)
    meta = np.zeros((2 * B, 9), np.int32)
    for i in range(B):
        p = int(rng.integers(0, len(text) - RPAD))
        reads[i] = text[p : p + RPAD]
        meta[2 * i] = meta_row(p + 4, 1, 40, i * RPAD + 4, 1, RPAD - 4, 8, 8)
        meta[2 * i + 1] = meta_row(p + 3, -1, min(p + 4, 40), i * RPAD + 3,
                                   -1, 4, 8, 8)
    want = ref_mesh.dp_gather_align_step(ref_mesh.make_mesh(8), XMAX, YMAX,
                                         128)(text, reads, meta, np.int32(5))
    got = port_mesh.dp_gather_align_step(
        port_mesh.make_mesh(n_dev, "cpu"), XMAX, YMAX)(text, reads, meta, 5)
    for g, w in zip(got[:3], want[:3]):
        assert np.array_equal(g, np.asarray(w))
    assert got[3] == int(want[3]) > 0
