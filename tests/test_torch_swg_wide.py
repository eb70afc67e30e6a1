"""swg_stream_plain at bands above 31 == the reference's general Pallas
stream kernel (get_stream_traceback_gather_kernel, interpret mode), bit
for bit: tolerance 0, every output is an integer.

Covers W 128 and 256 with mixed bands in one batch, both meta forms, the
split (int16-halves header + streams) and fused (int32 header + streams)
forms, and bands above XMAX, where the port computes fewer band slots
(min(2b+1, XMAX+1), rounded to a class) than the reference's
W = roundup(2b+1, 128) lanes."""

import numpy as np
import pytest
import torch

from thermite_tpu.ops.swg_pallas import (
    get_stream_traceback_gather_kernel,
    meta_row,
    pack_meta_host,
    pack_reads_nib_host,
    pack_text_nib_host,
)
from thermite_tpu_torch.ops.swg_stream import (
    slots_per_lane,
    stream_slots,
    swg_stream,
    swg_stream_plain,
    swg_stream_wide,
)

torch.set_num_threads(1)

BBLK = 8


def general_case(seed, n, band_lo, band_hi, XMAX, YMAX):
    """Random extension problems in both directions with bands drawn
    from [band_lo, band_hi], some windows running into the text padding,
    N/$ text bytes and non-ACGTN read bytes; reads are RPAD = XMAX wide.
    -> (text words, read words, (n, 9) meta)."""
    rng = np.random.default_rng(seed)
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), 6000)
    text[rng.integers(0, len(text), 20)] = ord("N")
    text[3000] = ord("$")
    RPAD, NR = XMAX, 24
    reads = np.zeros((NR, RPAD), np.uint8)
    src = rng.integers(50, len(text) - RPAD - 50, NR)
    for i in range(NR):
        p = int(src[i])
        r = text[p : p + RPAD].copy()
        for _ in range(int(rng.integers(0, 6))):
            r[int(rng.integers(0, RPAD))] = ord("ACGTNX"[int(rng.integers(0, 6))])
        reads[i] = r
    rows = []
    for _ in range(n):
        band = int(rng.integers(band_lo, band_hi + 1))
        xd = int(rng.integers(1, 60))
        ri = int(rng.integers(0, NR))
        q = int(rng.integers(0, RPAD - 1))
        xdir = 1 if rng.random() < 0.5 else -1
        xlen = int(rng.integers(1, XMAX + 1))
        xlen = min(xlen, RPAD - q) if xdir == 1 else min(xlen, q + 1)
        ylen = int(rng.integers(1, YMAX + 1))
        if rng.random() < 0.7:
            # y from the read's source: long alignments and walks
            ydir = xdir
            p = int(src[ri]) + q + int(rng.integers(-3, 4))
        else:
            ydir = 1 if rng.random() < 0.5 else -1
            p = int(rng.integers(0, len(text)))
        if rng.random() < 0.8:  # else the window runs into the padding
            ylen = max(min(ylen, len(text) - p if ydir == 1 else p + 1), 1)
        rows.append(meta_row(p, ydir, ylen, ri * RPAD + q, xdir, xlen, band, xd))
    return (pack_text_nib_host(text), pack_reads_nib_host(reads.reshape(-1)),
            np.asarray(rows, np.int32))


def reference_stream(words, rnib, meta, XMAX, YMAX, W, SMAX, split,
                     bblk=BBLK):
    kern = get_stream_traceback_gather_kernel(
        bblk, XMAX, YMAX, W, interpret=True, SMAX=SMAX, split=split
    )
    out = kern(words, np.int32(len(words)), rnib, meta)
    if split:
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def port_stream(words, rnib, meta, XMAX, YMAX, SMAX, fused, fn=swg_stream_plain):
    out = fn(torch.from_numpy(words), len(words), torch.from_numpy(rnib),
             torch.from_numpy(np.ascontiguousarray(meta)), XMAX, YMAX, SMAX,
             fused=fused)
    if fused:
        return out.numpy()
    return tuple(o.numpy() for o in out)


def _rows_equal(a, b, meta):
    a = np.concatenate(a, 1) if isinstance(a, tuple) else a
    b = np.concatenate(b, 1) if isinstance(b, tuple) else b
    assert a.shape == b.shape
    bad = np.flatnonzero((a != b).any(1))
    assert len(bad) == 0, (
        f"{len(bad)} rows differ; first {bad[:3]}: meta={meta[bad[0]]} "
        f"ref={a[bad[0], :4]} port={b[bad[0], :4]}"
    )


CASES = {
    # name: (seed, band_lo, band_hi, XMAX, YMAX, W, SMAX)
    "w128": (0, 0, 63, 64, 96, 128, 176),
    "w256": (1, 20, 127, 128, 160, 256, 304),
    "band_over_xmax": (2, 65, 127, 64, 128, 256, 208),
}


@pytest.mark.parametrize("meta_cols", [9, 4])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_matches_general_pallas(case, fused, meta_cols):
    seed, lo, hi, XMAX, YMAX, W, SMAX = CASES[case]
    words, rnib, meta = general_case(seed, 2 * BBLK, lo, hi, XMAX, YMAX)
    m = meta if meta_cols == 9 else pack_meta_host(meta)
    ref = reference_stream(words, rnib, m, XMAX, YMAX, W, SMAX, not fused)
    port = port_stream(words, rnib, m, XMAX, YMAX, SMAX, fused)
    _rows_equal(ref, port, meta)
    hdr4 = ref if fused else ref[0].view(np.int16).reshape(-1, 4)
    assert (hdr4[:, 0] > 0).any() and (hdr4[:, 3] > 0).any()
    assert (meta[:, 7] > 31).any()
    if case == "band_over_xmax":
        # the port computes fewer slots than the reference's W lanes
        assert 32 * stream_slots(int(meta[:, 7].max()), XMAX) < W


def test_fused_rows_are_the_split_outputs():
    """fused = [expanded int16 header | streams] on the same inputs."""
    words, rnib, meta = general_case(3, 12, 0, 90, 96, 128)
    split = port_stream(words, rnib, meta, 96, 128, 240, False)
    fused = port_stream(words, rnib, meta, 96, 128, 240, True)
    hdr4 = split[0].view(np.int16).reshape(-1, 4).astype(np.int32)
    assert (fused[:, :4] == hdr4).all() and (fused[:, 4:] == split[1]).all()


def test_slot_classes():
    assert [slots_per_lane(b, 512) for b in (0, 15, 16, 31, 63, 64, 255, 256)] \
        == [1, 1, 2, 2, 4, 8, 16, 32]
    # slots past row XMAX are never needed: band > XMAX is capped
    assert slots_per_lane(1023, 96) == 4 and slots_per_lane(600, 512) == 32
    assert stream_slots(31, 512) == 2 and stream_slots(32, 512) == 4
    assert stream_slots(40, 16) == 4


def test_wrappers_on_cpu():
    """CPU tensors take the plain version and launch nothing."""
    words, rnib, meta = general_case(4, 8, 32, 70, 64, 96)
    launches = (swg_stream.launches, swg_stream_wide.launches)
    a = port_stream(words, rnib, meta, 64, 96, 176, True, fn=swg_stream)
    b = port_stream(words, rnib, meta, 64, 96, 176, True)
    assert (a == b).all()
    hdr, streams = swg_stream_wide(
        torch.from_numpy(words), len(words), torch.from_numpy(rnib),
        torch.from_numpy(meta), 64, 96, 176, 70,
    )
    split = port_stream(words, rnib, meta, 64, 96, 176, False)
    assert (hdr.numpy() == split[0]).all() and (streams.numpy() == split[1]).all()
    assert (swg_stream.launches, swg_stream_wide.launches) == launches


def _insertion_block():
    """Sixteen right-flank problems whose best paths each carry a
    24-base insertion after a c-base match, c = 30..45 (so at sixteen
    different columns): x = y[:c] + 24 junk bases + y[c:c+40]; XMAX 112,
    YMAX 88, band 40."""
    rng = np.random.default_rng(30)
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), 8000)
    RPAD = 112
    reads = np.zeros((16, RPAD), np.uint8)
    rows = []
    for k in range(16):
        c, p = 30 + k, 100 + 400 * k
        x = np.concatenate([text[p : p + c],
                            rng.choice(np.frombuffer(b"ACGT", np.uint8), 24),
                            text[p + c : p + c + 40]])
        reads[k, : len(x)] = x
        rows.append(meta_row(p, 1, c + 42, k * RPAD, 1, len(x), 40, 40))
    return (pack_text_nib_host(text), pack_reads_nib_host(reads.reshape(-1)),
            np.asarray(rows, np.int32))


def test_walk_cut_at_maxit_is_a_block_artefact():
    """The reference walks the problems of a block together, column by
    column, and stops after MAXIT = YMAX + XMAX + 3 two-step iterations
    (swg_pallas.py:467, :542): a block whose insertion chains sit in
    different columns is cut there and flagged -1.  The port walks each
    problem on its own and completes it; the completed row equals the
    reference's row for the same problem in a block of its own."""
    words, rnib, meta = _insertion_block()
    XMAX, YMAX, W, SMAX = 112, 88, 128, 208
    together = reference_stream(words, rnib, meta, XMAX, YMAX, W, SMAX, False,
                                bblk=16)
    port = port_stream(words, rnib, meta, XMAX, YMAX, SMAX, True)
    assert (together[:, 3] == -1).any(), "the block walk was not cut"
    assert (port[:, 3] != -1).all()
    pad = np.zeros((BBLK - 1, 9), np.int32)
    pad[:, 2] = pad[:, 5] = pad[:, 7] = pad[:, 8] = 1
    for k in range(len(meta)):
        alone = reference_stream(words, rnib, np.concatenate([meta[k : k + 1], pad]),
                                 XMAX, YMAX, W, SMAX, False)[0]
        assert (alone == port[k]).all(), k
    uncut = together[:, 3] != -1
    assert (together[uncut] == port[uncut]).all()
