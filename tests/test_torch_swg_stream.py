"""swg_stream_plain == the reference lane-packed Pallas stream kernel
(make_packed_stream_gather_kernel, split form, interpret mode), bit for
bit: tolerance 0, every output is an integer.

Covers SEG 64 (band <= 31) and SEG 32 (band <= 15) fuzz shapes in both
directions, the 9- and 4-column meta forms, non-ACGTN read bytes,
windows that run into the text padding, the narrow-band certificate
shapes (band 60 narrowed to 15, which must yield -2-c rows), padding
rows, and the wrapper's CPU dispatch."""

import numpy as np
import pytest
import torch

from thermite_tpu.ops.swg_pallas import (
    meta_row,
    nib_lw,
    pack_meta_host,
    pack_reads_nib_host,
    pack_text_nib_host,
)
from thermite_tpu.ops.swg_pallas_packed import (
    get_packed_stream_gather_kernel_split,
)
from thermite_tpu_torch.ops.swg_stream import swg_stream, swg_stream_plain

# The suite runs several xdist workers on a few cores; the plain path's
# small tensor ops gain nothing from intra-op threads and lose much to
# oversubscription.
torch.set_num_threads(1)

BBLK = 8


def _reference(words, reads_nib, meta, XMAX, YMAX, SMAX, seg):
    kern = get_packed_stream_gather_kernel_split(
        BBLK, XMAX, YMAX, SMAX, interpret=True, SEG=seg
    )
    hdr, streams = kern(words, np.int32(len(words)), reads_nib, meta)
    return np.asarray(hdr), np.asarray(streams)


def _port(words, reads_nib, meta, XMAX, YMAX, SMAX, fn=swg_stream_plain):
    hdr, streams = fn(
        torch.from_numpy(words), len(words), torch.from_numpy(reads_nib),
        torch.from_numpy(np.ascontiguousarray(meta)), XMAX, YMAX, SMAX,
    )
    return hdr.numpy(), streams.numpy()


def _assert_same(a, b, meta):
    (ha, sa), (hb, sb) = a, b
    assert ha.shape == hb.shape and sa.shape == sb.shape
    bad = np.flatnonzero((ha != hb).any(1) | (sa != sb).any(1))
    assert len(bad) == 0, (
        f"{len(bad)} rows differ; first {bad[:3]}: meta={meta[bad[0]]} "
        f"ref={ha[bad[0]]} port={hb[bad[0]]}"
    )


def _fuzz_case(seed, seg, n):
    """test_packed_kernel.py's fuzz problems, plus N/$ text bytes and
    non-ACGTN read bytes."""
    rng = np.random.default_rng(seed)
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), 5000)
    text[rng.integers(0, len(text), 20)] = ord("N")
    text[2500] = ord("$")
    RPAD, NR, XMAX, YMAX = 64, 32, 64, 96
    reads = np.zeros((NR, RPAD), np.uint8)
    for i in range(NR):
        p = int(rng.integers(0, len(text) - RPAD))
        r = text[p : p + RPAD].copy()
        for _ in range(int(rng.integers(0, 5))):
            r[int(rng.integers(0, RPAD))] = ord("ACGTNX"[int(rng.integers(0, 6))])
        reads[i] = r
    band_max = (seg - 2) // 2
    rows = []
    for _ in range(n):
        band = int(rng.integers(0, band_max + 1))
        xd = int(rng.integers(1, 40))
        xlen = int(rng.integers(1, XMAX + 1))
        ylen = int(rng.integers(1, YMAX + 1))
        ri = int(rng.integers(0, NR))
        q = int(rng.integers(0, RPAD - 1))
        xdir = 1 if rng.random() < 0.5 else -1
        xlen = min(xlen, RPAD - q) if xdir == 1 else min(xlen, q + 1)
        p = int(rng.integers(0, len(text)))
        ydir = 1 if rng.random() < 0.5 else -1
        if rng.random() < 0.8:  # else the window runs into the padding
            ylen = min(ylen, len(text) - p if ydir == 1 else p + 1)
        rows.append(
            meta_row(p, ydir, max(ylen, 1), ri * RPAD + q, xdir, xlen, band, xd)
        )
    meta = np.asarray(rows, np.int32)
    words = pack_text_nib_host(text)
    assert len(words) == nib_lw(len(text))
    return words, pack_reads_nib_host(reads.reshape(-1)), meta, XMAX, YMAX


@pytest.mark.parametrize("meta_cols", [9, 4])
@pytest.mark.parametrize("seed,seg", [(0, 64), (3, 64), (0, 32), (5, 32)])
def test_plain_matches_pallas_fuzz(seed, seg, meta_cols):
    n = (128 // seg) * BBLK * 2
    words, rnib, meta, XMAX, YMAX = _fuzz_case(seed, seg, n)
    SMAX = 256
    if meta_cols == 4:
        meta = pack_meta_host(meta)
    ref = _reference(words, rnib, meta, XMAX, YMAX, SMAX, seg)
    port = _port(words, rnib, meta, XMAX, YMAX, SMAX)
    _assert_same(ref, port, meta)
    ns = ref[0].view(np.int16)[:, 3]
    assert (ref[0].view(np.int16)[:, 0] != 0).any() and (ns > 0).any()


def _narrow_case(seed, n):
    """test_narrow_band.py's certificate shapes: problems built at band
    60 with >15-band indels on some reads, submitted narrowed to 15."""
    rng = np.random.default_rng(seed)
    WIDE, NARROW = 60, 15
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), 200_000)
    RPAD, NR = 96, 128
    reads = np.zeros((NR, RPAD), np.uint8)
    src = np.zeros(NR, np.int64)
    for i in range(NR):
        p = int(rng.integers(200, len(text) - 400))
        src[i] = p
        r = text[p : p + 90].copy()
        for _ in range(int(rng.integers(0, 4))):
            r[int(rng.integers(0, 90))] = ord(rng.choice(list("ACGT")))
        if i % 8 == 0:
            cut = int(rng.integers(20, 60))
            r = np.concatenate(
                [text[p : p + cut], text[p + cut + 25 : p + cut + 25 + 90 - cut]]
            )
        reads[i, :90] = r[:90]
    meta = np.zeros((n, 9), np.int32)
    for i in range(n):
        xlen = int(rng.integers(1, 91))
        ri = int(rng.integers(0, NR))
        q = int(rng.integers(0, 91 - xlen))
        ylen = min(xlen + WIDE + 1, 200)
        d = 1 if rng.random() < 0.5 else -1
        ybase = int(src[ri]) + q if d == 1 else int(src[ri]) + q + xlen
        meta[i] = meta_row(ybase, d, ylen, ri * RPAD + q, d, xlen, WIDE, WIDE)
    np.minimum(meta[:, 7], NARROW, out=meta[:, 7])
    np.minimum(meta[:, 3], meta[:, 6] + meta[:, 7] + 1, out=meta[:, 3])
    return pack_text_nib_host(text), pack_reads_nib_host(reads.reshape(-1)), meta


@pytest.mark.parametrize("seed", [7, 11])
def test_plain_matches_pallas_narrow_band_certificate(seed):
    words, rnib, meta = _narrow_case(seed, 32)
    XMAX, YMAX, SMAX = 96, 128, 384
    ref = _reference(words, rnib, pack_meta_host(meta), XMAX, YMAX, SMAX, 64)
    port = _port(words, rnib, meta, XMAX, YMAX, SMAX)
    _assert_same(ref, port, meta)
    ns = ref[0].view(np.int16)[:, 3]
    assert (ns <= -2).any(), "indel reads must fail the certificate"
    assert (ns >= 0).any()


def test_plain_matches_pallas_padding_rows():
    """Rows padded as BatchAligner._pad_meta pads (dirs +1, band 1,
    x_drop 1, empty windows) between real problems: all-zero outputs."""
    words, rnib, meta = _narrow_case(3, 10)
    pad = np.zeros((22, 9), np.int32)
    pad[:, 2] = pad[:, 5] = pad[:, 7] = pad[:, 8] = 1
    meta = np.concatenate([meta[:5], pad[:11], meta[5:], pad[11:]])
    XMAX, YMAX, SMAX = 96, 128, 208
    ref = _reference(words, rnib, pack_meta_host(meta), XMAX, YMAX, SMAX, 64)
    port = _port(words, rnib, pack_meta_host(meta), XMAX, YMAX, SMAX)
    _assert_same(ref, port, meta)
    is_pad = meta[:, 3] == 0
    assert (port[0][is_pad] == 0).all() and (port[1][is_pad] == 0).all()


def test_wrapper_cpu_dispatches_to_plain():
    words, rnib, meta, XMAX, YMAX = _fuzz_case(1, 64, 40)
    launches = swg_stream.launches
    a = _port(words, rnib, meta, XMAX, YMAX, 256, fn=swg_stream)
    b = _port(words, rnib, meta, XMAX, YMAX, 256)
    assert (a[0] == b[0]).all() and (a[1] == b[1]).all()
    assert swg_stream.launches == launches  # CPU tensors launch no kernel


def test_wrapper_rejects_bad_inputs():
    words, rnib, meta, XMAX, YMAX = _fuzz_case(2, 64, 8)
    w, r, m = (torch.from_numpy(a) for a in (words, rnib, meta))
    with pytest.raises(TypeError):
        swg_stream(w.to(torch.int64), len(words), r, m, XMAX, YMAX, 256)
    with pytest.raises(ValueError):
        swg_stream(w, len(words), r, m[:, :5].contiguous(), XMAX, YMAX, 256)
    with pytest.raises(ValueError):
        swg_stream(w, len(words), r, m, XMAX, YMAX, 250)
    with pytest.raises(ValueError):
        swg_stream(w, len(words), r, m, XMAX, 600, 256)  # beyond _WPAD
    # bands above 31 are served (by the general kernel on the card)
    wide = m.clone()
    wide[:, 7] = 40
    hdr, _ = swg_stream(w, len(words), r, wide, XMAX, YMAX, 256)
    assert hdr.shape == (len(m), 2)
