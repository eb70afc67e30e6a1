"""The port's JAX-free layout module equals the reference's constants and
packers (thermite_tpu/ops/swg_pallas.py) on random inputs, non-ACGTN
bytes included, so reference host code can run against either."""

import numpy as np
import pytest

from thermite_tpu.ops import swg_pallas as ref
from thermite_tpu_torch.ops import layout

CONSTANTS = [
    "DIR_MATCH", "DIR_SUBST", "DIR_DEL", "DIR_INS", "_PAD", "RUN_OP_SHIFT",
    "META_COLS", "META_PACKED_COLS", "_WPAD",
]


@pytest.mark.parametrize("name", CONSTANTS)
def test_constants_equal(name):
    assert getattr(layout, name) == getattr(ref, name)


def test_luts_equal():
    assert (layout._NIB_LUT == ref._NIB_LUT).all()
    assert (layout._READ_NIB_LUT == ref._READ_NIB_LUT).all()


def _bytes(rng, n):
    # mostly ACGTN$, with lowercase, pad zeros and arbitrary bytes mixed in
    pool = np.frombuffer(b"ACGTN$acgtRY\x00", np.uint8)
    out = rng.choice(pool, n)
    wild = rng.random(n) < 0.05
    out[wild] = rng.integers(0, 256, int(wild.sum()))
    return out.astype(np.uint8)


@pytest.mark.parametrize("seed,n", [(0, 1), (1, 7), (2, 1000), (3, 4099),
                                    (4, 100003)])
def test_nibble_packers_equal(seed, n):
    rng = np.random.default_rng(seed)
    text = _bytes(rng, n)
    assert layout.nib_lw(n) == ref.nib_lw(n)
    a = layout.pack_text_nib_host(text)
    assert a.dtype == np.int32 and (a == ref.pack_text_nib_host(text)).all()
    b = layout.pack_reads_nib_host(text)
    assert (b == ref.pack_reads_nib_host(text)).all()
    chunks = list(layout.iter_text_nib_words(text, chunk_words=64))
    ref_chunks = list(ref.iter_text_nib_words(text, chunk_words=64))
    assert len(chunks) == len(ref_chunks)
    assert all((x == y).all() for x, y in zip(chunks, ref_chunks))
    assert (np.concatenate(chunks) == a).all()


def _meta(rng, n):
    rows = [
        layout.meta_row(
            int(rng.integers(0, 1 << 20)), int(rng.choice([-1, 1])),
            int(rng.integers(0, 300)), int(rng.integers(0, 1 << 20)),
            int(rng.choice([-1, 1])), int(rng.integers(0, 200)),
            int(rng.integers(0, 64)), int(rng.integers(0, 100)),
        )
        for _ in range(n)
    ]
    return np.asarray(rows, np.int32)


def test_meta_row_and_pack_equal():
    rng = np.random.default_rng(5)
    args = (1234, -1, 90, 777, 1, 60, 15, 60)
    assert layout.meta_row(*args) == ref.meta_row(*args)
    meta = _meta(rng, 500)
    assert (layout.pack_meta_host(meta) == ref.pack_meta_host(meta)).all()
    big = meta.copy()
    big[0, 7] = 0x400  # band past the packed range
    for mod in (layout, ref):
        with pytest.raises(ValueError):
            mod.pack_meta_host(big)


def test_smax_and_header_expand_equal():
    for xm, ym in [(64, 96), (96, 128), (1, 1), (300, 500)]:
        assert layout.smax_for(xm, ym) == ref.smax_for(xm, ym)
    rng = np.random.default_rng(9)
    hdr = rng.integers(-(1 << 31), 1 << 31, (257, 2), dtype=np.int64)
    hdr = hdr.astype(np.int32)
    assert (layout.expand_stream_hdr(hdr) == ref.expand_stream_hdr(hdr)).all()
