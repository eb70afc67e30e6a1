"""Host-side data layouts of the banded SWG stream kernel, without JAX.

These are the constants and numpy packers that the reference keeps in
``thermite_tpu/ops/swg_pallas.py`` beside its Pallas kernels: direction
codes, the problem meta format, the nibble-packed text and read blocks,
and the packed stream header.  Values are equal to the reference's
(pinned by tests/test_torch_layout.py); the port's host code (index
save/load, the C++ engine bindings, the stream decoder) and its kernel
wrappers import them from here.
"""

from __future__ import annotations

import numpy as np

DIR_MATCH = 0
DIR_SUBST = 1
DIR_DEL = 2
DIR_INS = 3

_PAD = -(1 << 31) + (1 << 21)

# run encoding: (op << 28) | length
RUN_OP_SHIFT = 28

# Problem meta columns: [y_word, y_sub, y_dir, ylen, x_base, x_dir,
# xlen, band, x_drop].  The y anchor is split into (word, sub) of the
# nibble-packed text: anchor byte = 8*y_word + y_sub = text pos + _WPAD.
META_COLS = 9

# packed upload form: 4 int32 cols [y_word, x_base,
#   ylen | xlen<<16,  y_sub | ydir_neg<<3 | xdir_neg<<4 | band<<5 | xd<<15]
META_PACKED_COLS = 4

# zero bytes padding both ends of the nibble-packed text and read block,
# so reversed windows near position 0 never index out of range
_WPAD = 512

# 4-bit text codes: 0 = padding, A/C/G/T/N/$ = 1..6, anything else = 7.
_NIB_LUT = np.full(256, 7, np.uint8)
_NIB_LUT[0] = 0
for _i, _b in enumerate(b"ACGTN$"):
    _NIB_LUT[_b] = _i + 1

# 4-bit read codes: A..N = 1..5, pad 0 -> 0, anything else 15 (never
# equal to a text code, so a non-ACGTN read byte never matches)
_READ_NIB_LUT = np.full(256, 15, np.uint8)
_READ_NIB_LUT[0] = 0
for _i, _b in enumerate(b"ACGTN"):
    _READ_NIB_LUT[_b] = _i + 1


def smax_for(XMAX: int, YMAX: int) -> int:
    """Step capacity of the stream-traceback walk (padded to lanes)."""
    s = XMAX + YMAX + 2
    return ((s + 127) // 128) * 128


def pack_meta_host(meta: np.ndarray) -> np.ndarray:
    """(N, 9) int32 problem meta -> (N, 4) packed upload form."""
    m = meta
    assert m.shape[1] == META_COLS
    ylen, xlen = m[:, 3], m[:, 6]
    band, xd = m[:, 7], m[:, 8]
    if len(m) and (
        int(ylen.max(initial=0)) > 0xFFFF or int(xlen.max(initial=0)) > 0xFFFF
        or int(band.max(initial=0)) > 0x3FF or int(xd.max(initial=0)) > 0xFFF
    ):
        raise ValueError("meta fields exceed packed-form ranges")
    c2 = ylen | (xlen << 16)
    c3 = (
        m[:, 1]
        | ((m[:, 2] < 0).astype(np.int32) << 3)
        | ((m[:, 5] < 0).astype(np.int32) << 4)
        | (band << 5)
        | (xd << 15)
    )
    return np.stack([m[:, 0], m[:, 4], c2, c3], axis=1).astype(np.int32)


def meta_row(y_base, y_dir, ylen, x_base, x_dir, xlen, band, x_drop):
    """Build one META_COLS row from a byte-coordinate y anchor."""
    lo = y_base + _WPAD
    return (lo >> 3, lo & 7, y_dir, ylen, x_base, x_dir, xlen, band, x_drop)


def nib_lw(L: int) -> int:
    """Word count of the nibble-packed text for L bytes."""
    return (_WPAD + L + _WPAD + 7) // 8


def _nib_chunks(src: np.ndarray, lut: np.ndarray, chunk_words: int):
    """Yield the nibble words of ``[0]*_WPAD + src + [0]*pad`` through
    ``lut``, ``chunk_words`` words at a time (the transients stay at one
    chunk, not at the eight-fold padded text)."""
    L = int(src.shape[0])
    Lw = nib_lw(L)
    for a in range(0, Lw, chunk_words):
        b = min(a + chunk_words, Lw)
        codes = np.zeros((b - a) * 8, np.uint8)  # padding is code 0
        lo = 8 * a - _WPAD  # source position of the chunk's first code
        s = max(lo, 0)
        e = min(8 * b - _WPAD, L)
        if e > s:
            codes[s - lo : e - lo] = lut[src[s:e]]
        # two codes a byte, low nibble first: four bytes are one word
        # with code i at bits 4i (little-endian)
        yield (codes[0::2] | (codes[1::2] << 4)).view("<i4")


def _pack_nib(src: np.ndarray, lut: np.ndarray) -> np.ndarray:
    out = np.empty(nib_lw(int(src.shape[0])), np.int32)
    a = 0
    for chunk in _nib_chunks(src, lut, 1 << 26):
        out[a : a + len(chunk)] = chunk
        a += len(chunk)
    return out


def pack_text_nib_host(text_u8: np.ndarray) -> np.ndarray:
    """(L,) uint8 ASCII -> (nib_lw(L),) int32.

    Word w holds codes of text_padded[8w .. 8w+7], 4 bits each,
    little-endian (code i at bits 4i..4i+3), where
    text_padded = [0]*_WPAD + text + [0]*pad."""
    return _pack_nib(text_u8, _NIB_LUT)


def iter_text_nib_words(text_u8: np.ndarray, chunk_words: int = 1 << 26):
    """Yield ``pack_text_nib_host(text_u8)`` in int32 chunks (the
    streaming form that persists a genome-scale packed text)."""
    return _nib_chunks(text_u8, _NIB_LUT, chunk_words)


def pack_reads_nib_host(reads_u8: np.ndarray) -> np.ndarray:
    """Nibble pack of the (rows*RPAD,) flattened read block, same word
    layout as ``pack_text_nib_host`` but through the read code LUT."""
    return _pack_nib(reads_u8, _READ_NIB_LUT)


def expand_stream_hdr(sub2: np.ndarray) -> np.ndarray:
    """(n, 2) int32 packed headers -> (n, 4) int32 (sign-extended)."""
    return (
        np.ascontiguousarray(sub2).view(np.int16).astype(np.int32)
    ).reshape(len(sub2), 4)
