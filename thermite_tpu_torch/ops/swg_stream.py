"""Banded SWG extension with on-device traceback: the packed op stream.

``swg_stream`` is the port of the reference's lane-packed Pallas stream
kernel (``thermite_tpu/ops/swg_pallas_packed.py::make_packed_stream_call``
behind ``make_packed_stream_gather_kernel(split=True)``).  Per problem it
gathers the x window from the nibble-packed read block and the y window
from the nibble-packed text, runs banded affine-gap Smith-Waterman-Gotoh
with X-drop, keeps the best score and the first cell that reaches it,
computes the band-exactness certificate, and walks the traceback into
2-bit direction codes (backward order, 16 per int32 word).

Outputs, in meta row order:
  hdr     (N, 2) int32 — int16 halves [score | max_i, max_j | nsteps]
  streams (N, SMAX/16) int32 — packed walk codes
``nsteps`` is the step count, -1 for a bad walk, and -2-c when the
certificate failed (the walk is valid at this band but a wider band
might differ; the batch pipeline recomputes those rows at full band).

For a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/swg_stream.cu``); for a CPU tensor it runs ``swg_stream_plain``,
the plain PyTorch version of the same function, which is also the
referee the card's kernel is held against.
"""

from __future__ import annotations

import ctypes

import torch

from thermite_tpu.constants import (
    GAP_EXTEND,
    GAP_OPEN,
    MATCH_SCORE,
    MIN_SCORE,
    MISMATCH_SCORE,
)

from .layout import (
    DIR_DEL,
    DIR_INS,
    DIR_MATCH,
    DIR_SUBST,
    META_COLS,
    META_PACKED_COLS,
    _PAD,
    _WPAD,
)

BAND_MAX = 31  # 2b+1 <= 63 slots: two band slots per lane of a warp


def meta9(meta: torch.Tensor) -> torch.Tensor:
    """(N, 9) unpacked or (N, 4) packed meta -> canonical (N, 9) int32."""
    if meta.shape[1] == META_COLS:
        return meta
    c0, c1, c2, c3 = (meta[:, k : k + 1] for k in range(META_PACKED_COLS))
    ylen = c2 & 0xFFFF
    xlen = (c2 >> 16) & 0xFFFF
    y_sub = c3 & 7
    y_dir = 1 - 2 * ((c3 >> 3) & 1)
    x_dir = 1 - 2 * ((c3 >> 4) & 1)
    band = (c3 >> 5) & 0x3FF
    xd = (c3 >> 15) & 0xFFF
    return torch.cat([c0, y_sub, y_dir, ylen, c1, x_dir, xlen, band, xd], 1)


def gather_span_nib(words: torch.Tensor, anchor: torch.Tensor,
                    dirp: torch.Tensor, span: int) -> torch.Tensor:
    """(N,) int64 nibble anchors + (N,) dirs -> (N, span) int32 codes.

    Code m of a window is the nibble at position ``anchor + dir*m`` of
    the packed word stream (dir = -1 reads the text reversed, ending at
    the anchor); word indices clamp to the array, as the reference's
    gather does."""
    lw = words.shape[0]
    m = torch.arange(span, device=words.device, dtype=torch.int64)
    pos = anchor[:, None] + dirp[:, None].to(torch.int64) * m[None, :]
    w = words[torch.clamp(pos >> 3, 0, lw - 1)]
    return (w >> (4 * (pos & 7)).to(torch.int32)) & 0xF


def pack_stream_hdr(ms, mi, mj, ns) -> torch.Tensor:
    """(N,) int32 x4 -> (N, 2) int32 with int16 halves
    [score | max_i, max_j | nsteps]."""
    def half(lo, hi):
        v = (lo.to(torch.int64) & 0xFFFF) | ((hi.to(torch.int64) & 0xFFFF) << 16)
        return (v - ((v >> 31) << 32)).to(torch.int32)

    return torch.stack([half(ms, mi), half(mj, ns)], 1)


def _windows(ref_nib, reads_nib, m9, XMAX: int, YMAX: int):
    """(x (N, XMAX), y (N, YMAX)) int32 codes, zero past each length."""
    m = m9.to(torch.int64)
    x_anchor = m[:, 4] + _WPAD
    y_anchor = 8 * m[:, 0] + m[:, 1]
    x = gather_span_nib(reads_nib, x_anchor, m[:, 5], XMAX)
    y = gather_span_nib(ref_nib, y_anchor, m[:, 2], YMAX)
    ix = torch.arange(XMAX, device=x.device)[None, :]
    iy = torch.arange(YMAX, device=y.device)[None, :]
    x = torch.where(ix < m[:, 6:7], x, 0)
    y = torch.where(iy < m[:, 3:4], y, 0)
    return x, y


def _forward_plain(x, y, xlen, ylen, band, xdrop, L: int):
    """Banded DP over L band slots per problem (slot t = row row0 + t of
    column j, row0 = max(j - band, 0)).

    Returns (ms, mi, mj, cert, dirs) with dirs (N, YMAX+1, L) int8."""
    dev = x.device
    N, YMAX = y.shape
    i32 = torch.int32
    e, o, MIN = GAP_EXTEND, GAP_OPEN, MIN_SCORE
    t = torch.arange(L, device=dev, dtype=i32)[None, :]
    b2 = 2 * band[:, None]
    D = torch.where(t == 0, 0, torch.where(t <= b2, t * e + o, MIN)).to(i32)
    C = torch.where(t == 0, 0, MIN).to(i32).expand(N, L).clone()
    dirs = torch.zeros((N, YMAX + 1, L), dtype=torch.int8, device=dev)
    dirs[:, 0] = torch.where(t <= b2, DIR_INS, DIR_MATCH).to(torch.int8)

    # x window read at slot t of column j: x[row0 + t - 1], via a padded
    # copy indexed by row0 + t (zero before x[0] and past the window)
    x_ext = torch.cat(
        [torch.zeros((N, 1), dtype=i32, device=dev), x,
         torch.zeros((N, L + YMAX), dtype=i32, device=dev)], 1,
    )
    zero = torch.zeros(N, dtype=i32, device=dev)
    ms, mi, mj = zero.clone(), zero.clone(), zero.clone()
    stopped = torch.zeros(N, dtype=torch.bool, device=dev)
    cmin = torch.full((N,), 1 << 30, dtype=i32, device=dev)
    e_ladder = o + (band + 1) * e
    ub_final = xlen * MATCH_SCORE + e_ladder
    ecap = ub_final.clone()
    rstop = torch.zeros(N, dtype=torch.bool, device=dev)
    col_min = torch.full((N, 1), MIN, dtype=i32, device=dev)
    pad_col = torch.full((N, 1), _PAD, dtype=i32, device=dev)
    te = t * e
    tz = t == 0

    maxy = min(int(torch.clamp(ylen, max=YMAX).max()) if N else 0, YMAX)
    for j in range(1, maxy + 1):
        in_p1 = (j <= band)[:, None]
        sh = ~in_p1
        active = ((j <= ylen) & ~stopped)[:, None]
        row0 = torch.clamp(j - band, min=0)
        computed = (t <= b2) & (t <= (xlen - row0)[:, None])

        D_l = torch.cat([D[:, 1:], col_min], 1)
        C_l = torch.cat([C[:, 1:], col_min], 1)
        D_r = torch.cat([col_min, D[:, :-1]], 1)
        Dp = torch.where(sh, D_l, D)
        Cp = torch.where(sh, C_l, C)
        Dm = torch.where(sh, D, D_r)

        xs = torch.gather(x_ext, 1, (row0[:, None] + t).to(torch.int64))
        yj = y[:, j - 1 : j]

        c_val = torch.maximum(Cp + e, Dp + e + o)
        c_val = torch.where(sh & (t == b2), MIN, c_val)
        row_is0 = tz & in_p1
        is_match = (xs == yj) & ~row_is0
        d_val = torch.where(
            row_is0, MIN, Dm + torch.where(is_match, MATCH_SCORE, MISMATCH_SCORE)
        )
        A = torch.maximum(d_val, c_val)
        base = torch.where(computed, A, MIN) - te
        # exclusive prefix max over lower slots (the insertion chain)
        pm = torch.cat([pad_col, torch.cummax(base, 1).values[:, :-1]], 1)
        r_val = torch.where(tz, MIN, o + te + pm)
        D_new = torch.maximum(A, r_val)

        mask = computed & active
        D = torch.where(mask, D_new, D).to(i32)
        C = torch.where(mask, c_val, C).to(i32)
        dir_new = torch.where(
            D_new == d_val,
            torch.where(is_match, DIR_MATCH, DIR_SUBST),
            torch.where(D_new == c_val, DIR_DEL, DIR_INS),
        )
        dirs[:, j] = torch.where(mask, dir_new, DIR_MATCH).to(torch.int8)

        D_for_max = torch.where(mask, D_new, MIN)
        band_max = D_for_max.max(1).values
        col_arg = torch.where(D_for_max == band_max[:, None], t, L).min(1).values
        act = active[:, 0]
        improved = act & (band_max > ms)
        ms = torch.where(improved, band_max, ms)
        mi = torch.where(improved, row0 + col_arg, mi)
        mj = torch.where(improved, j, mj)

        dropped = band_max < ms - xdrop
        stopped = stopped | (act & dropped)
        ej = torch.clamp(xlen, max=j) * MATCH_SCORE + e_ladder
        cmin = torch.where(act & ~dropped, torch.minimum(cmin, band_max - ej), cmin)
        # a real x-drop (computed cells fell x_drop below the running
        # max), not band exhaustion past row xlen
        real_drop = act & dropped & (band_max > MIN)
        ecap = torch.where(real_drop, ej, ecap)
        rstop = rstop | real_drop

    cert_ub = torch.where(rstop, ecap + xdrop, ub_final)
    cert = (cmin > -xdrop) & (ms > cert_ub)
    return ms.to(i32), mi.to(i32), mj.to(i32), cert, dirs


def _walk_plain(dirs, mi, mj, band, SMAX: int):
    """Per-problem traceback from (mi, mj) -> (nsteps c, bad, streams).

    A step reads the direction at slot clip(i - row0, 0, 2b) of column
    j, emits its 2-bit code at step c (word c // 16, bits 2*(c % 16)),
    and moves: M/S consume x and y, I consumes x, D consumes y.  A walk
    stops at the origin or after SMAX + 1 steps (then flagged bad)."""
    dev = dirs.device
    N = dirs.shape[0]
    PW = SMAX // 16
    i, j = mi.to(torch.int64), mj.to(torch.int64)
    c = torch.zeros(N, dtype=torch.int64, device=dev)
    band = band.to(torch.int64)
    rows = torch.arange(N, device=dev)
    words = torch.zeros(N * PW + 1, dtype=torch.int64, device=dev)
    for _ in range(SMAX + 1):
        step = ((i > 0) | (j > 0)) & (c <= SMAX)
        row0 = torch.clamp(j - band, min=0)
        bi = torch.minimum(torch.clamp(i - row0, min=0), 2 * band)
        d = dirs[rows, torch.clamp(j, min=0), bi].to(torch.int64)
        put = step & (c < 16 * PW)
        # every (step, bit) lands once, so accumulating == OR; steps that
        # write nothing go to the spare last element
        widx = torch.where(put, rows * PW + (c >> 4), N * PW)
        words.index_put_((widx,), torch.where(put, d << (2 * (c & 15)), 0),
                         accumulate=True)
        cx = (d <= DIR_SUBST) | (d == DIR_INS)
        cy = (d <= DIR_SUBST) | (d == DIR_DEL)
        i = torch.where(step & cx, i - 1, i)
        j = torch.where(step & cy, j - 1, j)
        c = torch.where(step, c + 1, c)
    bad = (i > 0) | (j > 0) | (c > SMAX)
    w = words[: N * PW].reshape(N, PW)
    streams = (w - ((w >> 31) << 32)).to(torch.int32)
    return c.to(torch.int32), bad, streams


def swg_stream_plain(ref_nib, ref_lw, reads_nib, meta, XMAX: int, YMAX: int,
                     SMAX: int):
    """Plain PyTorch version of the stream kernel, vectorized over
    problems with one tensor dimension for band slots.  Same arguments
    and outputs as ``swg_stream``; runs on any device."""
    _check(ref_nib, ref_lw, reads_nib, meta, XMAX, YMAX, SMAX)
    m9 = meta9(meta)
    x, y = _windows(ref_nib[:ref_lw], reads_nib, m9, XMAX, YMAX)
    xlen, ylen, band, xdrop = (m9[:, k] for k in (6, 3, 7, 8))
    bmax = int(band.max()) if len(band) else 0
    if bmax > BAND_MAX:
        raise ValueError(f"band {bmax} > {BAND_MAX}: the stream kernel "
                         "serves bands up to 31")
    L = 32 if bmax <= 15 else 64
    ms, mi, mj, cert, dirs = _forward_plain(x, y, xlen, ylen, band, xdrop, L)
    c, bad, streams = _walk_plain(dirs, mi, mj, band, SMAX)
    ns = torch.where(bad, -1, torch.where(cert, c, -2 - c)).to(torch.int32)
    return pack_stream_hdr(ms, mi, mj, ns), streams


def _check(ref_nib, ref_lw, reads_nib, meta, XMAX, YMAX, SMAX) -> None:
    for name, tns in (("ref_nib", ref_nib), ("reads_nib", reads_nib),
                      ("meta", meta)):
        if tns.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {tns.dtype}")
        if not tns.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if tns.device != meta.device:
            raise ValueError(f"{name} is on {tns.device}, meta on {meta.device}")
    if ref_nib.dim() != 1 or reads_nib.dim() != 1:
        raise ValueError("ref_nib and reads_nib must be 1-D nibble words")
    if not 0 < int(ref_lw) <= ref_nib.shape[0] or reads_nib.shape[0] == 0:
        raise ValueError("ref_lw must be in (0, len(ref_nib)]; reads non-empty")
    if meta.dim() != 2 or meta.shape[1] not in (META_COLS, META_PACKED_COLS):
        raise ValueError(f"meta must be (N, 9) or (N, 4), got {tuple(meta.shape)}")
    if not (0 < XMAX <= _WPAD and 0 < YMAX <= _WPAD):
        raise ValueError(f"window ({XMAX}, {YMAX}) exceeds the padding {_WPAD}")
    if SMAX <= 0 or SMAX % 16:
        raise ValueError(f"SMAX must be a positive multiple of 16, got {SMAX}")


def swg_stream(ref_nib, ref_lw, reads_nib, meta, XMAX: int, YMAX: int,
               SMAX: int):
    """(ref_nib (Lw,) i32, ref_lw, reads_nib (Lr,) i32, meta (N, 4|9) i32)
    -> (hdr (N, 2) i32, streams (N, SMAX/16) i32).

    Every problem needs band <= 31, xlen <= XMAX; y columns past YMAX are
    not computed.  CUDA tensors launch the kernel on the current stream
    (no synchronisation); CPU tensors run ``swg_stream_plain``."""
    if meta.device.type != "cuda":
        return swg_stream_plain(ref_nib, ref_lw, reads_nib, meta, XMAX,
                                YMAX, SMAX)
    _check(ref_nib, ref_lw, reads_nib, meta, XMAX, YMAX, SMAX)
    from ._build import kernel_lib

    lib = kernel_lib()
    N = meta.shape[0]
    hdr = torch.empty((N, 2), dtype=torch.int32, device=meta.device)
    streams = torch.empty((N, SMAX // 16), dtype=torch.int32,
                          device=meta.device)
    if N == 0:
        return hdr, streams
    err = lib.thermite_swg_stream_launch(
        ctypes.c_void_p(ref_nib.data_ptr()), ctypes.c_int64(int(ref_lw)),
        ctypes.c_void_p(reads_nib.data_ptr()),
        ctypes.c_int64(reads_nib.shape[0]),
        ctypes.c_void_p(meta.data_ptr()), meta.shape[1], ctypes.c_int64(N),
        XMAX, YMAX, SMAX,
        ctypes.c_void_p(hdr.data_ptr()), ctypes.c_void_p(streams.data_ptr()),
        ctypes.c_void_p(torch.cuda.current_stream(meta.device).cuda_stream),
    )
    if err != 0:
        raise RuntimeError(f"swg_stream kernel launch failed: cudaError {err}")
    swg_stream.launches += 1
    return hdr, streams


swg_stream.launches = 0
