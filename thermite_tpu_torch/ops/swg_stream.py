"""Banded SWG extension with on-device traceback: the packed op stream.

``swg_stream`` is the port of the reference's two Pallas stream kernels:
the lane-packed one for bands up to 31
(``thermite_tpu/ops/swg_pallas_packed.py::make_packed_stream_call``) and
the general one for any band (``thermite_tpu/ops/swg_pallas.py::
make_stream_traceback_kernel``), which give the same rows.  Per problem
it gathers the x window from the nibble-packed read block and the y
window from the nibble-packed text, runs banded affine-gap
Smith-Waterman-Gotoh with X-drop, keeps the best score and the first
cell that reaches it, computes the band-exactness certificate, and walks
the traceback into 2-bit direction codes (backward order, 16 per int32
word).

Outputs, in meta row order, in the split form:
  hdr     (N, 2) int32 — int16 halves [score | max_i, max_j | nsteps]
  streams (N, SMAX/16) int32 — packed walk codes
or, with ``fused=True``, the reference's fused rows (N, 4 + SMAX/16):
the int32 header [score, max_i, max_j, nsteps], then the streams.
``nsteps`` is the step count, -1 for a bad walk, and -2-c when the
certificate failed (the walk is valid at this band but a wider band
might differ; the batch pipeline recomputes those rows at full band).

For a CUDA tensor the wrappers launch the hand-written kernel of
``csrc/swg_stream.cu``, one launch for any band: ``swg_stream`` counts
the launches at bands up to 31 in ``swg_stream.launches``, and routes
wider bands through ``swg_stream_wide``, which counts them in its own.
Problems run as sub-warp groups (``stream_group``): 8 lanes x 4 band
slots at band <= 15, four problems a warp.  For a CPU tensor both run
``swg_stream_plain``, the plain PyTorch version of the same function,
which is also the referee the card's kernel is held against.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..constants import (
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

PACKED_BAND_MAX = 31  # the reference's packed stream kernel: bands up to 31

# Group shapes (lanes a problem, band slots a lane) of the stream kernels,
# in the order a launch tries them (``stream_group`` in csrc/swg_stream.cuh).
STREAM_GROUPS = ((8, 4), (16, 4), (32, 4), (32, 8), (32, 16), (32, 32))


def slots_needed(band_max: int, XMAX: int) -> int:
    """Band slots a launch must hold: min(2*band_max + 1, XMAX + 1).
    Slots past 2b are never computed, nor are slots past row xlen <= XMAX,
    and neither is read by a computed slot or by the walk, so the DP of
    every problem with xlen <= XMAX is the same at any wider slot count
    (the reference computes W = roundup(2b+1, 128) lanes)."""
    return min(2 * band_max + 1, XMAX + 1)


def slots_per_lane(band_max: int, XMAX: int) -> int:
    """Band slots per lane at 32 lanes a problem: the fewest (a power of
    two, at most 32) whose 32*SLOTS slots cover ``slots_needed``.  The
    span of the plain versions, and above 4 the shape of a launch of the
    forward and run-length traceback kernels.  Same rule as ``slots_for``
    in csrc/swg_stream.cuh."""
    need = slots_needed(band_max, XMAX)
    s = 1
    while 32 * s < need:
        s *= 2
    if s > 32:
        raise ValueError(f"no slot class covers {need} slots (XMAX {XMAX})")
    return s


def stream_group(band_max: int, XMAX: int):
    """(lanes, slots) of a stream-kernel launch: a problem takes ``lanes``
    lanes of a warp with ``slots`` band slots each, and a warp carries
    32 // lanes problems.  The first shape of ``STREAM_GROUPS`` that covers
    ``slots_needed``.  Same rule as ``stream_group`` in
    csrc/swg_stream.cuh."""
    need = slots_needed(band_max, XMAX)
    for g in STREAM_GROUPS:
        if g[0] * g[1] >= need:
            return g
    raise ValueError(f"no group shape covers {need} slots (XMAX {XMAX})")


# The forward and run-length traceback kernels choose the group shape per
# warp where 32 lanes x ROWS_SLOTS slots cover the launch: a warp owns
# ROWS_PER_WARP consecutive rows (csrc/swg_stream.cuh).
ROWS_PER_WARP = 4
ROWS_SLOTS = 4


def rows_launch(band_max: int, XMAX: int) -> bool:
    """Whether a launch of the forward or run-length traceback kernel is
    of the per-warp family (``rows_launch`` in csrc/swg_stream.cuh)."""
    return slots_needed(band_max, XMAX) <= 32 * ROWS_SLOTS


def warp_lanes(band, xlen):
    """Lanes a problem (8, 16 or 32, ROWS_SLOTS slots each) that each warp
    of a per-warp launch takes for its rows: (N,) integer arrays of the
    rows' bands and xlens in launch order -> (ceil(N / ROWS_PER_WARP),)
    numpy array.  The narrowest shape that covers the largest
    min(2*band + 1, xlen + 1) among the warp's rows; same rule as
    ``warp_lanes`` in csrc/swg_stream.cuh."""
    need = np.minimum(2 * np.asarray(band, np.int64) + 1,
                      np.asarray(xlen, np.int64) + 1)
    need = np.concatenate([need, np.ones(-len(need) % ROWS_PER_WARP, np.int64)])
    need = np.maximum(need.reshape(-1, ROWS_PER_WARP).max(1), 1)
    return np.where(need <= 8 * ROWS_SLOTS, 8,
                    np.where(need <= 16 * ROWS_SLOTS, 16, 32))


def dir_bytes(slots: int) -> int:
    """Bytes in which a lane stores the 2-bit directions of its slots of
    one column (``dir_bytes`` in csrc/swg_stream.cuh)."""
    return 1 if slots <= 4 else 2 if slots <= 8 else 4 if slots <= 16 else 8


def problem_smem_words(XMAX: int, YMAX: int, pw: int, lanes: int,
                       slots: int) -> int:
    """Shared memory of one problem in 32-bit words (``problem_smem_words``
    in csrc/swg_stream.cuh): direction planes, ``pw`` words of walk
    output, the x codes (padded by a zero at each end) and the y codes as
    bytes; a multiple of two."""
    plane = ((YMAX + 1) * lanes * dir_bytes(slots) + 3) // 4
    w = plane + pw + (XMAX + 2 + 3) // 4 + (YMAX + 3) // 4
    return (w + 1) & ~1


def stream_slots(band_max: int, XMAX: int) -> int:
    """Band slots of the plain version, in units of 32: any span that
    covers ``slots_needed`` gives the same rows."""
    s = slots_per_lane(band_max, XMAX)
    return s if band_max <= PACKED_BAND_MAX else max(s, 4)


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


def _forward_plain(x, y, xlen, ylen, band, xdrop, L: int, want_dirs=True,
                   work=None):
    """Banded DP over L band slots per problem (slot t = row row0 + t of
    column j, row0 = max(j - band, 0)).

    Returns (ms, mi, mj, cert, dirs) with dirs (N, YMAX+1, L) int8, or
    None without ``want_dirs``.  ``work``, a dict, receives the work this
    data needs: ``cols`` (N,) the columns computed before each problem
    ended (ylen reached, or X-drop) and ``cells`` (N,) the band cells
    computed in them."""
    dev = x.device
    N, YMAX = y.shape
    i32 = torch.int32
    e, o, MIN = GAP_EXTEND, GAP_OPEN, MIN_SCORE
    t = torch.arange(L, device=dev, dtype=i32)[None, :]
    b2 = 2 * band[:, None]
    D = torch.where(t == 0, 0, torch.where(t <= b2, t * e + o, MIN)).to(i32)
    C = torch.where(t == 0, 0, MIN).to(i32).expand(N, L).clone()
    dirs = None
    if want_dirs:
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

    if work is not None:
        work["cols"] = torch.zeros(N, dtype=torch.int64, device=dev)
        work["cells"] = torch.zeros(N, dtype=torch.int64, device=dev)
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
        if work is not None:
            work["cols"] += active[:, 0]
            work["cells"] += mask.sum(1)
        D = torch.where(mask, D_new, D).to(i32)
        C = torch.where(mask, c_val, C).to(i32)
        if want_dirs:
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
                     SMAX: int, fused: bool = False):
    """Plain PyTorch version of the stream kernels, vectorized over
    problems with one tensor dimension for band slots.  Same arguments
    and outputs as ``swg_stream``; runs on any device."""
    _check(ref_nib, ref_lw, reads_nib, meta, XMAX, YMAX, SMAX)
    m9 = meta9(meta)
    x, y = _windows(ref_nib[:ref_lw], reads_nib, m9, XMAX, YMAX)
    xlen, ylen, band, xdrop = (m9[:, k] for k in (6, 3, 7, 8))
    bmax = int(band.max()) if len(band) else 0
    L = 32 * stream_slots(bmax, XMAX)
    ms, mi, mj, cert, dirs = _forward_plain(x, y, xlen, ylen, band, xdrop, L)
    c, bad, streams = _walk_plain(dirs, mi, mj, band, SMAX)
    ns = torch.where(bad, -1, torch.where(cert, c, -2 - c)).to(torch.int32)
    if fused:
        return torch.cat([torch.stack([ms, mi, mj, ns], 1), streams], 1)
    return pack_stream_hdr(ms, mi, mj, ns), streams


def dp_work_plain(ref_nib, ref_lw, reads_nib, meta, XMAX: int, YMAX: int):
    """The work the DP of these problems needs, counted by the plain
    forward pass: (cols (N,), cells (N,)) int64, the columns computed
    until each problem ended and the band cells computed in them.  A
    kernel's operation bound is cells x the recurrence's operations."""
    _check(ref_nib, ref_lw, reads_nib, meta, XMAX, YMAX)
    m9 = meta9(meta)
    x, y = _windows(ref_nib[:ref_lw], reads_nib, m9, XMAX, YMAX)
    xlen, ylen, band, xdrop = (m9[:, k] for k in (6, 3, 7, 8))
    bmax = int(band.max()) if len(band) else 0
    work: dict = {}
    _forward_plain(x, y, xlen, ylen, band, xdrop,
                   32 * slots_per_lane(bmax, XMAX), want_dirs=False, work=work)
    return work["cols"], work["cells"]


def _check(ref_nib, ref_lw, reads_nib, meta, XMAX, YMAX, SMAX=16) -> None:
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


def band_max_of(meta: torch.Tensor, band_max) -> int:
    """The launch's band bound: ``band_max`` when the caller knows it
    (the batch pipeline does, from its host meta), else the largest band
    in ``meta`` (a device-to-host read)."""
    if band_max is not None:
        return int(band_max)
    return int(meta9(meta)[:, 7].max()) if meta.shape[0] else 0


def raise_for_launch(err: int, what: str) -> None:
    if err < 0:
        raise ValueError(f"{what}: shape not taken by the kernel "
                         "(shared memory or slot class)")
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def _launch_args(ref_nib, ref_lw, reads_nib, meta):
    return (ctypes.c_void_p(ref_nib.data_ptr()), ctypes.c_int64(int(ref_lw)),
            ctypes.c_void_p(reads_nib.data_ptr()),
            ctypes.c_int64(reads_nib.shape[0]),
            ctypes.c_void_p(meta.data_ptr()), meta.shape[1],
            ctypes.c_int64(meta.shape[0]))


def _current_stream(meta):
    return ctypes.c_void_p(torch.cuda.current_stream(meta.device).cuda_stream)


def on_device_of(meta):
    """The context every launch runs in: ``meta``'s device made current.
    The C launch functions act on the current device (the kernel's
    shared-memory attribute is set on it, and its stream must belong to
    it), which need not be the device of the tensors."""
    return torch.cuda.device(meta.device)


def _launch(counter, ref_nib, ref_lw, reads_nib, meta, XMAX, YMAX, SMAX,
            band_max: int):
    """Launch the stream kernel on the current stream and add one to
    ``counter.launches``; -> (hdr, streams)."""
    from ._build import kernel_lib

    N = meta.shape[0]
    hdr = torch.empty((N, 2), dtype=torch.int32, device=meta.device)
    streams = torch.empty((N, SMAX // 16), dtype=torch.int32,
                          device=meta.device)
    if N:
        with on_device_of(meta):
            err = kernel_lib("swg_stream").thermite_swg_stream_launch(
                *_launch_args(ref_nib, ref_lw, reads_nib, meta),
                XMAX, YMAX, SMAX, int(band_max),
                ctypes.c_void_p(hdr.data_ptr()),
                ctypes.c_void_p(streams.data_ptr()), _current_stream(meta),
            )
        raise_for_launch(err, counter.__name__)
        counter.launches += 1
    return hdr, streams


def fuse_rows(hdr: torch.Tensor, streams: torch.Tensor) -> torch.Tensor:
    """Split outputs -> the fused (N, 4 + SMAX/16) rows: the int16 header
    halves sign-extended to the int32 header, then the streams."""
    hdr4 = hdr.view(torch.int16).to(torch.int32).reshape(-1, 4)
    return torch.cat([hdr4, streams], 1)


def swg_stream(ref_nib, ref_lw, reads_nib, meta, XMAX: int, YMAX: int,
               SMAX: int, band_max=None, fused: bool = False):
    """(ref_nib (Lw,) i32, ref_lw, reads_nib (Lr,) i32, meta (N, 4|9) i32)
    -> (hdr (N, 2) i32, streams (N, SMAX/16) i32), or the fused
    (N, 4 + SMAX/16) rows.

    Every problem needs xlen <= XMAX; y columns past YMAX are not
    computed.  ``band_max`` bounds every band of ``meta`` (read from it
    when not given).  CUDA tensors launch the kernel on the current stream
    (no synchronisation), counted here at bands up to 31 and in
    ``swg_stream_wide`` above; CPU tensors run ``swg_stream_plain``."""
    if meta.device.type != "cuda":
        return swg_stream_plain(ref_nib, ref_lw, reads_nib, meta, XMAX,
                                YMAX, SMAX, fused)
    _check(ref_nib, ref_lw, reads_nib, meta, XMAX, YMAX, SMAX)
    bmax = band_max_of(meta, band_max)
    wrapper = swg_stream_wide if bmax > PACKED_BAND_MAX else swg_stream
    hdr, streams = _launch(wrapper, ref_nib, ref_lw, reads_nib, meta, XMAX,
                           YMAX, SMAX, bmax)
    return fuse_rows(hdr, streams) if fused else (hdr, streams)


swg_stream.launches = 0


def swg_stream_wide(ref_nib, ref_lw, reads_nib, meta, XMAX: int, YMAX: int,
                    SMAX: int, band_max: int):
    """The stream kernel counted as the general-band one (the reference's
    ``make_stream_traceback_kernel``), split outputs as ``swg_stream``:
    for any band, in the group shape ``stream_group(band_max, XMAX)``.
    ``swg_stream`` counts bands above 31 here.  CPU tensors run
    ``swg_stream_plain``."""
    if meta.device.type != "cuda":
        return swg_stream_plain(ref_nib, ref_lw, reads_nib, meta, XMAX,
                                YMAX, SMAX)
    _check(ref_nib, ref_lw, reads_nib, meta, XMAX, YMAX, SMAX)
    return _launch(swg_stream_wide, ref_nib, ref_lw, reads_nib, meta, XMAX,
                   YMAX, SMAX, band_max)


swg_stream_wide.launches = 0
