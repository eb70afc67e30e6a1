"""Decode on-device traceback output (RLE runs / packed op streams)
into Alignment op lists."""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..align.types import Alignment, Op, xclip
from .layout import RUN_OP_SHIFT

_OP_CHARS = ("M", "S", "D", "I")
_LEN_MASK = (1 << RUN_OP_SHIFT) - 1


def decode_runs_one(
    runs_row: np.ndarray,
    nruns: int,
    score: int,
    max_i: int,
    max_j: int,
    xlen: int,
    ylen: int,
) -> Optional[Alignment]:
    """One pair's runs -> Alignment; None if the device flagged overflow
    (nruns < 0) and the host must recompute via the oracle."""
    if nruns < 0:
        return None
    ops: List[Op] = []
    # runs were emitted in backward walk order
    for k in range(nruns - 1, -1, -1):
        r = int(runs_row[k])
        op = _OP_CHARS[r >> RUN_OP_SHIFT]
        ops.extend([op] * (r & _LEN_MASK))
    if max_i < xlen:
        ops.append(xclip(xlen - max_i))
    return Alignment(
        score=score,
        ystart=0,
        xstart=0,
        yend=max_j,
        xend=max_i,
        ylen=ylen,
        xlen=xlen,
        operations=ops,
    )


def decode_stream_batch(
    out: np.ndarray,
    xlens: np.ndarray,
    ylens: np.ndarray,
) -> List[Optional[Alignment]]:
    """Decode the stream-traceback kernel's fused output rows
    ``[score, max_i, max_j, nsteps, packed...]`` (2-bit DIR codes in
    backward walk order, 16/word little-endian) into Alignments.

    The unpack is vectorized across the batch; per pair only the
    (short) op list is materialised.  Returns None for rows the device
    flagged (nsteps < 0) — host must recompute those.
    """
    N = out.shape[0]
    PW = out.shape[1] - 4
    shifts = 2 * np.arange(16, dtype=np.uint32)
    codes = (
        (out[:, 4:].astype(np.uint32)[:, :, None] >> shifts[None, None, :]) & 3
    ).reshape(N, PW * 16)
    alns: List[Optional[Alignment]] = []
    for k in range(N):
        score, max_i, max_j, n = (int(v) for v in out[k, :4])
        if n <= -2:
            # band-exactness certificate failure, encoded -2 - nsteps:
            # the walk is still exact AT THIS BAND — recover it (this
            # decoder serves callers that ran the original band; the
            # adaptive-narrowing pipeline patches such rows instead)
            n = -2 - n
        if n < 0:
            alns.append(None)
            continue
        fwd = codes[k, :n][::-1]
        ops: List[Op] = []
        if n:
            bnd = np.flatnonzero(np.diff(fwd)) + 1
            prev = 0
            for b in list(bnd) + [n]:
                ops.extend([_OP_CHARS[fwd[prev]]] * (b - prev))
                prev = b
        xlen = int(xlens[k])
        if max_i < xlen:
            ops.append(xclip(xlen - max_i))
        alns.append(
            Alignment(
                score=score,
                ystart=0,
                xstart=0,
                yend=max_j,
                xend=max_i,
                ylen=int(ylens[k]),
                xlen=xlen,
                operations=ops,
            )
        )
    return alns
