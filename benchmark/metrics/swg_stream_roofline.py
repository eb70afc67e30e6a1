"""%: the stream kernels' share of their roofline in the traced
sub-window: the least time the H100 could take for the launches' work,
over the time the profiler saw the kernels run.

Work (what any implementation has to compute, whatever its padding):
the band cells a plain banded DP computes for the real rows of each
launch, as the program's plain version (``swg_stream_plain``) clips them:
in column j = 1 .. min(ylen, YMAX) of a row, the slots t = 0 .. 2*band
with t <= xlen - max(j - band, 0).  Padding rows (ylen 0) add nothing;
X-drop stops are not taken off (the count is of the band, not of the
data), so a kernel that stops early reads a little high.

Operation bound: 132 SMs x 64 INT32 lanes x 1.98 GHz (H100 SXM5 boost)
= 16.73e12 lane operations a second; twice that with the paired 16-bit
forms (``__viaddmax_s16x2`` and kin), over the 3 fused add-max
operations a Gotoh cell needs at the least (E, F, H): 11.15e12 cells a
second, a rate no implementation of the recurrence can pass on this
card at its full power limit of 700 W (``nvidia-smi --query-gpu=
power.limit`` read 700.00 W beside every measurement recorded in
PERF.md; a card set lower runs slower).

Bytes bound: per real row, its text window (ylen nibbles) and read
(xlen nibbles) and its 16-byte packed meta read once, its 8-byte header
and its SMAX/16 stream words written once, over 3.35e12 bytes a second.
It comes to a few microseconds a launch, so the operations bound the
kernel; the larger of the two is taken.

The meta layout is a frozen copy of the program's (``ops/layout.py``):
9 int32 columns [y_word, y_sub, y_dir, ylen, x_base, x_dir, xlen, band,
x_drop], or the 4-column packed upload form.
"""

from __future__ import annotations

import numpy as np

SMS, LANES, CLOCK_HZ = 132, 64, 1.98e9
OPS_PER_CELL = 3
PEAK_CELLS_S = SMS * LANES * CLOCK_HZ * 2 / OPS_PER_CELL
PEAK_BYTES_S = 3.35e12


def meta9(meta: np.ndarray) -> np.ndarray:
    """(N, 9) or packed (N, 4) int32 meta -> (N, 9) int64."""
    m = np.asarray(meta).astype(np.int64)
    if m.shape[1] == 9:
        return m
    c0, c1, c2, c3 = (m[:, k] for k in range(4))
    out = np.zeros((len(m), 9), np.int64)
    out[:, 0] = c0
    out[:, 1] = c3 & 7
    out[:, 2] = 1 - 2 * ((c3 >> 3) & 1)
    out[:, 3] = c2 & 0xFFFF
    out[:, 4] = c1
    out[:, 5] = 1 - 2 * ((c3 >> 4) & 1)
    out[:, 6] = (c2 >> 16) & 0xFFFF
    out[:, 7] = (c3 >> 5) & 0x3FF
    out[:, 8] = (c3 >> 15) & 0xFFF
    return out


def band_cells(meta: np.ndarray, YMAX: int) -> int:
    """Band cells of the rows of ``meta`` (see the module's docstring)."""
    m = meta9(meta)
    ylen = np.minimum(m[:, 3], YMAX)
    xlen, band = m[:, 6], m[:, 7]
    total = 0
    for j in range(1, int(ylen.max(initial=0)) + 1):
        row0 = np.maximum(j - band, 0)
        n = np.minimum(2 * band, xlen - row0) + 1
        total += int(np.where(ylen >= j, np.maximum(n, 0), 0).sum())
    return total


def launch_bytes(meta: np.ndarray, YMAX: int, SMAX: int) -> int:
    m = meta9(meta)
    real = m[:, 3] > 0
    ylen = np.minimum(m[real, 3], YMAX)
    xlen = m[real, 6]
    return int(((ylen + 1) // 2 + (xlen + 1) // 2).sum()
               + real.sum() * (16 + 8 + 4 * (SMAX // 16)))


def bound_s(launches) -> tuple:
    """(operation-bound seconds, bytes-bound seconds) of the launches."""
    cells = sum(band_cells(np.asarray(l["meta"]), l["YMAX"]) for l in launches)
    nbytes = sum(launch_bytes(np.asarray(l["meta"]), l["YMAX"], l["SMAX"])
                 for l in launches)
    return cells / PEAK_CELLS_S, nbytes / PEAK_BYTES_S


def read(run):
    t = run.get("trace")
    launches = run.get("launches")
    if not t or not launches or t["stream_kernel_s"] <= 0:
        return None
    ops_s, bytes_s = bound_s(launches)
    return 100.0 * max(ops_s, bytes_s) / t["stream_kernel_s"]
