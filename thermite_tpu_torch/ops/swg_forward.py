"""Banded SWG extension scores: the forward-only kernel.

``swg_forward`` is the port of the reference's forward-scores Pallas
kernel (``thermite_tpu/ops/swg_pallas.py::make_forward_kernel`` behind
``make_forward_gather_kernel``).  Per problem it gathers the x and y
windows, runs the same banded affine-gap SWG with X-drop as the stream
kernels, and returns (N, 4) int32 rows [score, max_i, max_j, 0]: the best
score and the first cell that reaches it.  No directions, no walk, no
certificate.  The batch pipeline scores every nontrivial problem with it
when it runs without the C++ engine.

For a CUDA tensor the wrapper launches the hand-written kernel
(``csrc/swg_forward.cu``, counted in ``swg_forward.launches``).  Where
128 band slots cover the launch (``rows_launch``: band 60 at XMAX 96,
every band up to 63) each warp of it owns four consecutive rows and runs
them as sub-warp groups of 8, 16 or 32 lanes x 4 slots, the narrowest
that covers the largest min(2*band + 1, xlen + 1) among them
(``warp_lanes``); rows ordered by ylen, as the batch pipeline submits
them, put short problems side by side in narrow groups.  Above 128 slots
a launch takes one warp a problem.  For a CPU tensor the wrapper runs
``swg_forward_plain``, the plain PyTorch version, which is also the
referee the card's kernel is held against.
"""

from __future__ import annotations

import ctypes

import torch

from .swg_stream import (
    _check,
    _current_stream,
    _forward_plain,
    _launch_args,
    _windows,
    band_max_of,
    meta9,
    raise_for_launch,
    slots_per_lane,
)


def swg_forward_plain(ref_nib, ref_lw, reads_nib, meta, XMAX: int,
                      YMAX: int):
    """Plain PyTorch version of the forward kernel; same arguments and
    output as ``swg_forward``, on any device."""
    _check(ref_nib, ref_lw, reads_nib, meta, XMAX, YMAX)
    m9 = meta9(meta)
    x, y = _windows(ref_nib[:ref_lw], reads_nib, m9, XMAX, YMAX)
    xlen, ylen, band, xdrop = (m9[:, k] for k in (6, 3, 7, 8))
    bmax = int(band.max()) if len(band) else 0
    L = 32 * slots_per_lane(bmax, XMAX)
    ms, mi, mj, _, _ = _forward_plain(x, y, xlen, ylen, band, xdrop, L,
                                      want_dirs=False)
    return torch.stack([ms, mi, mj, torch.zeros_like(ms)], 1)


def swg_forward(ref_nib, ref_lw, reads_nib, meta, XMAX: int, YMAX: int,
                band_max=None):
    """(ref_nib (Lw,) i32, ref_lw, reads_nib (Lr,) i32, meta (N, 4|9) i32)
    -> (N, 4) i32 [score, max_i, max_j, 0].

    Every problem needs xlen <= XMAX; y columns past YMAX are not
    computed.  ``band_max`` bounds every band of ``meta`` (read from it
    when not given).  CUDA tensors launch the kernel on the current
    stream (no synchronisation); CPU tensors run ``swg_forward_plain``."""
    if meta.device.type != "cuda":
        return swg_forward_plain(ref_nib, ref_lw, reads_nib, meta, XMAX, YMAX)
    _check(ref_nib, ref_lw, reads_nib, meta, XMAX, YMAX)
    from ._build import kernel_lib

    out = torch.empty((meta.shape[0], 4), dtype=torch.int32,
                      device=meta.device)
    if meta.shape[0] == 0:
        return out
    err = kernel_lib("swg_forward").thermite_swg_forward_launch(
        *_launch_args(ref_nib, ref_lw, reads_nib, meta), XMAX, YMAX,
        band_max_of(meta, band_max), ctypes.c_void_p(out.data_ptr()),
        _current_stream(meta),
    )
    raise_for_launch(err, "swg_forward")
    swg_forward.launches += 1
    return out


swg_forward.launches = 0
