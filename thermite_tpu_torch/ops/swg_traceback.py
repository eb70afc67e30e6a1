"""Banded SWG extension with a run-length traceback: kernel 4.

``swg_traceback`` (gather form) and ``swg_traceback_dense`` are the port
of the reference's run-length traceback Pallas kernel
(``thermite_tpu/ops/swg_pallas.py::make_traceback_kernel``) and of its
gather front end (``make_traceback_gather_kernel``).  Per problem they
run the banded affine-gap SWG with X-drop of the stream kernels, then
walk back from the best cell and emit run-length runs
``(op << 28) | len`` (op 0-3 = M, S, D, I) in backward walk order.
No pipeline of either package calls it: it is the reference's kernel
for differential testing (``tests/test_swg_pallas.py``), and here it is
held against the plain version, the scalar oracle and the stream
kernels' walks.

Outputs, in row order:
  meta (N, 4) int32 [score, max_i, max_j, nruns]
  runs (N, RMAX) int32, zero past the runs written
``nruns`` is -1 when the walk needed more than RMAX runs, or did not
reach the origin within the kernel shape's XMAX + YMAX + 2 steps;
exactly RMAX runs is a valid walk.  The reference leaves runs past
``nruns`` unwritten: compare only ``runs[:nruns]`` against it.

The two forms take different inputs and compare different things:
- gather: the nibble-packed text and read block with (N, 9|4) meta, as
  the stream kernels take them (a read byte outside ACGTN is code 15 and
  never matches);
- dense: the reference kernel's own arrays, x (N, XW) uint8 pre-shifted
  rows ``[0, x...]`` (XW >= XMAX + 1), y (N, YMAX) uint8, params (N, 4)
  int32 [xlen, ylen, band, x_drop]; raw bytes are compared.

For a CUDA tensor each wrapper launches the hand-written kernel
(``csrc/swg_traceback.cu``; counted in ``swg_traceback.launches`` and
``swg_traceback_dense.launches``).  Where 128 band slots cover the
launch (``rows_launch``) each warp of it owns four consecutive rows and
runs them as sub-warp groups of 8, 16 or 32 lanes x 4 slots, the
narrowest that covers the largest min(2*band + 1, xlen + 1) among them
(``warp_lanes``), and the first lane of every group walks its own
problem, up to four walks side by side; above 128 slots a launch takes
one warp a problem.  For a CPU tensor it runs the plain
PyTorch version (``swg_traceback_plain``, ``swg_traceback_dense_plain``),
which is also the referee the kernel is held against.
"""

from __future__ import annotations

import ctypes

import torch

from .layout import DIR_DEL, DIR_INS, DIR_SUBST, RUN_OP_SHIFT
from .swg_stream import (
    ROWS_PER_WARP,
    ROWS_SLOTS,
    _check,
    _current_stream,
    _forward_plain,
    _launch_args,
    _windows,
    band_max_of,
    meta9,
    on_device_of,
    problem_smem_words,
    raise_for_launch,
    slots_per_lane,
)

# Shared memory a block may opt into on sm_90 (csrc/swg_stream.cuh).
SMEM_OPTIN_BYTES = 232448


def traceback_smem_bytes(XMAX: int, YMAX: int, RMAX: int, slots: int) -> int:
    """Shared memory of one warp of a launch whose slot class is ``slots``
    (``slots_per_lane``).  Up to 4 the launch is of the per-warp family: a
    warp holds ROWS_PER_WARP problems at 8 lanes x 4 slots, each with its
    direction planes (8 bytes per column 0..YMAX), RMAX run words and the
    x and y windows as bytes (``rows_warp_words`` in swg_stream.cuh);
    that covers its two problems at 16 lanes and its one at 32.  Above, a
    warp holds one problem at 32 lanes (``problem_smem_words``)."""
    if slots <= ROWS_SLOTS:
        return 4 * ROWS_PER_WARP * problem_smem_words(XMAX, YMAX, RMAX, 8,
                                                      ROWS_SLOTS)
    return 4 * problem_smem_words(XMAX, YMAX, RMAX, 32, slots)


def _walk_runs_plain(dirs, mi, mj, band, steps: int, RMAX: int):
    """Per-problem run-length walk from (mi, mj) -> (nruns (N,) int32,
    runs (N, RMAX) int32).

    The steps of the stream walk (``_walk_plain``), at most ``steps`` of
    them; a run ends where the op changes and after the last step.  Run
    k is written while k < RMAX; nruns is -1 past RMAX runs or when the
    walk has not reached the origin."""
    dev = dirs.device
    N = dirs.shape[0]
    i64 = torch.int64
    i, j = mi.to(i64), mj.to(i64)
    band = band.to(i64)
    rows = torch.arange(N, device=dev)
    cur_op = torch.full((N,), -1, dtype=i64, device=dev)
    cur_len = torch.zeros(N, dtype=i64, device=dev)
    nr = torch.zeros(N, dtype=i64, device=dev)
    spare = N * RMAX  # runs that are not written land here
    runs = torch.zeros(spare + 1, dtype=i64, device=dev)

    def emit(ends):
        put = ends & (nr < RMAX)
        runs[torch.where(put, rows * RMAX + nr, spare)] = torch.where(
            put, (cur_op << RUN_OP_SHIFT) | cur_len, 0)
        return nr + ends.to(i64)

    for s in range(steps):
        alive = (i > 0) | (j > 0)
        if s % 32 == 0 and not bool(alive.any()):
            break
        row0 = torch.clamp(j - band, min=0)
        bi = torch.minimum(torch.clamp(i - row0, min=0), 2 * band)
        d = dirs[rows, torch.clamp(j, min=0), bi].to(i64)
        boundary = alive & (d != cur_op) & (cur_len > 0)
        nr = emit(boundary)
        cur_len = torch.where(boundary, 0, cur_len)
        cur_op = torch.where(alive, d, cur_op)
        cur_len = cur_len + alive.to(i64)
        i = i - (alive & ((d <= DIR_SUBST) | (d == DIR_INS))).to(i64)
        j = j - (alive & ((d <= DIR_SUBST) | (d == DIR_DEL))).to(i64)
    nr = emit(cur_len > 0)
    bad = (nr > RMAX) | (i > 0) | (j > 0)
    nruns = torch.where(bad, -1, nr).to(torch.int32)
    return nruns, runs[:spare].reshape(N, RMAX).to(torch.int32)


def _traceback_plain(x, y, xlen, ylen, band, xdrop, XMAX: int, YMAX: int,
                     RMAX: int):
    """x (N, XMAX), y (N, YMAX) int32 codes or bytes -> (meta, runs)."""
    bmax = int(band.max()) if len(band) else 0
    L = 32 * slots_per_lane(bmax, XMAX)
    ms, mi, mj, _, dirs = _forward_plain(x, y, xlen, ylen, band, xdrop, L)
    nruns, runs = _walk_runs_plain(dirs, mi, mj, band, XMAX + YMAX + 2, RMAX)
    return torch.stack([ms, mi, mj, nruns], 1), runs


def _check_rmax(RMAX: int) -> None:
    if RMAX < 1:
        raise ValueError(f"RMAX must be positive, got {RMAX}")


def swg_traceback_plain(ref_nib, ref_lw, reads_nib, meta, XMAX: int,
                        YMAX: int, RMAX: int = 24):
    """Plain PyTorch version of the gather form; same arguments and
    outputs as ``swg_traceback``, on any device."""
    _check(ref_nib, ref_lw, reads_nib, meta, XMAX, YMAX)
    _check_rmax(RMAX)
    m9 = meta9(meta)
    x, y = _windows(ref_nib[:ref_lw], reads_nib, m9, XMAX, YMAX)
    xlen, ylen, band, xdrop = (m9[:, k] for k in (6, 3, 7, 8))
    return _traceback_plain(x, y, xlen, ylen, band, xdrop, XMAX, YMAX, RMAX)


def _check_dense(x, y, params, XMAX: int, YMAX: int, RMAX: int) -> None:
    for name, tns, dt in (("x", x, torch.uint8), ("y", y, torch.uint8),
                          ("params", params, torch.int32)):
        if tns.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {tns.dtype}")
        if tns.dim() != 2 or not tns.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D tensor")
        if tns.device != params.device or tns.shape[0] != params.shape[0]:
            raise ValueError(f"{name} must have params' rows and device")
    if params.shape[1] != 4:
        raise ValueError(f"params must be (N, 4), got {tuple(params.shape)}")
    if XMAX < 1 or YMAX < 1 or x.shape[1] < XMAX + 1 or y.shape[1] < YMAX:
        raise ValueError(f"x (N, >= XMAX + 1) and y (N, >= YMAX) with "
                         f"XMAX, YMAX > 0; got {tuple(x.shape)}, "
                         f"{tuple(y.shape)} for ({XMAX}, {YMAX})")
    _check_rmax(RMAX)


def swg_traceback_dense_plain(x, y, params, XMAX: int, YMAX: int,
                              RMAX: int = 64):
    """Plain PyTorch version of the dense form; same arguments and
    outputs as ``swg_traceback_dense``, on any device."""
    _check_dense(x, y, params, XMAX, YMAX, RMAX)
    xlen, ylen, band, xdrop = (params[:, k] for k in range(4))
    ix = torch.arange(XMAX, device=x.device)[None, :]
    iy = torch.arange(YMAX, device=y.device)[None, :]
    xw = torch.where(ix < xlen[:, None], x[:, 1 : XMAX + 1].to(torch.int32), 0)
    yw = torch.where(iy < ylen[:, None], y[:, :YMAX].to(torch.int32), 0)
    return _traceback_plain(xw, yw, xlen, ylen, band, xdrop, XMAX, YMAX, RMAX)


def _outputs_for_launch(n: int, XMAX: int, YMAX: int, RMAX: int, bmax: int,
                        device):
    """Empty outputs of a launch, after the shape checks the kernel
    makes: a slot class must cover the band and one warp's shared memory
    must fit the opt-in limit."""
    slots = slots_per_lane(bmax, XMAX)
    need = traceback_smem_bytes(XMAX, YMAX, RMAX, slots)
    if need > SMEM_OPTIN_BYTES:
        raise ValueError(
            f"swg_traceback: one warp needs {need} bytes of shared "
            f"memory at XMAX {XMAX}, YMAX {YMAX}, RMAX {RMAX}, slot class "
            f"{slots}; the limit is {SMEM_OPTIN_BYTES}")
    meta = torch.empty((n, 4), dtype=torch.int32, device=device)
    runs = torch.empty((n, RMAX), dtype=torch.int32, device=device)
    return meta, runs


def swg_traceback(ref_nib, ref_lw, reads_nib, meta, XMAX: int, YMAX: int,
                  RMAX: int = 24, band_max=None):
    """(ref_nib (Lw,) i32, ref_lw, reads_nib (Lr,) i32, meta (N, 4|9) i32)
    -> (meta_out (N, 4) i32, runs (N, RMAX) i32).

    Every problem needs xlen <= XMAX <= 512 and YMAX <= 512; y columns
    past YMAX are not computed.  ``band_max`` bounds every band of
    ``meta`` (read from it when not given).  CUDA tensors launch the
    kernel on the current stream (no synchronisation); CPU tensors run
    ``swg_traceback_plain``."""
    if meta.device.type != "cuda":
        return swg_traceback_plain(ref_nib, ref_lw, reads_nib, meta, XMAX,
                                   YMAX, RMAX)
    _check(ref_nib, ref_lw, reads_nib, meta, XMAX, YMAX)
    _check_rmax(RMAX)
    bmax = band_max_of(meta, band_max)
    out, runs = _outputs_for_launch(meta.shape[0], XMAX, YMAX, RMAX, bmax,
                                    meta.device)
    if meta.shape[0]:
        from ._build import kernel_lib

        with on_device_of(meta):
            err = kernel_lib("swg_traceback").thermite_swg_traceback_launch(
                *_launch_args(ref_nib, ref_lw, reads_nib, meta), XMAX, YMAX,
                RMAX, bmax, ctypes.c_void_p(out.data_ptr()),
                ctypes.c_void_p(runs.data_ptr()), _current_stream(meta),
            )
        raise_for_launch(err, "swg_traceback")
        swg_traceback.launches += 1
    return out, runs


swg_traceback.launches = 0


def swg_traceback_dense(x, y, params, XMAX: int, YMAX: int, RMAX: int = 64,
                        band_max=None):
    """(x (N, XW) u8 pre-shifted, y (N, YMAX) u8, params (N, 4) i32)
    -> (meta_out (N, 4) i32, runs (N, RMAX) i32), the reference kernel's
    own interface.

    Every problem needs xlen <= XMAX.  ``band_max`` bounds every band of
    ``params`` (read from it when not given).  CUDA tensors launch the
    kernel on the current stream; CPU tensors run
    ``swg_traceback_dense_plain``."""
    if params.device.type != "cuda":
        return swg_traceback_dense_plain(x, y, params, XMAX, YMAX, RMAX)
    _check_dense(x, y, params, XMAX, YMAX, RMAX)
    n = params.shape[0]
    bmax = int(band_max if band_max is not None
               else (params[:, 2].max() if n else 0))
    out, runs = _outputs_for_launch(n, XMAX, YMAX, RMAX, bmax, params.device)
    if n:
        from ._build import kernel_lib

        lib = kernel_lib("swg_traceback")
        with on_device_of(params):
            err = lib.thermite_swg_traceback_dense_launch(
                ctypes.c_void_p(x.data_ptr()), ctypes.c_int64(x.shape[1]),
                ctypes.c_void_p(y.data_ptr()), ctypes.c_int64(y.shape[1]),
                ctypes.c_void_p(params.data_ptr()), ctypes.c_int64(n), XMAX,
                YMAX, RMAX, bmax, ctypes.c_void_p(out.data_ptr()),
                ctypes.c_void_p(runs.data_ptr()), _current_stream(params),
            )
        raise_for_launch(err, "swg_traceback_dense")
        swg_traceback_dense.launches += 1
    return out, runs


swg_traceback_dense.launches = 0
