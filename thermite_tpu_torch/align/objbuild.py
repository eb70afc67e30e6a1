"""ctypes (PyDLL) binding for the C-level result-object builder.

``build()`` constructs the GenomeAlignment/Alignment/RunOps object tree
for a chunk's selected alignments in C (csrc/host/thermite_objbuild.c) —
the instances are the same slotted dataclasses from
``thermite_tpu_torch.align.types``, allocated via tp_alloc with direct slot
stores, which removes the Python ``__init__`` interpreter cost that
dominated the finalize stage.  Returns None when the native builder is
unavailable or rejects the layout; the caller then uses the
pure-Python loop (both paths give equal objects).
"""

from __future__ import annotations

import ctypes
import subprocess
from typing import List, Optional

import numpy as np

from .types import EXONIC, INTERGENIC, INTRONIC, Alignment, GenomeAlignment, RunOps

_lib = None
_state = "unloaded"  # unloaded | ready | failed
_i64p = ctypes.POINTER(ctypes.c_int64)
_u8p = ctypes.POINTER(ctypes.c_uint8)
_ALN_TYPES = (EXONIC, INTRONIC, INTERGENIC)


def _try_init():
    global _lib, _state
    if _state != "unloaded":
        return _lib
    try:
        from ..ops._build import object_builder

        path = object_builder()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        _state = "failed"
        return None
    try:
        # PyDLL: calls run WITH the GIL held (the builder manipulates
        # Python objects)
        lib = ctypes.PyDLL(path)
        lib.thermite_obj_init.restype = ctypes.c_int64
        lib.thermite_obj_init.argtypes = [ctypes.py_object] * 3
        lib.thermite_obj_build.restype = ctypes.c_int64
        lib.thermite_obj_build.argtypes = (
            [ctypes.py_object] * 6
            + [_i64p, ctypes.c_int64]
            + [_i64p] * 5
            + [_u8p, _i64p]
            + [ctypes.c_int64] * 3
        )
        rc = lib.thermite_obj_init(Alignment, GenomeAlignment, RunOps)
        if rc != 0:
            _state = "failed"
            return None
    except OSError:
        _state = "failed"
        return None
    _lib = lib
    _state = "ready"
    return _lib


def _arr(a: np.ndarray, ty):
    return a.ctypes.data_as(ty)


_Z64 = np.zeros(1, np.int64)  # non-null stand-in for empty arrays


def _p64(a: np.ndarray):
    return _arr(a if len(a) else _Z64, _i64p)


def build(
    sel: np.ndarray,
    fin_runs: np.ndarray,
    fin_off: np.ndarray,
    tx_runs: np.ndarray,
    tx_off: np.ndarray,
    tx_meta: np.ndarray,
    fallback: np.ndarray,
    task_tx: np.ndarray,
    ref_names: List[str],
    ref_strands: List[bool],
    ref_lens: List[int],
    read_lens: List[int],
    results: List[List[GenomeAlignment]],
) -> Optional[int]:
    """Fill ``results`` in place; fallback rows get a None placeholder.

    Returns the fallback count, or None when the C builder is
    unavailable / refused.  On None the caller runs the Python loop on
    ``results``, which is guaranteed untouched: the C side validates
    every sel row and offset range in a pre-pass before any append,
    and a mid-loop allocation failure rolls each per-read list back to
    its pre-call length before returning."""
    lib = _try_init()
    if lib is None:
        return None
    sel = np.ascontiguousarray(sel, np.int64)
    if sel.ndim != 2 or sel.shape[1] != 11:
        return None
    S = len(sel)
    fb = np.ascontiguousarray(fallback, np.uint8)
    if len(fb) != S or len(fin_off) != S + 1 or len(tx_off) != S + 1:
        return None
    tm = np.ascontiguousarray(tx_meta, np.int64)
    if S and (tm.ndim != 2 or tm.shape[1] != 5 or len(tm) != S):
        return None
    fin_runs = np.ascontiguousarray(fin_runs, np.int64)
    tx_runs = np.ascontiguousarray(tx_runs, np.int64)
    task_tx = np.ascontiguousarray(task_tx, np.int64)
    rc = lib.thermite_obj_build(
        _ALN_TYPES, ref_names, ref_strands, ref_lens, read_lens, results,
        _p64(sel.reshape(-1)), S,
        _p64(fin_runs),
        _p64(np.ascontiguousarray(fin_off, np.int64)),
        _p64(tx_runs),
        _p64(np.ascontiguousarray(tx_off, np.int64)),
        _p64(tm.reshape(-1)),
        _arr(fb if S else np.zeros(1, np.uint8), _u8p),
        _p64(task_tx),
        len(task_tx), len(fin_runs), len(tx_runs),
    )
    if rc < 0:
        return None
    return int(rc)
