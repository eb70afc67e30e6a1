"""ctypes bindings for the native (C++) seeding engine.

The shared library is built from ``csrc/host/thermite_native.cpp`` at
first use (``ops/_build.py::native_engine``).  ``NativeSmemEngine`` is output-identical to the numpy
``SmemEngine``; ``make_seeder`` builds it.
"""

from __future__ import annotations

import ctypes
from typing import List

import numpy as np

from ..align.types import Mem
from .kmer import MAX_ANCHOR_K


class SeedTableView(tuple):
    """Classic (k, uniq_keys, offsets, positions) tuple whose arrays
    are zero-copy views into a live engine; ``keepalive`` pins that
    engine so the views cannot dangle after the exporting engine's
    other references drop."""

    keepalive = None


class PackedSeedTable:
    """Genome-scale posting table in packed form: ``kv`` holds sorted
    u64 entries ``(rem_key << pos_bits) | (position // stride)`` and
    ``bucket_off`` the MSD top-bucket bounds — the uniq/offsets/
    positions arrays are never materialized (~37 GB fresh + ~2/3 of
    the artifact at 3.2 Gbp).  ``table[0]`` still yields ``k`` so the
    anchor-k checks shared with the classic 4-tuple keep working.

    The arrays may be zero-copy views into a live engine (see
    ``NativeSmemEngine.export_table``); ``keepalive`` then pins it.
    """

    __slots__ = ("k", "stride", "top_bits", "pos_bits", "bucket_off",
                 "kv", "pfx", "keepalive")

    def __init__(self, k, stride, top_bits, pos_bits, bucket_off, kv,
                 pfx=None, keepalive=None):
        self.k = int(k)
        self.stride = int(stride)
        self.top_bits = int(top_bits)
        self.pos_bits = int(pos_bits)
        self.bucket_off = bucket_off
        self.kv = kv
        # optional persisted pfx prefix (seed_pfx artifact member):
        # adopting it skips the full-kv count pass at engine start
        self.pfx = pfx
        self.keepalive = keepalive

    def __getitem__(self, i):
        if i == 0:
            return self.k
        raise IndexError(
            "packed seed table carries no classic posting arrays; "
            "use .kv / .bucket_off"
        )

    def __len__(self):
        return 1

_lib = None


def _try_load():
    """The C++ engine's library, built into ``_build/`` at first use
    (``ops/_build.py::native_engine``) and loaded by full path with local
    symbol scope.  A build or load that fails raises."""
    global _lib
    if _lib is not None:
        return _lib
    from ..ops._build import native_engine

    lib = ctypes.CDLL(native_engine())
    lib.thermite_seed_index_new.restype = ctypes.c_void_p
    lib.thermite_seed_index_new.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
    ]
    lib.thermite_seed_index_new_stride.restype = ctypes.c_void_p
    lib.thermite_seed_index_new_stride.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
    ]
    lib.thermite_seed_index_free.argtypes = [ctypes.c_void_p]
    lib.thermite_seed_index_size.restype = ctypes.c_int64
    lib.thermite_seed_index_size.argtypes = [ctypes.c_void_p]
    _i64p = ctypes.POINTER(ctypes.c_int64)
    lib.thermite_seed_index_n_keys.restype = ctypes.c_int64
    lib.thermite_seed_index_n_keys.argtypes = [ctypes.c_void_p]
    lib.thermite_seed_index_export.argtypes = [ctypes.c_void_p, _i64p, _i64p, _i64p]
    _i64pp = ctypes.POINTER(_i64p)
    lib.thermite_seed_index_views.argtypes = [
        ctypes.c_void_p, _i64pp, _i64pp, _i64pp,
    ]
    _u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.thermite_seed_index_is_packed.restype = ctypes.c_int
    lib.thermite_seed_index_is_packed.argtypes = [ctypes.c_void_p]
    lib.thermite_seed_index_packed_meta.argtypes = [
        ctypes.c_void_p, _i64p, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32), _i64p, _i64p,
    ]
    lib.thermite_seed_index_packed_views.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(_u64p), _i64pp,
    ]
    lib.thermite_seed_index_new_from_kv.restype = ctypes.c_void_p
    lib.thermite_seed_index_new_from_kv.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int64,
        ctypes.c_int32, ctypes.c_int32, _u64p, ctypes.c_int64,
        _i64p, ctypes.c_int64, _i64p, ctypes.c_int64,
    ]
    lib.thermite_seed_index_pfx.argtypes = [
        ctypes.c_void_p, _i64pp, ctypes.POINTER(ctypes.c_int64),
    ]
    lib.thermite_seed_index_new_from_arrays.restype = ctypes.c_void_p
    lib.thermite_seed_index_new_from_arrays.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        _i64p, ctypes.c_int64, _i64p, _i64p, ctypes.c_int64,
    ]
    _i32p = ctypes.POINTER(ctypes.c_int32)
    lib.thermite_seed_index_new_from_arrays32.restype = ctypes.c_void_p
    lib.thermite_seed_index_new_from_arrays32.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
        _i64p, ctypes.c_int64, _i64p, _i32p, ctypes.c_int64,
    ]
    lib.thermite_seed_index_set_stride_hint.restype = None
    lib.thermite_seed_index_set_stride_hint.argtypes = [
        ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.thermite_smems.restype = ctypes.c_int64
    lib.thermite_smems.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
    ]
    _lib = lib
    return _lib


class NativeSmemEngine:
    """Drop-in replacement for ``SmemEngine`` backed by C++."""

    def __init__(self, seq_arr: np.ndarray, min_seed_len: int, table=None,
                 stride: int = 1, stride_known=None):
        """``stride_known``: the stride a CLASSIC posting-array
        ``table`` was built with, when the caller knows it (artifacts
        record it as meta["seed_stride"]; Index.build_seed_table keeps
        it on the Index).  Packed tables carry their own stride, and
        fresh builds use ``stride`` — this only matters for the
        adopted-classic-arrays path, where an unknown stride keeps the
        C side's adaptive probe skip off (csrc thermite_smems)."""
        self._lib = lib = _try_load()
        self.min_seed_len = min_seed_len
        self.k = min(MAX_ANCHOR_K, min_seed_len)
        # keep the text alive: the C++ index BORROWS the buffer (no
        # tobytes() copy — a whole-genome text is ~6 GB)
        self._text_arr = np.ascontiguousarray(seq_arr, dtype=np.uint8)
        text_p = self._text_arr.ctypes.data_as(ctypes.c_char_p)
        n = len(self._text_arr)
        if (
            table is not None
            and isinstance(table, PackedSeedTable)
            and table.k == self.k
        ):
            # persisted PACKED table: borrow kv + bucket_off, rebuild
            # only the pfx prefix (one streaming pass)
            kv = np.ascontiguousarray(table.kv, np.uint64)
            boff = np.ascontiguousarray(table.bucket_off, np.int64)
            pfx = table.pfx
            if pfx is not None:
                pfx = np.ascontiguousarray(pfx, np.int64)
            self._table_keep = (kv, boff, pfx, table)
            i64 = ctypes.POINTER(ctypes.c_int64)
            self._h = lib.thermite_seed_index_new_from_kv(
                text_p, n, self.k, table.stride, table.top_bits,
                table.pos_bits,
                kv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                len(kv),
                boff.ctypes.data_as(i64),
                len(boff) - 1,
                pfx.ctypes.data_as(i64) if pfx is not None else None,
                len(pfx) if pfx is not None else 0,
            )
            if not self._h and pfx is not None:
                # stale/incompatible persisted pfx: rebuild without it
                self._h = lib.thermite_seed_index_new_from_kv(
                    text_p, n, self.k, table.stride, table.top_bits,
                    table.pos_bits,
                    kv.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                    len(kv),
                    boff.ctypes.data_as(i64),
                    len(boff) - 1,
                    None, 0,
                )
        elif table is not None and table[0] == self.k:
            # persisted posting arrays: skip the radix-sort build (~42 s
            # at chromosome scale).  The C++ side BORROWS these arrays
            # (a genome-scale table is ~37 GB; a copy would OOM), so
            # they must stay referenced here for the handle's lifetime.
            _, keys, offsets, positions = table
            keys = np.ascontiguousarray(keys, np.int64)
            offsets = np.ascontiguousarray(offsets, np.int64)
            p = ctypes.POINTER(ctypes.c_int64)
            if positions.dtype == np.int32 and positions.flags.c_contiguous:
                # artifact's narrow form (Index.save stores int32 for
                # <2 GiB texts): adopt zero-copy — widening first-touches
                # ~0.7 GB of fresh pages, which this deployment throttles
                # to minutes in bad windows
                self._table_keep = (keys, offsets, positions)
                self._h = lib.thermite_seed_index_new_from_arrays32(
                    text_p, n, self.k,
                    keys.ctypes.data_as(p), len(keys),
                    offsets.ctypes.data_as(p),
                    positions.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_int32)
                    ),
                    len(positions),
                )
            else:
                positions = np.ascontiguousarray(positions, np.int64)
                self._table_keep = (keys, offsets, positions)
                self._h = lib.thermite_seed_index_new_from_arrays(
                    text_p, n, self.k,
                    keys.ctypes.data_as(p), len(keys),
                    offsets.ctypes.data_as(p),
                    positions.ctypes.data_as(p), len(positions),
                )
        else:
            self._h = lib.thermite_seed_index_new_stride(
                text_p, n, self.k, stride
            )
        if not self._h:
            raise RuntimeError("native seed index construction failed")
        if (
            stride_known is not None
            and table is not None
            and not isinstance(table, PackedSeedTable)
        ):
            lib.thermite_seed_index_set_stride_hint(
                self._h, int(stride_known)
            )
        self._cap = 4096
        self._alloc()

    def export_table(self, views: bool = False):
        """-> (k, uniq_keys, offsets, positions) int64 arrays.

        ``views=False`` (default): independent copies, safe after the
        engine is dropped.  ``views=True``: zero-copy read-only numpy
        views over the engine's own arrays — a genome-scale copy is
        ~37 GB of fresh pages, so the index build path uses views and
        keeps THIS ENGINE alive for as long as the arrays are used
        (``Index.build_seed_table`` stores it on the Index)."""
        lib = self._lib
        if lib.thermite_seed_index_is_packed(self._h):
            n_top = ctypes.c_int64()
            tb = ctypes.c_int32()
            pb = ctypes.c_int32()
            st = ctypes.c_int64()
            tot = ctypes.c_int64()
            lib.thermite_seed_index_packed_meta(
                self._h, ctypes.byref(n_top), ctypes.byref(tb),
                ctypes.byref(pb), ctypes.byref(st), ctypes.byref(tot),
            )
            kvp = ctypes.POINTER(ctypes.c_uint64)()
            bop = ctypes.POINTER(ctypes.c_int64)()
            lib.thermite_seed_index_packed_views(
                self._h, ctypes.byref(kvp), ctypes.byref(bop)
            )
            kv = np.ctypeslib.as_array(kvp, shape=(tot.value,))
            boff = np.ctypeslib.as_array(bop, shape=(n_top.value + 1,))
            pfx = None
            pp = ctypes.POINTER(ctypes.c_int64)()
            pn = ctypes.c_int64()
            lib.thermite_seed_index_pfx(
                self._h, ctypes.byref(pp), ctypes.byref(pn)
            )
            if pp and pn.value:
                pfx = np.ctypeslib.as_array(pp, shape=(pn.value,))
            if views:
                kv.flags.writeable = False
                boff.flags.writeable = False
                if pfx is not None:
                    pfx.flags.writeable = False
            else:
                kv, boff = kv.copy(), boff.copy()
                pfx = pfx.copy() if pfx is not None else None
            return PackedSeedTable(
                self.k, st.value, tb.value, pb.value, boff, kv,
                pfx=pfx, keepalive=self if views else None,
            )
        m = lib.thermite_seed_index_n_keys(self._h)
        total = lib.thermite_seed_index_size(self._h)
        p = ctypes.POINTER(ctypes.c_int64)
        if views:
            kp, op, pp = p(), p(), p()
            lib.thermite_seed_index_views(
                self._h, ctypes.byref(kp), ctypes.byref(op), ctypes.byref(pp)
            )
            if not pp:
                # narrow (int32-positions) adopted table: no int64 view
                # exists; the caller already holds the adopted arrays
                raise ValueError(
                    "export_table(views=True) unsupported for a table "
                    "adopted from int32 positions — reuse the arrays "
                    "the table was constructed from"
                )
            out = []
            for ptr, size in ((kp, m), (op, m + 1), (pp, total)):
                arr = np.ctypeslib.as_array(ptr, shape=(size,))
                arr.flags.writeable = False
                out.append(arr)
            t = SeedTableView((self.k, *out))
            t.keepalive = self  # the views alias this engine's arrays
            return t
        keys = np.empty(m, np.int64)
        offsets = np.empty(m + 1, np.int64)
        positions = np.empty(total, np.int64)
        lib.thermite_seed_index_export(
            self._h, keys.ctypes.data_as(p), offsets.ctypes.data_as(p),
            positions.ctypes.data_as(p),
        )
        return self.k, keys, offsets, positions

    def _alloc(self):
        self._q = (ctypes.c_int64 * self._cap)()
        self._t = (ctypes.c_int64 * self._cap)()
        self._l = (ctypes.c_int64 * self._cap)()

    def __del__(self):
        if getattr(self, "_h", None) and getattr(self, "_lib", None):
            self._lib.thermite_seed_index_free(self._h)

    def all_smems(self, read: bytes) -> List[Mem]:
        n = self._lib.thermite_smems(
            self._h, read, len(read), self.min_seed_len,
            self._q, self._t, self._l, self._cap,
        )
        if n < 0:
            self._cap = int(-n) * 2
            self._alloc()
            n = self._lib.thermite_smems(
                self._h, read, len(read), self.min_seed_len,
                self._q, self._t, self._l, self._cap,
            )
        return [
            Mem(ref_idx=self._t[i], query_idx=self._q[i], len=self._l[i])
            for i in range(n)
        ]


def make_seeder(seq_arr: np.ndarray, min_seed_len: int, table=None,
                stride: int = 1, stride_known=None):
    """The C++ seeding engine over ``seq_arr`` (the numpy ``SmemEngine``
    of ``seed/smem.py`` is its output-identical oracle).

    ``table`` is an optional persisted posting table
    (k, uniq_keys, offsets, positions); it is used only when its k
    matches the anchor k for ``min_seed_len`` (else rebuilt with
    ``stride``: >1 samples text positions — whole-genome tables; see
    thermite_seed_index_new_stride in csrc).  ``stride_known``
    declares a classic table's build stride (NativeSmemEngine)."""
    k = min(MAX_ANCHOR_K, min_seed_len)
    if table is not None and table[0] != k:
        import sys

        if len(seq_arr) >= (512 << 20):
            # rebuilding a genome-scale table (tens of GB, many
            # minutes, and the persisted stride choice would be lost)
            # must be an explicit decision, not a silent fallback
            raise ValueError(
                f"persisted seed table was built for anchor k="
                f"{table[0]} but min_seed_len={min_seed_len} needs "
                f"k={k}; re-index with matching -k (and --seed-stride) "
                "instead of rebuilding at align time"
            )
        print(
            f"warning: persisted seed table (k={table[0]}) unusable "
            f"for min_seed_len={min_seed_len}; rebuilding",
            file=sys.stderr,
        )
    return NativeSmemEngine(seq_arr, min_seed_len, table=table,
                            stride=stride, stride_known=stride_known)
