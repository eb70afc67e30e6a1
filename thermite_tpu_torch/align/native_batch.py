"""ctypes bindings for the native (C++) batch host stages.

``NativeBatchEngine`` ports the batch pipeline's host stages — chunk
task building (seeding, genome windows, transcript candidates, device
gather offsets) and post-kernel arbitration (genome-vs-transcriptome
choice, thresholds, overlap filter, primary selection) — to C++
(csrc/host/thermite_native.cpp).  The Python implementations in
``batch.py`` remain the fallback and the parity referee
(tests/test_torch_batch_no_native.py runs both paths).

Task/selected array layouts mirror the C++ enums:
  tasks   (T, 10): read_i, is_tx, hit_ref, hit_q, hit_len, lp, rp,
                   ref_len, seq_start, tx_idx
  selected(S, 11): read_i, task_idx, aln_type, gene_idx, ref_id,
                   score, chr_ystart, chr_yend, xstart, xend, primary
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

from ..constants import MATCH_SCORE
from ..index.build import Index
from ..seed.native import _try_load

_i64p = ctypes.POINTER(ctypes.c_int64)
_i32p = ctypes.POINTER(ctypes.c_int32)
_u8p = ctypes.POINTER(ctypes.c_uint8)


def _setup(lib):
    if getattr(lib, "_batch_setup_done", False):
        return
    lib.thermite_engine_new.restype = ctypes.c_void_p
    lib.thermite_engine_new.argtypes = [
        ctypes.c_void_p,
        _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, _i64p, _i64p, _u8p, _i64p, _i64p,
        _u8p, ctypes.c_int64, ctypes.c_int64, _i64p, _i64p,
        ctypes.c_int64, _i64p, _i64p,
        ctypes.c_int64, _i64p, _i64p, _i64p, _i64p,
        ctypes.c_int64, _i64p, _i64p, _i64p, _i64p,
        ctypes.c_double, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64,
    ]
    lib.thermite_engine_free.argtypes = [ctypes.c_void_p]
    lib.thermite_chunk_build.restype = ctypes.c_void_p
    lib.thermite_chunk_build.argtypes = [
        ctypes.c_void_p, _u8p, ctypes.c_int64, ctypes.c_int64, _i64p,
        ctypes.c_int64, ctypes.c_int64,
    ]
    lib.thermite_chunk_pair.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
    ]
    for name, res in [
        ("thermite_chunk_n_splices", ctypes.c_int64),
        ("thermite_chunk_splice_pairs", _i64p),
        ("thermite_chunk_splice_offs", _i64p),
    ]:
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = [ctypes.c_void_p]
    lib.thermite_chunk_free.argtypes = [ctypes.c_void_p]
    for name, res in [
        ("thermite_chunk_n_reads", ctypes.c_int64),
        ("thermite_chunk_n_problems", ctypes.c_int64),
        ("thermite_chunk_n_tasks", ctypes.c_int64),
        ("thermite_chunk_meta", _i32p),
        ("thermite_chunk_tasks", _i64p),
        ("thermite_chunk_n_selected", ctypes.c_int64),
        ("thermite_chunk_selected", _i64p),
        ("thermite_chunk_n_winners", ctypes.c_int64),
        ("thermite_chunk_winners", _i64p),
    ]:
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = [ctypes.c_void_p]
    lib.thermite_chunk_arbitrate.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, _i32p, _i32p, _i32p,
    ]
    lib.thermite_chunk_finalize.restype = ctypes.c_int64
    lib.thermite_chunk_finalize.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, _i32p, ctypes.c_int64,
        ctypes.c_int64, _i32p,
    ]
    for name, res in [
        ("thermite_chunk_fin_nruns", ctypes.c_int64),
        ("thermite_chunk_fin_runs", _i64p),
        ("thermite_chunk_fin_off", _i64p),
        ("thermite_chunk_tx_nruns", ctypes.c_int64),
        ("thermite_chunk_tx_runs", _i64p),
        ("thermite_chunk_tx_run_off", _i64p),
        ("thermite_chunk_tx_meta", _i64p),
        ("thermite_chunk_fallback", _u8p),
    ]:
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = [ctypes.c_void_p]
    lib.thermite_engine_set_strings.argtypes = [
        ctypes.c_void_p, _u8p, ctypes.c_int64,
        _i64p, ctypes.c_int64,
        _i64p, _i64p, ctypes.c_int64,
        _i64p, _i64p, ctypes.c_int64,
        _i32p,
    ]
    lib.thermite_chunk_emit.restype = ctypes.c_int64
    lib.thermite_chunk_emit.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        _u8p, _i64p, _u8p, _i64p, _u8p, _i64p,
    ]
    lib.thermite_chunk_emit_buf.restype = _u8p
    lib.thermite_chunk_emit_buf.argtypes = [ctypes.c_void_p]
    lib.thermite_swg_stream.restype = ctypes.c_int64
    lib.thermite_swg_stream.argtypes = [
        _u8p, ctypes.c_int64, _u8p, ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64, _i32p, ctypes.c_int64,
    ]
    lib.thermite_chunk_align_cpu.restype = ctypes.c_void_p
    lib.thermite_chunk_align_cpu.argtypes = [
        ctypes.c_void_p, _u8p, ctypes.c_int64, ctypes.c_int64,
        _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64, _i64p, ctypes.c_int64,
    ]
    lib.thermite_chunk_align_cpu_mt.restype = ctypes.c_void_p
    lib.thermite_chunk_align_cpu_mt.argtypes = (
        lib.thermite_chunk_align_cpu.argtypes + [ctypes.c_int64]
    )
    lib.thermite_swg_patch_rows.restype = ctypes.c_int64
    lib.thermite_swg_patch_rows.argtypes = [
        _u8p, ctypes.c_int64, _u8p, ctypes.c_int64,
        _i32p, _i64p, ctypes.c_int64, ctypes.c_int64,
        _i32p, ctypes.c_int64,
    ]
    lib.thermite_prep_reads.restype = None
    lib.thermite_prep_reads.argtypes = [
        _u8p, _i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        _u8p, _i64p,
    ]
    lib.thermite_nib_pack_reads.restype = None
    lib.thermite_nib_pack_reads.argtypes = [
        _u8p, ctypes.c_int64, ctypes.c_int64, _i32p, ctypes.c_int64,
    ]
    lib._batch_setup_done = True


def _blob(parts):
    """-> (concat uint8 blob, int64 offsets of len(parts)+1).

    The offset scan runs at C speed (fromiter+cumsum): a Python
    accumulation loop here cost ~1 µs/record on the emit path — at
    3 blobs (names/seqs/quals) per chunk that was ~10% of the whole
    emit stage."""
    off = np.zeros(len(parts) + 1, np.int64)
    if parts:
        np.cumsum(
            np.fromiter(map(len, parts), np.int64, len(parts)), out=off[1:]
        )
    return np.frombuffer(b"".join(parts), np.uint8), off


def _arr(a, ctype):
    return a.ctypes.data_as(ctype)


class NativeBatchEngine:
    def __init__(self, index: Index, opts, tx_off: np.ndarray,
                 ref_text: np.ndarray, min_seed_len: int, anchor_k: int,
                 seeder=None):
        lib = _try_load()
        _setup(lib)
        self._lib = lib
        self.index = index
        # borrow the seeder's k-mer table instead of building a second
        # one (the table build dominates init at chromosome scale)
        self._seeder = seeder  # keeps the borrowed handle alive
        seeds_h = getattr(seeder, "_h", None) if seeder is not None else None

        refs = index.refs
        n_refs = len(refs)
        ref_start = np.array([r.start_idx for r in refs], np.int64)
        ref_end = np.array([r.end_idx for r in refs], np.int64)
        ref_strand = np.array([1 if r.strand else 0 for r in refs], np.uint8)
        ref_len = np.array([r.len for r in refs], np.int64)
        names = sorted({r.name for r in refs})
        rank_of = {n: i for i, n in enumerate(names)}
        ref_rank = np.array([rank_of[r.name] for r in refs], np.int64)

        txs = index.txome.txs
        tx_exon_off = np.zeros(len(txs) + 1, np.int64)
        exon_start: List[int] = []
        exon_end: List[int] = []
        for i, tx in enumerate(txs):
            tx_exon_off[i] = len(exon_start)
            for e in tx.exons:
                exon_start.append(e.start)
                exon_end.append(e.end)
        tx_exon_off[len(txs)] = len(exon_start)
        exon_start = np.asarray(exon_start, np.int64)
        exon_end = np.asarray(exon_end, np.int64)

        e2t = index.txome.exon_to_tx
        gi = index.txome.gene_intervals

        # keep all arrays alive (the engine copies, but text/ref_text
        # are borrowed)
        self._keep = (
            index.seq_arr, ref_text, ref_start, ref_end, ref_strand,
            ref_len, ref_rank, tx_off, tx_exon_off, exon_start, exon_end,
        )
        tx_off = np.ascontiguousarray(tx_off, np.int64)
        # tx offsets relative to ref_text start (they already are)
        self._h = lib.thermite_engine_new(
            seeds_h,
            _arr(index.seq_arr, _u8p), len(index.seq_arr),
            min_seed_len, anchor_k,
            n_refs, _arr(ref_start, _i64p), _arr(ref_end, _i64p),
            _arr(ref_strand, _u8p), _arr(ref_len, _i64p), _arr(ref_rank, _i64p),
            _arr(ref_text, _u8p), len(ref_text),
            len(txs), _arr(tx_off, _i64p), _arr(tx_exon_off, _i64p),
            len(exon_start),
            _arr(exon_start, _i64p), _arr(exon_end, _i64p),
            len(e2t.starts), _arr(e2t.starts, _i64p), _arr(e2t.ends, _i64p),
            _arr(e2t.data, _i64p), _arr(e2t.max_end_prefix, _i64p),
            len(gi.starts), _arr(gi.starts, _i64p), _arr(gi.ends, _i64p),
            _arr(gi.data, _i64p), _arr(gi.max_end_prefix, _i64p),
            float(opts.min_aln_score_percent), int(opts.min_aln_score),
            int(opts.multimap_score_range), 1 if opts.intron_mode else 0,
            MATCH_SCORE,
        )
        if not self._h:
            if len(ref_text) >= (1 << 34):
                raise NotImplementedError(
                    "reference text >= 16 GiB: nibble-word indices no "
                    "longer fit int32 (see ops/layout.py META_COLS notes)"
                )
            raise RuntimeError("native engine init failed")
        self._tx_off_arr = tx_off

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.thermite_engine_free(self._h)
            self._h = None

    def set_strings(self) -> None:
        """Load the output string tables (ref/gene/tx names + BAM ref
        ids) into the engine — required before emit_chunk."""
        from ..io.sam import unique_refs

        index = self.index
        refs = index.refs
        genes = index.txome.genes
        txs = index.txome.txs
        bam_id = {name: i for i, (name, _) in enumerate(unique_refs(index))}

        parts: List[bytes] = []
        offs = []
        for group in (
            [r.name.encode() for r in refs],
            [g.id.encode() for g in genes],
            [g.name.encode() for g in genes],
            [t.id.encode() for t in txs],
        ):
            base = sum(len(p) for p in parts)
            off = np.zeros(len(group) + 1, np.int64)
            for i, p in enumerate(group):
                off[i + 1] = off[i] + len(p)
            offs.append(off + base)
            parts.extend(group)
        blob = np.frombuffer(b"".join(parts), np.uint8)
        tx_gene = np.array([t.gene_idx for t in txs], np.int64)
        bam_ref = np.array([bam_id[r.name] for r in refs], np.int32)
        self._str_keep = (blob, offs, tx_gene, bam_ref)
        self._lib.thermite_engine_set_strings(
            self._h, _arr(blob, _u8p), len(blob),
            _arr(offs[0], _i64p), len(refs),
            _arr(offs[1], _i64p), _arr(offs[2], _i64p), len(genes),
            _arr(offs[3], _i64p), _arr(tx_gene, _i64p), len(txs),
            _arr(bam_ref, _i32p),
        )
        self._strings_set = True

    def emit_chunk(self, ch, fmt_bam, names, seqs, quals,
                   strip_tags: bool = False):
        """Serialize every record of a finalized chunk in C++ (SAM text
        lines, BAM record blobs, or PAF rows) — returns bytes, or None
        if any selected hit the stream fallback (caller uses the Python
        object path).  ``fmt_bam``: False = SAM, True = BAM, 2 = PAF
        (unmapped reads emit nothing).  ``strip_tags`` drops
        TX/GX/GN/RE (the embedding wrapper surface, reference
        src/wrapper.rs:136-139)."""
        if not getattr(self, "_strings_set", False):
            self.set_strings()
        nb, noff = _blob(names)
        sb, soff = _blob(seqs)
        qb, qoff = _blob(quals)
        fmt = (2 if fmt_bam == 2 else 1 if fmt_bam else 0) | (
            0x100 if strip_tags else 0
        )
        n = self._lib.thermite_chunk_emit(
            self._h, ch, fmt,
            _arr(nb, _u8p), _arr(noff, _i64p),
            _arr(sb, _u8p), _arr(soff, _i64p),
            _arr(qb, _u8p), _arr(qoff, _i64p),
        )
        if n < 0:
            return None
        buf = self._lib.thermite_chunk_emit_buf(ch)
        return ctypes.string_at(buf, n)

    def prep_reads(
        self, reads: list, rows: int, rpad: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """One native pass over the chunk's reads: uppercase each into
        the zero-padded (rows, rpad) block + lengths (replaces a Python
        per-read fill loop)."""
        concat = np.frombuffer(b"".join(reads), np.uint8)
        offs = np.zeros(len(reads) + 1, np.int64)
        if reads:
            np.cumsum(
                np.fromiter(map(len, reads), np.int64, len(reads)),
                out=offs[1:],
            )
        pad = np.empty((rows, rpad), np.uint8)
        lens = np.empty(max(len(reads), 1), np.int64)
        self._lib.thermite_prep_reads(
            _arr(concat, _u8p) if len(concat) else _u8p(),
            _arr(offs, _i64p), len(reads), rows, rpad,
            _arr(pad.reshape(-1), _u8p), _arr(lens, _i64p),
        )
        return pad, lens

    def nib_pack_reads(self, block: np.ndarray) -> np.ndarray:
        """Native twin of ops/layout.pack_reads_nib_host (bit-
        identical by test) for the per-chunk upload pack."""
        from ..ops.layout import _WPAD, nib_lw

        flat = np.ascontiguousarray(block.reshape(-1))
        lw = nib_lw(len(flat))
        out = np.empty(lw, np.int32)
        self._lib.thermite_nib_pack_reads(
            _arr(flat, _u8p), len(flat), _WPAD, _arr(out, _i32p), lw
        )
        return out

    def build_chunk(
        self, reads_pad: np.ndarray, read_lens: np.ndarray, n_reads: int,
        budget: int, paired: bool = False,
    ) -> Tuple[object, int, np.ndarray, np.ndarray]:
        """-> (chunk handle, n_consumed, meta (P,8) i32, tasks (T,10) i64).

        ``paired``: reads are interleaved R1/R2 and the budget only cuts
        at pair boundaries, so both mates always share a chunk."""
        lib = self._lib
        rpad = reads_pad.shape[1]
        if reads_pad.size >= (1 << 31):
            raise NotImplementedError(
                "padded read block >= 2 GiB needs the int64 offset path "
                "(problems are encoded as int32 gather offsets)"
            )
        ch = lib.thermite_chunk_build(
            self._h, _arr(reads_pad, _u8p), n_reads, rpad,
            _arr(read_lens, _i64p), budget, 1 if paired else 0,
        )
        n_consumed = lib.thermite_chunk_n_reads(ch)
        P = lib.thermite_chunk_n_problems(ch)
        T = lib.thermite_chunk_n_tasks(ch)
        meta = np.ctypeslib.as_array(lib.thermite_chunk_meta(ch), (P, 9)).copy() \
            if P else np.zeros((0, 9), np.int32)
        tasks = np.ctypeslib.as_array(lib.thermite_chunk_tasks(ch), (T, 10)).copy() \
            if T else np.zeros((0, 10), np.int64)
        return ch, int(n_consumed), meta, tasks

    def arbitrate(
        self, ch, scores: np.ndarray, mi: np.ndarray, mj: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """-> (selected (S,11) i64, winner pids (W,) i64)."""
        lib = self._lib
        scores = np.ascontiguousarray(scores, np.int32)
        mi = np.ascontiguousarray(mi, np.int32)
        mj = np.ascontiguousarray(mj, np.int32)
        lib.thermite_chunk_arbitrate(
            self._h, ch, _arr(scores, _i32p), _arr(mi, _i32p), _arr(mj, _i32p)
        )
        S = lib.thermite_chunk_n_selected(ch)
        W = lib.thermite_chunk_n_winners(ch)
        sel = np.ctypeslib.as_array(lib.thermite_chunk_selected(ch), (S, 11)).copy() \
            if S else np.zeros((0, 11), np.int64)
        pids = np.ctypeslib.as_array(lib.thermite_chunk_winners(ch), (W,)).copy() \
            if W else np.zeros(0, np.int64)
        return sel, pids

    def finalize(self, ch, tb_out: np.ndarray, tb_meta: np.ndarray):
        """Decode+stitch+lift all selected alignments in C++.

        -> (fin_runs, fin_off, tx_runs, tx_off, tx_meta (S,5), fallback (S,))
        Runs are (op << 32) | len int64; op 0..3 = M/S/D/I, 4 = SC, 5 = N.
        """
        lib = self._lib
        tb_out = np.ascontiguousarray(tb_out, np.int32)
        tb_meta = np.ascontiguousarray(tb_meta, np.int32)
        n_rows = tb_out.shape[0]
        pw = tb_out.shape[1] - 4
        rc = lib.thermite_chunk_finalize(
            self._h, ch, _arr(tb_out, _i32p), n_rows, pw, _arr(tb_meta, _i32p)
        )
        if rc != 0:
            if rc <= -1000000:
                raise AssertionError(
                    f"native finalize: traceback row out of range for "
                    f"selected #{-rc - 1000000}"
                )
            raise AssertionError(
                f"native finalize: span-only arbitration disagrees with "
                f"traceback (selected #{-rc - 1})"
            )
        S = lib.thermite_chunk_n_selected(ch)
        NF = lib.thermite_chunk_fin_nruns(ch)
        NT = lib.thermite_chunk_tx_nruns(ch)
        z = np.zeros(0, np.int64)
        fin_runs = np.ctypeslib.as_array(lib.thermite_chunk_fin_runs(ch), (NF,)).copy() if NF else z
        fin_off = np.ctypeslib.as_array(lib.thermite_chunk_fin_off(ch), (S + 1,)).copy()
        tx_runs = np.ctypeslib.as_array(lib.thermite_chunk_tx_runs(ch), (NT,)).copy() if NT else z
        tx_off = np.ctypeslib.as_array(lib.thermite_chunk_tx_run_off(ch), (S + 1,)).copy()
        tx_meta = np.ctypeslib.as_array(lib.thermite_chunk_tx_meta(ch), (S, 5)).copy() if S else np.zeros((0, 5), np.int64)
        fallback = np.ctypeslib.as_array(lib.thermite_chunk_fallback(ch), (S,)).copy() if S else np.zeros(0, np.uint8)
        return fin_runs, fin_off, tx_runs, tx_off, tx_meta, fallback

    def patch_rows(
        self, meta: np.ndarray, pids: np.ndarray, reads_pad: np.ndarray,
        ref_text: np.ndarray, tb_full: np.ndarray,
    ) -> None:
        """Recompute `pids` stream rows with the C++ scalar banded-SWG
        oracle (exact reference semantics at the ORIGINAL band) and
        splice them into the device output array in place.  Used to
        patch narrow-band certificate failures / flagged walks."""
        from ..ops.layout import _WPAD

        meta = np.ascontiguousarray(meta, np.int32)
        pids = np.ascontiguousarray(pids, np.int64)
        assert tb_full.dtype == np.int32 and tb_full.flags.c_contiguous
        pw = tb_full.shape[1] - 4
        rc = self._lib.thermite_swg_patch_rows(
            _arr(ref_text, _u8p), len(ref_text),
            _arr(reads_pad.reshape(-1), _u8p), reads_pad.size,
            _arr(meta, _i32p), _arr(pids, _i64p), len(pids),
            _WPAD, _arr(tb_full, _i32p), pw,
        )
        if rc != 0:
            raise AssertionError(
                f"native SWG patch: {rc} walk overflows (pw={pw} too small)"
            )

    def pair_chunk(self, ch, max_insert: int, rescue: bool) -> None:
        """FR pairing decision over an interleaved R1/R2 chunk (the C++
        twin of align/paired.py select_pair; must run between finalize
        and emit_chunk).  ``rescue`` marks one-mate-unmapped pairs for
        the Python mate-rescue + splice path."""
        self._lib.thermite_chunk_pair(
            self._h, ch, int(max_insert), 1 if rescue else 0
        )

    def splices(self, ch) -> Tuple[np.ndarray, np.ndarray]:
        """-> (pair indices, emit byte offsets) of pairs the C++ emitter
        skipped for Python handling (valid after emit_chunk)."""
        lib = self._lib
        n = lib.thermite_chunk_n_splices(ch)
        if not n:
            z = np.zeros(0, np.int64)
            return z, z
        pairs = np.ctypeslib.as_array(
            lib.thermite_chunk_splice_pairs(ch), (n,)
        ).copy()
        offs = np.ctypeslib.as_array(
            lib.thermite_chunk_splice_offs(ch), (n,)
        ).copy()
        return pairs, offs

    def free_chunk(self, ch) -> None:
        self._lib.thermite_chunk_free(ch)
