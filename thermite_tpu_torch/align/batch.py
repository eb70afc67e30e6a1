"""Batched alignment pipeline on PyTorch and CUDA.

The port of the reference ``thermite_tpu/align/batch.py`` on its main
path: the C++ engine builds each chunk's extension problems, one launch
of the CUDA stream kernel scores and walks every nontrivial problem,
the packed headers come back to the host, narrow-band certificate
failures are recomputed at full band by the C++ scalar SWG, the C++
engine arbitrates, only the winners' op streams are gathered on the
device and copied back, and the C++ engine finalizes and emits records.
Outputs are identical to the reference pipeline's
(tests/test_torch_batch.py).

Chunks flow through a 3-stage software pipeline (build -> device ->
arbitrate/finalize) two deep: while the card runs chunk k the host
builds chunk k+1 and finalizes chunk k-1.  Device results cross to the
host by non-blocking copies into pinned memory, each followed by a CUDA
event that the host waits on where it needs the values.
"""

from __future__ import annotations

import gc
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from thermite_tpu.align.driver import AlignOpts, concat_to_chr_aln
from thermite_tpu.align.extend import stitch
from thermite_tpu.align.types import (
    EXONIC,
    INTERGENIC,
    INTRONIC,
    Alignment,
    GenomeAlignment,
    Mem,
    RunOps,
)
from thermite_tpu.index.build import Index
from thermite_tpu.index.txome import lift_tx_to_gx
from thermite_tpu.utils.stats import PipelineStats

from .. import device as _device
from ..ops import _build
from ..ops.layout import (
    _WPAD,
    expand_stream_hdr,
    nib_lw,
    pack_meta_host,
    pack_text_nib_host,
)
from ..ops.swg_stream import BAND_MAX, swg_stream


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _pow2_bucket(n: int, lo: int) -> int:
    m = lo
    while m < n:
        m *= 2
    return m


class _HostCopy:
    """A device-to-host copy in flight: a non-blocking copy into pinned
    memory and a CUDA event after it.  ``wait()`` is the sync point and
    returns the numpy view.  A CPU tensor is its own host copy."""

    def __init__(self, t: torch.Tensor):
        self._event = None
        if t.device.type == "cuda":
            self._host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            self._host.copy_(t, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
        else:
            self._host = t

    def wait(self) -> np.ndarray:
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


@dataclass
class _ChunkState:
    """Per-chunk state flowing through build -> device -> arbitrate ->
    finalize."""

    reads: List[bytes]
    native_ch: object = None  # C++ chunk handle
    meta_all: Optional[np.ndarray] = None  # (P, 9) problem meta
    tasks_arr: Optional[np.ndarray] = None  # (T, 10) int64
    reads_host: Optional[np.ndarray] = None  # padded read block (rows, RPAD)
    reads_dev: Optional[torch.Tensor] = None  # nibble-packed read block
    fwd_idx: Optional[np.ndarray] = None  # pids sent to the kernel, by row
    hdr: Optional[_HostCopy] = None  # packed headers in flight
    fwd_streams: Optional[torch.Tensor] = None  # device op streams (Nb, PW)
    inv_rows: Optional[np.ndarray] = None  # pid -> device row (-1 none)
    patched: Optional[np.ndarray] = None  # pids recomputed at full band
    tb_full: Optional[np.ndarray] = None  # pid-indexed stream rows
    selected_arr: Optional[np.ndarray] = None  # (S, 11) int64
    pid_list: Optional[np.ndarray] = None  # winner problem ids
    gather: Optional[_HostCopy] = None  # winners' streams in flight
    gather_pids: Optional[np.ndarray] = None


@dataclass
class _Task:
    """One native task row (C++ T_* column layout), for the host
    recompute of a flagged stream."""

    read_i: int
    kind: str  # 'gx' | 'tx'
    hit: Mem
    left_pid: int
    right_pid: int
    ref_len: int
    seq_start: int
    tx_idx: int


class BatchAligner:
    # Chunks are cut by problem count, just under a power-of-two bucket
    # of kernel rows (65536), so row padding stays a few percent.
    PROBLEM_BUDGET = 65536 - 2048
    PIPELINE_DEPTH = 2

    def __init__(self, index: Index, opts: AlignOpts, device="cuda"):
        self.device = _device.resolve(device)
        self.index = index
        self.opts = opts
        # problems are submitted at band min(band, narrow_band); the
        # kernel certifies each result exact at any wider band, and the
        # C++ scalar SWG recomputes the rest at the original band
        self.narrow_band = 15
        self.stats = PipelineStats()
        # sticky shape maxima (raised per batch, never lowered)
        self._RPAD = self._XMAX = self._YMAX = 0
        self._SMAX = self._SMAX_HOST = self._NFWD1 = self._NREADS = 0
        self._est_chunk_reads = self.PROBLEM_BUDGET // 4
        self._ref_cols_c = None

        _build.native_engine()
        from thermite_tpu.align.native_batch import NativeBatchEngine
        from thermite_tpu.seed.kmer import MAX_ANCHOR_K
        from thermite_tpu.seed.native import make_seeder

        self.seeder = make_seeder(
            index.seq_arr, opts.min_seed_len,
            table=getattr(index, "seed_table", None),
            stride_known=getattr(index, "seed_stride", None),
        )
        # resident reference text: concatenated genome (fwd+rc, with $
        # sentinels) followed by every transcript's spliced sequence
        txs = index.txome.txs
        self.tx_off = np.zeros(len(txs) + 1, np.int64)
        base = len(index.seq_arr)
        for i, tx in enumerate(txs):
            self.tx_off[i] = base
            base += len(tx.seq)
        self.tx_off[len(txs)] = base
        rt = getattr(index, "ref_text_arr", None)
        if rt is not None and len(rt) == self.tx_off[len(txs)]:
            self._ref_text_host = np.asarray(rt)
        else:
            self._ref_text_host = np.concatenate(
                [index.seq_arr] + [np.frombuffer(tx.seq, np.uint8) for tx in txs]
            )
        self._ref_text_dev = None  # device copy, uploaded on first use
        if not getattr(index, "text_acgtn_ok", False):
            # the nibble-packed device text has codes for ACGTN$ only
            from thermite_tpu.index.build import acgtn_counts

            counts = acgtn_counts(self._ref_text_host)
            counts[list(b"ACGTN$") + [0]] = 0
            if counts.sum():
                bad = [chr(b) for b in np.flatnonzero(counts)[:5]]
                raise NotImplementedError(
                    f"reference text contains non-ACGTN$ bytes ({bad}...): "
                    "the nibble-packed device text cannot represent them"
                )
        self.native = NativeBatchEngine(
            index, opts, self.tx_off, self._ref_text_host,
            opts.min_seed_len, min(MAX_ANCHOR_K, opts.min_seed_len),
            seeder=self.seeder if hasattr(self.seeder, "_h") else None,
        )

    # ------------------------------------------------------------------
    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        """Host array -> device tensor (through pinned memory, async)."""
        t = torch.from_numpy(np.require(arr, requirements=["C", "W"]))
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        return t

    def _ref_text(self) -> torch.Tensor:
        """Device-resident nibble-packed reference text (Lw,) int32."""
        if self._ref_text_dev is None:
            lw = nib_lw(len(self._ref_text_host))
            nib = getattr(self.index, "text_nib_arr", None)
            if nib is None or len(nib) != lw:
                nib = pack_text_nib_host(self._ref_text_host)
            self._ref_text_dev = self._upload(nib)
        return self._ref_text_dev

    def _reads_bucket(self, n: int) -> int:
        """Sticky power-of-two row count of the uploaded read block."""
        self._NREADS = max(_pow2_bucket(max(n, 1), 256), self._NREADS)
        return self._NREADS

    # ------------------------------------------------------------------
    def align_batch(self, reads: List[bytes]) -> List[List[GenomeAlignment]]:
        out: List[List[GenomeAlignment]] = []
        self._pipeline(reads, lambda st, s0: out.extend(self._finalize_chunk(st)))
        return out

    def align_batch_emit(self, recs, fmt_bam, strip_tags: bool = False) -> bytes:
        """``recs`` is a list of (name, seq, qual) byte tuples; returns
        the concatenated record bytes (SAM lines, BAM record blobs or PAF
        rows for ``fmt_bam`` False / True / 2; no header) in input order,
        emitted by the C++ engine.  A chunk where a stream needed the
        host fallback is serialized by the Python writers instead, with
        the same bytes."""
        chunks: List[bytes] = []

        def fin(st, start):
            tb_out = self._take_tb(st)
            self.native.finalize(st.native_ch, tb_out, st.meta_all)
            sl = recs[start : start + len(st.reads)]
            raw = self.native.emit_chunk(
                st.native_ch, fmt_bam,
                [r[0] for r in sl], [r[1] for r in sl], [r[2] or b"" for r in sl],
                strip_tags=strip_tags,
            )
            if raw is not None:
                self.native.free_chunk(st.native_ch)
                st.native_ch = None
                chunks.append(raw)
                return
            st.tb_full = tb_out  # fall back to the object path
            results = self._finalize_chunk(st)
            chunks.append(_serialize_records(
                self.index, recs[start : start + len(results)], results,
                fmt_bam, strip_tags=strip_tags,
            ))

        self._pipeline([r[1] for r in recs], fin)
        return b"".join(chunks)

    def _pin_shapes(self, reads: List[bytes]) -> None:
        """Raise every sticky shape to the batch's worst case up front,
        so one batch runs one kernel shape and one set of buffer sizes
        (the caching allocator then reuses them chunk after chunk).
        Small batches skip it."""
        if len(reads) * 4 < self.PROBLEM_BUDGET:
            return
        maxlen = max(map(len, reads), default=1)
        ms = max(
            int(self.opts.min_aln_score_percent * float(maxlen)),
            self.opts.min_aln_score,
        )
        band = max(maxlen - ms, 1)
        kband = min(band, self.narrow_band)
        self._XMAX = max(_round_up(maxlen, 32), self._XMAX)
        self._YMAX = max(_round_up(maxlen + kband + 1, 32), self._YMAX)
        # device rows carry narrow-band walks only; original-band
        # certificate patches land in the wider host array
        self._SMAX = max(_round_up(maxlen + (maxlen + kband + 1) + 2, 16),
                         self._SMAX)
        self._SMAX_HOST = max(_round_up(maxlen + (maxlen + band + 1) + 2, 16),
                              self._SMAX, self._SMAX_HOST)
        self._NFWD1 = max(_pow2_bucket(self.PROBLEM_BUDGET + 1024, 128),
                          self._NFWD1)
        self._NREADS = max(
            _pow2_bucket(min(len(reads), self.PROBLEM_BUDGET), 256), self._NREADS
        )

    def _pipeline(self, reads: List[bytes], finalize_fn) -> None:
        """The 3-stage chunk loop; ``finalize_fn(st, start_read_index)``
        consumes each chunk in input order.  The generational GC is
        paused for the batch: finalize retains many small objects, and
        every gen-0 collection would re-traverse them."""
        gc_was_enabled = gc.isenabled()
        if gc_was_enabled:
            gc.disable()
        try:
            self._pipeline_inner(reads, finalize_fn)
        finally:
            if gc_was_enabled:
                gc.enable()

    def _pipeline_inner(self, reads: List[bytes], finalize_fn) -> None:
        built: List[Optional[_ChunkState]] = []
        starts: List[int] = []
        arb_i = fin_i = i = 0
        self._RPAD = max(_round_up(max(map(len, reads), default=1), 32),
                         self._RPAD)
        self._pin_shapes(reads)
        depth = self.PIPELINE_DEPTH
        while i < len(reads) or not built:
            with self.stats.stage("build"):
                starts.append(i)
                st, i = self._build_chunk(reads, i)
            self._dispatch_forward(st)
            self.stats.chunks += 1
            self.stats.reads += len(st.reads)
            self.stats.problems += len(st.meta_all)
            self.stats.tasks += len(st.tasks_arr)
            built.append(st)
            if len(built) - arb_i >= depth:
                with self.stats.stage("arbitrate"):
                    self._arbitrate_chunk(built[arb_i])
                arb_i += 1
            if arb_i - fin_i >= depth:
                with self.stats.stage("finalize"):
                    finalize_fn(built[fin_i], starts[fin_i])
                built[fin_i] = None
                fin_i += 1
        while arb_i < len(built):
            with self.stats.stage("arbitrate"):
                self._arbitrate_chunk(built[arb_i])
            arb_i += 1
        while fin_i < len(built):
            with self.stats.stage("finalize"):
                finalize_fn(built[fin_i], starts[fin_i])
            built[fin_i] = None
            fin_i += 1

    # ------------------------------------------------------------------
    def _build_chunk(self, all_reads: List[bytes], start: int
                     ) -> Tuple[_ChunkState, int]:
        # offer a bit more than the running reads-per-chunk estimate so
        # the problem budget, not the offer, usually cuts the chunk
        est = self._est_chunk_reads
        take = min(len(all_reads) - start, max(256, (est * 5) // 4))
        reads = all_reads[start : start + max(take, 0)]
        RPAD = self._RPAD
        reads_pad, read_lens = self.native.prep_reads(
            reads, _pow2_bucket(max(len(reads), 1), 256), RPAD
        )
        ch, consumed, meta, tasks = self.native.build_chunk(
            reads_pad, read_lens, len(reads), self.PROBLEM_BUDGET,
        )
        if consumed == take and start + consumed < len(all_reads):
            self._est_chunk_reads = est * 2  # budget not reached: grow
        elif consumed < take:
            # budget-limited chunk: the real reads-per-chunk estimate (a
            # tail chunk must not shrink it)
            self._est_chunk_reads = consumed
        st = _ChunkState(reads=reads[:consumed], native_ch=ch, meta_all=meta,
                         tasks_arr=tasks, reads_host=reads_pad)
        rows = self._reads_bucket(max(consumed, 1))
        if rows <= len(reads_pad):
            upload = reads_pad[:rows]
        else:
            upload = np.zeros((rows, RPAD), np.uint8)
            upload[: len(reads_pad)] = reads_pad
        st.reads_dev = self._upload(self.native.nib_pack_reads(upload))
        return st, start + consumed

    def _pack_meta(self, meta: np.ndarray) -> np.ndarray:
        """4-column packed meta when every field fits its packed range
        (the kernel takes both forms)."""
        try:
            return pack_meta_host(meta)
        except ValueError:
            return meta

    def _narrow_meta(self, meta: np.ndarray) -> np.ndarray:
        """Device copy of the problem meta: band capped at narrow_band
        and ylen re-clamped to the narrowed xlen + band + 1 column bound.
        x_drop stays the original value (the certificate reasons about
        it)."""
        out = meta.copy()
        np.minimum(out[:, 7], self.narrow_band, out=out[:, 7])
        np.minimum(out[:, 3], out[:, 6] + out[:, 7] + 1, out=out[:, 3])
        return out

    def _shapes(self, meta: np.ndarray) -> Tuple[int, int]:
        """Sticky window maxima (XMAX, YMAX), multiples of 32."""
        self._XMAX = max(_round_up(int(meta[:, 6].max(initial=1)), 32), 32,
                         self._XMAX)
        self._YMAX = max(_round_up(int(meta[:, 3].max(initial=1)), 32), 32,
                         self._YMAX)
        return self._XMAX, self._YMAX

    @staticmethod
    def _pad_meta(meta: np.ndarray, N: int) -> np.ndarray:
        """Pad to N rows; padding rows are empty problems (band 1)."""
        out = np.zeros((N, meta.shape[1]), np.int32)
        out[:, 2] = 1  # y_dir
        out[:, 5] = 1  # x_dir
        out[:, 7] = 1  # band
        out[:, 8] = 1  # x_drop
        out[: len(meta)] = meta
        return out

    def _dispatch_forward(self, st: _ChunkState) -> None:
        """Launch the stream kernel on every nontrivial problem of the
        chunk and start the copy of its headers to the host."""
        meta_all = st.meta_all
        meta_dev = self._narrow_meta(meta_all)
        XMAX, YMAX = self._shapes(meta_dev)
        # empty-flank problems have a known result (score 0, cell
        # (0, 0)) and never reach the device
        nontriv = (meta_dev[:, 6] > 0) & (meta_dev[:, 3] > 0)
        st.fwd_idx = np.flatnonzero(nontriv)
        # neighbouring kernel rows get similar column counts
        order = np.argsort(meta_dev[st.fwd_idx, 3], kind="stable")
        st.fwd_idx = st.fwd_idx[order]
        sub = meta_dev[st.fwd_idx]
        bmax = int(sub[:, 7].max(initial=1))
        if bmax > BAND_MAX:
            raise NotImplementedError(
                f"band {bmax} > {BAND_MAX} needs the general stream kernel "
                "(ROADMAP.md Queue 2, item 2); lower narrow_band"
            )
        nb = max(_pow2_bucket(max(len(sub), 1), 128), self._NFWD1)
        self._NFWD1 = nb
        meta = self._pad_meta(sub, nb)
        self.stats.dp_cells += len(meta) * YMAX * (32 if bmax <= 15 else 64)
        orig = meta_all[st.fwd_idx]
        # full-band-equivalent cells (the fair GCUPS numerator)
        self.stats.dp_cells_ref += int(
            np.sum(orig[:, 3] * (2 * orig[:, 7] + 1), dtype=np.int64)
        )
        # device rows bound the narrowed walks; original-band patches
        # are host-written into a wider array (_forward_results)
        self._SMAX = max(
            _round_up(int((sub[:, 6] + sub[:, 3]).max(initial=1)) + 2, 16),
            self._SMAX,
        )
        self._SMAX_HOST = max(
            _round_up(int((orig[:, 6] + orig[:, 3]).max(initial=1)) + 2, 16),
            self._SMAX, self._SMAX_HOST,
        )
        words = self._ref_text()
        hdr, st.fwd_streams = swg_stream(
            words, words.shape[0], st.reads_dev,
            self._upload(self._pack_meta(meta)), XMAX, YMAX, self._SMAX,
        )
        st.hdr = _HostCopy(hdr)
        inv = np.full(len(meta_all), -1, np.int32)
        inv[st.fwd_idx] = np.arange(len(st.fwd_idx), dtype=np.int32)
        st.inv_rows = inv

    def _forward_results(self, st: _ChunkState):
        """Wait for the headers; -> pid-indexed (score, max_i, max_j).

        Certificate failures and flagged walks are recomputed exactly at
        the original band by the C++ scalar SWG and spliced into the
        pid-indexed host rows, which are sized for original-band walks."""
        n = len(st.meta_all)
        with self.stats.dsync("arbitrate"):
            sub = st.hdr.wait()[: len(st.fwd_idx)]
        st.hdr = None
        pw_host = max(self._SMAX_HOST // 16, int(st.fwd_streams.shape[1]))
        full = np.zeros((n, 4 + pw_host), np.int32)
        full[st.fwd_idx, :4] = expand_stream_hdr(sub)
        bad = np.flatnonzero(full[:, 3] < 0)
        if len(bad):
            self.native.patch_rows(
                st.meta_all, bad, st.reads_host, self._ref_text_host, full,
            )
            self.stats.cert_patches += len(bad)
        st.patched = bad
        st.tb_full = full
        return full[:, 0], full[:, 1], full[:, 2]

    def _arbitrate_chunk(self, st: _ChunkState) -> None:
        scores, max_i, max_j = self._forward_results(st)
        st.selected_arr, st.pid_list = self.native.arbitrate(
            st.native_ch, scores, max_i, max_j
        )
        self.stats.winners += len(st.pid_list)
        self._dispatch_stream_gather(st)

    def _dispatch_stream_gather(self, st: _ChunkState) -> None:
        """Gather the winners' op streams out of the device-resident
        chunk output and start their copy to the host; the rest never
        leave the card."""
        streams, st.fwd_streams = st.fwd_streams, None
        pids = np.asarray(st.pid_list, np.int64)
        if len(pids) == 0:
            return
        rows = st.inv_rows[pids]
        keep = rows >= 0
        if len(st.patched):
            keep &= ~np.isin(pids, st.patched)
        if not keep.any():
            return
        st.gather_pids = pids[keep]
        idx = self._upload(rows[keep].astype(np.int64))
        st.gather = _HostCopy(streams.index_select(0, idx))

    def _take_tb(self, st: _ChunkState) -> np.ndarray:
        """The pid-indexed stream rows for finalize, with the winners'
        gathered streams (synced here) merged in."""
        tb_out, st.tb_full = st.tb_full, None
        if st.gather is not None:
            with self.stats.dsync("finalize"):
                g = st.gather.wait()
            st.gather = None
            tb_out[st.gather_pids, 4 : 4 + g.shape[1]] = g
            st.gather_pids = None
        return tb_out

    # ------------------------------------------------------------------
    _ALN_TYPES = (EXONIC, INTRONIC, INTERGENIC)

    def _finalize_chunk(self, st: _ChunkState) -> List[List[GenomeAlignment]]:
        """Decode, stitch and lift the chunk's selected alignments in C++
        and build the result objects."""
        results: List[List[GenomeAlignment]] = [[] for _ in st.reads]
        if len(st.selected_arr):
            fin_data = self.native.finalize(st.native_ch, self._take_tb(st),
                                            st.meta_all)
            self._objects_from_native(st, fin_data, results)
        st.tb_full = None
        self.native.free_chunk(st.native_ch)
        st.native_ch = None
        return results

    def _objects_from_native(self, st: _ChunkState, fin_data, results) -> None:
        sel = st.selected_arr
        fin_runs, fin_off, tx_runs, tx_off, tx_meta, fallback = fin_data
        rl, rn, rs = self._ref_cols()
        from thermite_tpu.align import objbuild

        # C object builder: the same instances via tp_alloc + slot
        # stores; fallback rows come back as None placeholders
        nfall = objbuild.build(
            sel, fin_runs, fin_off, tx_runs, tx_off, tx_meta, fallback,
            st.tasks_arr[:, 9], rn, rs, rl, [len(r) for r in st.reads],
            results,
        )
        if nfall is not None:
            if nfall:
                for s in np.flatnonzero(fallback):
                    self.stats.stream_fallbacks += 1
                    lst = results[int(sel[s, 0])]
                    lst[lst.index(None)] = self._finalize_selected_fallback(
                        st, int(s), sel[s]
                    )
            return
        # the builder is unavailable: the same objects from Python
        sel_rows = sel.tolist()
        fin_runs, fin_off = fin_runs.tolist(), fin_off.tolist()
        tx_runs, tx_off, tx_meta = tx_runs.tolist(), tx_off.tolist(), tx_meta.tolist()
        task_tx = st.tasks_arr[:, 9].tolist()
        for s, row in enumerate(sel_rows):
            (ri, ti, atype, gene, refid, score, ys, ye, xs, xe, prim) = row
            if fallback[s]:
                self.stats.stream_fallbacks += 1
                results[ri].append(self._finalize_selected_fallback(st, s, sel[s]))
                continue
            xlen = len(st.reads[ri])
            gruns = fin_runs[fin_off[s] : fin_off[s + 1]]
            gx_aln = Alignment(score, ys, xs, ye, xe, rl[refid], xlen,
                               RunOps(gruns), gruns)
            tx_aln = None
            if atype == 0:
                tm = tx_meta[s]
                truns = tx_runs[tx_off[s] : tx_off[s + 1]]
                tx_aln = Alignment(score, tm[0], tm[2], tm[1], tm[3], tm[4],
                                   xlen, RunOps(truns), truns)
            results[ri].append(GenomeAlignment(
                gx_aln, self._ALN_TYPES[atype], rn[refid], rs[refid],
                bool(prim), tx_aln, task_tx[ti] if atype == 0 else None,
                gene if atype == 1 else None,
            ))

    def _ref_cols(self):
        """(ref lens, names, strands) parallel lists, cached."""
        if self._ref_cols_c is None:
            refs = self.index.refs
            self._ref_cols_c = (
                [r.len for r in refs], [r.name for r in refs],
                [r.strand for r in refs],
            )
        return self._ref_cols_c

    def _finalize_selected_fallback(self, st: _ChunkState, s: int, row):
        """Host recompute of a selected alignment whose stream the C++
        finalize flagged (not expected): full scalar SWG of both flanks."""
        from thermite_tpu.ops.swg_ref import SwgExtend

        (ri, ti, atype, gene, refid, score, ys, ye, xs, xe, prim) = (
            int(v) for v in row
        )
        t = st.tasks_arr[ti]
        task = _Task(
            read_i=ri, kind="tx" if t[1] else "gx",
            hit=Mem(int(t[2]), int(t[3]), int(t[4])),
            left_pid=int(t[5]), right_pid=int(t[6]), ref_len=int(t[7]),
            seq_start=int(t[8]), tx_idx=int(t[9]),
        )
        ops_by_pid = {}
        for pid in (task.left_pid, task.right_pid):
            m = st.meta_all[pid]
            x, y = self._problem_bytes(st, m)
            band, xd = int(m[7]), int(m[8])
            ops_by_pid[pid] = SwgExtend(band).extend(x, y, band, xd)
        ref = self.index.refs[refid]
        read = st.reads[ri]
        ga = GenomeAlignment(
            gx_aln=Alignment(
                score=score, ystart=ys, xstart=xs, yend=ye, xend=xe,
                ylen=ref.len, xlen=len(read), operations=[],
            ),
            aln_type=self._ALN_TYPES[atype], ref_name=ref.name,
            strand=ref.strand, primary=bool(prim),
            tx_idx=task.tx_idx if atype == 0 else None,
            gene_idx=gene if atype == 1 else None,
        )
        left, right = ops_by_pid[task.left_pid], ops_by_pid[task.right_pid]
        stitched = stitch(left, right, task.hit, task.ref_len, len(read))
        if ga.aln_type == EXONIC:
            lifted = lift_tx_to_gx(stitched, self.index.txome.txs[task.tx_idx])
            chr_aln = concat_to_chr_aln(self.index, lifted)
            ga.tx_aln = stitched
        else:
            stitched.ystart += task.seq_start
            stitched.yend += task.seq_start
            chr_aln = concat_to_chr_aln(self.index, stitched)
        if (chr_aln.ystart, chr_aln.yend, chr_aln.score) != (
            ga.gx_aln.ystart, ga.gx_aln.yend, ga.gx_aln.score,
        ):
            raise AssertionError("span-only arbitration disagrees with traceback")
        ga.gx_aln = chr_aln
        return ga

    def _problem_bytes(self, st: _ChunkState, meta_row) -> Tuple[bytes, bytes]:
        """Host reconstruction of a problem's x/y windows."""
        yw, ys, yd, yl, xb, xd, xl = (int(v) for v in meta_row[:7])
        yb = 8 * yw + ys - _WPAD
        y = self._ref_text_host[yb + yd * np.arange(yl)].tobytes()
        x = st.reads_host.reshape(-1)[xb + xd * np.arange(xl)].tobytes()
        return x, y


def _serialize_records(index, recs, results, fmt_bam, strip_tags: bool = False
                       ) -> bytes:
    """Python-writer serialization of one chunk's records (the emit
    fallback): ``fmt_bam`` False = SAM, True = BAM, 2 = PAF (unmapped
    reads emit nothing in PAF)."""
    from thermite_tpu.io.bam import encode_bam_record
    from thermite_tpu.io.sam import aln_to_sam_record, unique_refs, unmapped_sam_record

    if fmt_bam == 2:
        from thermite_tpu.io.paf import paf_line

        return b"".join(
            (paf_line(name, seq, aln, len(alns)) + "\n").encode()
            for (name, seq, qual), alns in zip(recs, results) for aln in alns
        )
    ref_ids = {name: i for i, (name, _) in enumerate(unique_refs(index))}
    strip = {"TX", "GX", "GN", "RE"}

    def ser(rec):
        if strip_tags:
            rec.tags = [t for t in rec.tags if t[0] not in strip]
        if fmt_bam:
            return encode_bam_record(rec, ref_ids)
        return (rec.to_line() + "\n").encode()

    out: List[bytes] = []
    for (name, seq, qual), alns in zip(recs, results):
        qual = qual or b""
        if not alns:
            out.append(ser(unmapped_sam_record(name, seq, qual)))
            continue
        for i, aln in enumerate(alns):
            out.append(ser(aln_to_sam_record(index, name, seq, qual, aln,
                                             len(alns), i + 1)))
    return b"".join(out)
