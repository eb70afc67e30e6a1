"""Batched alignment pipeline on PyTorch and CUDA.

The port of the reference ``thermite_tpu/align/batch.py``.  On the main
path the C++ engine builds each chunk's extension problems, one launch
of a CUDA stream kernel scores and walks every nontrivial problem, the
packed headers come back to the host, certificate failures are
recomputed at full band by the C++ scalar SWG, the C++ engine
arbitrates, only the winners' op streams are gathered on the device and
copied back, and the C++ engine finalizes and emits records.  Problems
go to the device at band min(band, THERMITE_NARROW_BAND) (default 15:
the packed kernel); 0 turns the narrowing off, and bands above 31 run on
the general-band kernel.

With ``use_native=False`` the chunk runs without the C++ engine, as the
reference's fallback path does: Python builds the problems, the
forward-scores kernel scores them, Python arbitrates, the stream kernel
walks the winners only (fused rows), and the walks are decoded, stitched
and lifted in Python.  ``align_paired_emit`` runs both mates of each
pair in one interleaved batch whose chunks never split a pair, and pairs
them in C++ (or in Python without the engine).  Outputs of every path
are identical to the reference pipeline's (tests/test_torch_batch.py,
tests/test_torch_batch_full_band.py, tests/test_torch_batch_no_native.py,
tests/test_torch_paired.py).  ``host_engine`` is the host assembly
(seeder, text, C++ engine) that the all-C++ ``CppAligner`` shares.

Chunks flow through a 3-stage software pipeline (build -> device ->
arbitrate/finalize) two deep: while the card runs chunk k the host
builds chunk k+1 and finalizes chunk k-1.  Device results cross to the
host by non-blocking copies into pinned memory, each followed by a CUDA
event that the host waits on where it needs the values.

The aligner's devices are a mesh (``parallel/mesh.py``): ``mesh=`` names
them, and without it the mesh is the one ``device``.  The text and each
chunk's read block are replicated on every device of the mesh, each
launch's rows are split round-robin over them after they were ordered and
padded as one launch, every device keeps its op streams resident and
gathers its own winners, and the host merges headers and winners' streams
in input order.  One device is the mesh of one entry, on the same code.
"""

from __future__ import annotations

import gc
import os
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from ..constants import MATCH_SCORE
from ..index.build import Index, acgtn_counts
from ..index.span_lift import lift_tx_span_to_gx
from ..index.txome import lift_mem_to_tx, lift_tx_to_gx
from ..io.bam import encode_bam_record
from ..io.paf import paf_line
from ..io.sam import aln_to_sam_record, unique_refs, unmapped_sam_record
from ..ops.layout import (
    _WPAD,
    expand_stream_hdr,
    nib_lw,
    pack_meta_host,
    pack_reads_nib_host,
    pack_text_nib_host,
)
from ..ops.runs import decode_stream_batch
from ..ops.swg_ref import SwgExtend
from ..ops.swg_stream import PACKED_BAND_MAX
from ..parallel.mesh import (
    check_mesh,
    merge_rows,
    replicate,
    scatter_rows,
    sharded_forward,
    sharded_stream,
)
from ..seed.kmer import MAX_ANCHOR_K
from ..seed.native import make_seeder
from ..utils.stats import PipelineStats
from . import objbuild
from .driver import AlignOpts, concat_to_chr_aln, filter_overlapping
from .extend import extend_seed_match, stitch
from .native_batch import NativeBatchEngine
from .paired import STRIP_TAGS, pair_serializer, splice_pairs
from .types import (
    EXONIC,
    INTERGENIC,
    INTRONIC,
    Alignment,
    GenomeAlignment,
    Mem,
    RunOps,
)


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def _pow2_bucket(n: int, lo: int) -> int:
    m = lo
    while m < n:
        m *= 2
    return m


class _HostCopy:
    """The row blocks of the mesh's devices on their way to the host: per
    device a non-blocking copy into pinned memory and a CUDA event after
    it.  ``wait()`` is the sync point: it waits for the devices in mesh
    order and returns the ``n_rows`` rows merged in input order
    (``merge_rows``).  A CPU tensor is its own host copy."""

    def __init__(self, parts, n_rows: int, index=None):
        self._parts = [self._start(p) for p in parts]
        self._n_rows, self._index = n_rows, index

    @staticmethod
    def _start(t: torch.Tensor):
        if t.device.type != "cuda":
            return t, None
        if t.numel() == 0:
            return torch.empty(t.shape, dtype=t.dtype), None
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        # on the tensor's device, which need not be the current one
        event.record(torch.cuda.current_stream(t.device))
        return host, event

    def wait(self) -> np.ndarray:
        for _, event in self._parts:
            if event is not None:
                event.synchronize()
        return merge_rows([host.numpy() for host, _ in self._parts],
                          self._n_rows, self._index)


class _Problems:
    """Extension problems of a chunk built in Python, one 9-int32 meta
    row each (``layout.META_COLS``): gather offsets into the resident
    nibble-packed text and the chunk's read block."""

    __slots__ = ("rows",)

    def __init__(self):
        self.rows: List[Tuple[int, ...]] = []

    def add(self, y_base, y_dir, ylen, x_base, x_dir, xlen, band, x_drop) -> int:
        lo = y_base + _WPAD
        self.rows.append(
            (lo >> 3, lo & 7, y_dir, ylen, x_base, x_dir, xlen, band, x_drop)
        )
        return len(self.rows) - 1

    def meta(self) -> np.ndarray:
        return np.asarray(self.rows, np.int32).reshape(len(self.rows), 9)

    def __len__(self):
        return len(self.rows)


@dataclass
class _ChunkState:
    """Per-chunk state flowing through build -> device -> arbitrate ->
    finalize."""

    reads: List[bytes]
    # Python build (no C++ engine)
    problems: _Problems = field(default_factory=_Problems)
    tasks: List["_Task"] = field(default_factory=list)
    read_params: List[Tuple[int, int, int]] = field(default_factory=list)
    per_read_tasks: List[List["_Task"]] = field(default_factory=list)
    selected: List[List[Tuple[GenomeAlignment, "_Task"]]] = field(
        default_factory=list
    )
    fwd: Optional[_HostCopy] = None  # forward scores (Nb, 4) in flight
    tb: Optional[_HostCopy] = None  # winners' fused stream rows in flight
    tb_idx: Optional[np.ndarray] = None  # winner slots sent to the kernel
    tb_meta_sub: Optional[np.ndarray] = None  # winners' meta rows
    # C++ engine
    native_ch: object = None  # C++ chunk handle
    meta_all: Optional[np.ndarray] = None  # (P, 9) problem meta
    tasks_arr: Optional[np.ndarray] = None  # (T, 10) int64
    reads_host: Optional[np.ndarray] = None  # padded read block (rows, RPAD)
    # nibble-packed read block: its replicas, one per mesh entry
    reads_dev: Optional[list] = None
    fwd_idx: Optional[np.ndarray] = None  # pids sent to the kernel, by row
    hdr: Optional[_HostCopy] = None  # packed headers in flight
    # device op streams: each mesh entry's (Nb / n, PW)
    fwd_streams: Optional[list] = None
    inv_rows: Optional[np.ndarray] = None  # pid -> device row (-1 none)
    patched: Optional[np.ndarray] = None  # pids recomputed at full band
    tb_full: Optional[np.ndarray] = None  # pid-indexed stream rows
    selected_arr: Optional[np.ndarray] = None  # (S, 11) int64
    pid_list: Optional[np.ndarray] = None  # winner problem ids
    gather: Optional[_HostCopy] = None  # winners' streams in flight
    gather_pids: Optional[np.ndarray] = None


@dataclass
class _Task:
    """One alignment task: a seed hit and its left/right extension
    problems (built in Python, or decoded from a native task row)."""

    read_i: int
    kind: str  # 'gx' | 'tx'
    hit: Mem  # window-relative (gx) or tx-relative (tx)
    left_pid: int
    right_pid: int
    ref_len: int  # window length (gx) or len(tx.seq)
    seq_start: int = 0  # gx: window start in concatenated coords
    abs_hit: Optional[Mem] = None  # gx: absolute hit (for classification)
    tx_idx: int = -1
    # filled after scoring (Python arbitration):
    score: int = 0
    span: Tuple[int, int, int, int] = (0, 0, 0, 0)  # ystart, yend, xstart, xend


@dataclass
class HostEngine:
    """The host side that the batch pipeline and the all-C++ engine
    (``align/cpu.py``) share: the seeder, the offsets of the transcripts
    in the reference text, the text itself (genome fwd+rc with $
    sentinels, then every transcript's spliced sequence) and the C++
    build/arbitrate/finalize/emit engine (None when not asked for)."""

    seeder: object
    tx_off: np.ndarray
    ref_text: np.ndarray
    native: object


def host_engine(index: Index, opts: AlignOpts, use_native: bool = True
                ) -> HostEngine:
    """Assemble the ``HostEngine`` of ``index`` (reference
    ``BatchAligner.__init__``, ``batch.py:186-302``).  The text must be
    ACGTN$ only: the nibble-packed device text has no other codes.  A C++
    engine that fails to load raises."""
    seeder = make_seeder(
        index.seq_arr, opts.min_seed_len,
        table=getattr(index, "seed_table", None),
        stride_known=getattr(index, "seed_stride", None),
    )
    txs = index.txome.txs
    tx_off = np.zeros(len(txs) + 1, np.int64)
    base = len(index.seq_arr)
    for i, tx in enumerate(txs):
        tx_off[i] = base
        base += len(tx.seq)
    tx_off[len(txs)] = base
    rt = getattr(index, "ref_text_arr", None)
    if rt is not None and len(rt) == tx_off[len(txs)]:
        text = np.asarray(rt)
    else:
        text = np.concatenate(
            [index.seq_arr] + [np.frombuffer(tx.seq, np.uint8) for tx in txs]
        )
    if not getattr(index, "text_acgtn_ok", False):
        counts = acgtn_counts(text)
        counts[list(b"ACGTN$") + [0]] = 0
        if counts.sum():
            bad = [chr(b) for b in np.flatnonzero(counts)[:5]]
            raise NotImplementedError(
                f"reference text contains non-ACGTN$ bytes ({bad}...): "
                "the nibble-packed device text cannot represent them"
            )
    native = None
    if use_native:
        native = NativeBatchEngine(
            index, opts, tx_off, text,
            opts.min_seed_len, min(MAX_ANCHOR_K, opts.min_seed_len),
            seeder=seeder if hasattr(seeder, "_h") else None,
        )
    return HostEngine(seeder, tx_off, text, native)


class BatchAligner:
    # Chunks are cut by problem count, just under a power-of-two bucket
    # of kernel rows (65536), so row padding stays a few percent.
    # THERMITE_PROBLEM_BUDGET overrides it per aligner.
    PROBLEM_BUDGET = 65536 - 2048
    PIPELINE_DEPTH = 2

    def __init__(self, index: Index, opts: AlignOpts, device="cuda",
                 use_native: bool = True, mesh=None):
        # mesh: a tuple of torch devices (parallel.mesh.make_mesh); it
        # then names the devices, and ``device`` is not read.  The same
        # device may stand in it more than once.  None: the mesh of the
        # one ``device``, one launch a chunk.
        self.mesh = check_mesh((device,) if mesh is None else mesh)
        self.device = self.mesh[0]
        # launch rows pad to a multiple of the mesh size
        self._nsh = len(self.mesh)
        self.index = index
        self.opts = opts
        # problems are submitted at band min(band, narrow_band); the
        # kernel certifies each result exact at any wider band, and the
        # C++ scalar SWG recomputes the rest at the original band.  0
        # submits the original bands (no narrowing); narrowing needs the
        # C++ engine.
        self.narrow_band = int(os.environ.get("THERMITE_NARROW_BAND", "15"))
        # chunks in flight between build and finalize: 2 overlaps the
        # card with the host stages, 1 runs them in turn.  The reference
        # also picks 1 by itself from a chunk's build time, for a one-core
        # host whose device runtime polls on that core; not taken here.
        _pd = os.environ.get("THERMITE_PIPELINE_DEPTH", "")
        self.pipeline_depth = int(_pd) if _pd else self.PIPELINE_DEPTH
        _pb = os.environ.get("THERMITE_PROBLEM_BUDGET", "")
        if _pb:
            self.PROBLEM_BUDGET = int(_pb)
        self.stats = PipelineStats()
        # sticky shape maxima (raised per batch, never lowered)
        self._RPAD = self._XMAX = self._YMAX = self._W = 0
        self._SMAX = self._SMAX_HOST = self._NREADS = 0
        self._NFWD1 = self._NFWD = self._NTB = 0
        self._seg = None  # sticky lane width class (_packed_seg)
        self._est_chunk_reads = self.PROBLEM_BUDGET // 4
        self._ref_cols_c = None

        eng = host_engine(index, opts, use_native)
        self.seeder, self.tx_off = eng.seeder, eng.tx_off
        self._ref_text_host, self.native = eng.ref_text, eng.native
        # device copies, one per mesh entry, uploaded on first use
        self._ref_text_dev = None

    def _narrowing(self) -> bool:
        return self.native is not None and self.narrow_band > 0

    # ------------------------------------------------------------------
    def _ref_text(self) -> list:
        """Device-resident nibble-packed reference text (Lw,) int32: its
        replicas, one per mesh entry."""
        if self._ref_text_dev is None:
            lw = nib_lw(len(self._ref_text_host))
            nib = getattr(self.index, "text_nib_arr", None)
            if nib is None or len(nib) != lw:
                nib = pack_text_nib_host(self._ref_text_host)
            self._ref_text_dev = replicate(self.mesh, nib)
        return self._ref_text_dev

    def _rows_bucket(self, n: int, sticky: int) -> int:
        """Row count of a launch of ``n`` problems: a power of two from
        128, never below the sticky count, a multiple of the mesh size."""
        return _round_up(max(_pow2_bucket(max(n, 1), 128), sticky), self._nsh)

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
        host fallback, and every chunk without the C++ engine, is
        serialized by the Python writers instead, with the same bytes."""
        chunks: List[bytes] = []

        def fin(st, start):
            if st.native_ch is None:
                results = self._finalize_chunk(st)
                chunks.append(_serialize_records(
                    self.index, recs[start : start + len(results)], results,
                    fmt_bam, strip_tags=strip_tags,
                ))
                return
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

    def align_paired_emit(self, pair_recs, fmt_bam, max_insert: int = 1000,
                          mate_rescue: bool = True,
                          strip_tags: bool = False) -> bytes:
        """Paired-end emit (reference ``batch.py:414-544``): ``pair_recs``
        is a list of ((name, seq, qual) R1, (name, seq, qual) R2) byte
        tuples; returns the SAM lines or BAM record blobs (no header) in
        input-pair order, mate fields filled (FLAG 0x1/0x2/0x8/0x20/0x40/
        0x80, RNEXT, PNEXT, TLEN) as ``pair_records`` fills them.

        Both mates ride one interleaved batch, so each chunk's device pass
        covers both.  The C++ engine decides the FR pairs and emits the
        records; the pairs it leaves for mate rescue (one mate unmapped)
        are serialized by ``pair_records`` and the Python writers and
        spliced into its bytes at the offsets it reports.  Chunks without
        the C++ engine (or whose emit fell back) are paired and
        serialized in Python.  ``stats`` counts ``emit_cpp_chunks``,
        ``spliced_pairs`` and ``emit_py_chunks``."""
        recs = [rec for pair in pair_recs for rec in pair]
        ser_pair = pair_serializer(self.index, fmt_bam, max_insert,
                                   self.opts if mate_rescue else None,
                                   strip_tags)
        stats = self.stats
        chunks: List[bytes] = []

        def pair_bytes(base, results, p):
            r1, r2 = pair_recs[base + p]
            return ser_pair(r1, r2, results[2 * p], results[2 * p + 1])

        def fin(st, start):
            if start % 2 or len(st.reads) % 2:
                raise AssertionError("a chunk split a read pair")
            base = start // 2
            if st.native_ch is not None:
                tb_out = self._take_tb(st)
                fin_data = self.native.finalize(st.native_ch, tb_out,
                                                st.meta_all)
                self.native.pair_chunk(st.native_ch, max_insert, mate_rescue)
                sl = recs[start : start + len(st.reads)]
                raw = self.native.emit_chunk(
                    st.native_ch, fmt_bam, [r[0] for r in sl],
                    [r[1] for r in sl], [r[2] or b"" for r in sl],
                    strip_tags=strip_tags,
                )
                if raw is not None:
                    pairs_idx, offs = self.native.splices(st.native_ch)
                    self.native.free_chunk(st.native_ch)
                    st.native_ch = None
                    stats.emit_cpp_chunks = getattr(stats, "emit_cpp_chunks", 0) + 1
                    stats.spliced_pairs = (getattr(stats, "spliced_pairs", 0)
                                           + len(pairs_idx))
                    if len(pairs_idx):
                        # objects only for the reads of the spliced pairs
                        want = {2 * p + m for p in pairs_idx.tolist()
                                for m in (0, 1)}
                        results = [[] for _ in st.reads]
                        self._objects_from_native(st, fin_data, results, want)
                        raw = splice_pairs(
                            raw, pairs_idx, offs,
                            lambda p: pair_bytes(base, results, p))
                    chunks.append(raw)
                    return
                st.tb_full = tb_out  # fall back to the object path
            results = self._finalize_chunk(st)
            stats.emit_py_chunks = getattr(stats, "emit_py_chunks", 0) + 1
            chunks.append(b"".join(pair_bytes(base, results, p)
                                   for p in range(len(results) // 2)))

        self._pipeline([r[1] for r in recs], fin, paired=True)
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
        kband = min(band, self.narrow_band) if self._narrowing() else band
        self._XMAX = max(_round_up(maxlen, 32), self._XMAX)
        self._YMAX = max(_round_up(maxlen + kband + 1, 32), self._YMAX)
        self._W = max(_round_up(2 * kband + 1, 128), 128, self._W)
        # device rows carry narrow-band walks only; original-band
        # certificate patches land in the wider host array
        self._SMAX = max(_round_up(maxlen + (maxlen + kband + 1) + 2, 16),
                         self._SMAX)
        self._SMAX_HOST = max(_round_up(maxlen + (maxlen + band + 1) + 2, 16),
                              self._SMAX, self._SMAX_HOST)
        nb = self._rows_bucket(self.PROBLEM_BUDGET + 1024, 0)
        self._NFWD1, self._NFWD, self._NTB = (
            max(nb, v) for v in (self._NFWD1, self._NFWD, self._NTB))
        self._NREADS = max(
            _pow2_bucket(min(len(reads), self.PROBLEM_BUDGET), 256), self._NREADS
        )

    def _pipeline(self, reads: List[bytes], finalize_fn,
                  paired: bool = False) -> None:
        """The 3-stage chunk loop; ``finalize_fn(st, start_read_index)``
        consumes each chunk in input order.  ``paired``: the reads are
        interleaved mates (R1, R2, R1, ...) and chunks cut only at pair
        boundaries.  The generational GC is paused for the batch:
        finalize retains many small objects, and every gen-0 collection
        would re-traverse them."""
        gc_was_enabled = gc.isenabled()
        if gc_was_enabled:
            gc.disable()
        try:
            self._pipeline_inner(reads, finalize_fn, paired)
        finally:
            if gc_was_enabled:
                gc.enable()

    def _pipeline_inner(self, reads: List[bytes], finalize_fn,
                        paired: bool) -> None:
        built: List[Optional[_ChunkState]] = []
        starts: List[int] = []
        arb_i = fin_i = i = 0
        self._RPAD = max(_round_up(max(map(len, reads), default=1), 32),
                         self._RPAD)
        self._pin_shapes(reads)
        depth = self.pipeline_depth
        while i < len(reads) or not built:
            with self.stats.stage("build"):
                starts.append(i)
                st, i = self._build_chunk(reads, i, paired)
            self._dispatch_forward(st)
            self.stats.chunks += 1
            self.stats.reads += len(st.reads)
            self.stats.problems += len(st.meta_all)
            self.stats.tasks += len(
                st.tasks if st.tasks_arr is None else st.tasks_arr)
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
    def _build_chunk(self, all_reads: List[bytes], start: int,
                     paired: bool = False) -> Tuple[_ChunkState, int]:
        if self.native is None:
            return self._build_chunk_py(all_reads, start, paired)
        # offer a bit more than the running reads-per-chunk estimate so
        # the problem budget, not the offer, usually cuts the chunk
        est = self._est_chunk_reads
        take = min(len(all_reads) - start, max(256, (est * 5) // 4))
        if paired and take % 2:
            # never offer half a pair: with an even offer the C++ build's
            # pair-boundary budget cuts consume whole pairs
            take += 1 if start + take < len(all_reads) else -1
        reads = all_reads[start : start + max(take, 0)]
        RPAD = self._RPAD
        reads_pad, read_lens = self.native.prep_reads(
            reads, _pow2_bucket(max(len(reads), 1), 256), RPAD
        )
        ch, consumed, meta, tasks = self.native.build_chunk(
            reads_pad, read_lens, len(reads), self.PROBLEM_BUDGET,
            paired=paired,
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
        st.reads_dev = replicate(self.mesh,
                                 self.native.nib_pack_reads(upload))
        return st, start + consumed

    def _build_chunk_py(self, all_reads: List[bytes], start: int,
                        paired: bool = False) -> Tuple[_ChunkState, int]:
        """The chunk build without the C++ engine (reference
        ``batch.py:683-788``): seed each read, and for every hit make a
        genome task and one task per transcript the hit lies in, each
        with a left and a right extension problem.  ``paired`` cuts only
        at pair boundaries."""
        opts, index = self.opts, self.index
        st = _ChunkState(reads=[])
        reads, problems = st.reads, st.problems
        pos = start
        while pos < len(all_reads) and (
                len(problems) < self.PROBLEM_BUDGET
                or (paired and len(reads) % 2)):
            read = all_reads[pos].upper()
            pos += 1
            reads.append(read)
            ri = len(reads) - 1
            min_aln_score = max(
                int(opts.min_aln_score_percent * float(len(read))),
                opts.min_aln_score,
            )
            band = max(len(read) - min_aln_score, 0)
            x_drop = band
            st.read_params.append((min_aln_score, band, x_drop))
            read_off = ri * self._RPAD
            rtasks: List[_Task] = []
            for hit in self.seeder.all_smems(read):
                aln_ref, _ = index.idx_to_ref(hit.ref_idx)
                # genome window (reference src/aligner.rs:209-227)
                seq_start = max(hit.ref_idx - (len(read) + band),
                                aln_ref.start_idx)
                seq_end = min(hit.ref_idx + hit.len + len(read) + band,
                              aln_ref.end_idx - 1)
                lp, rp = self._extend_problems(
                    problems, hit.ref_idx, hit.len, seq_start, seq_end,
                    read_off, hit.query_idx, len(read), band, x_drop,
                )
                rtasks.append(_Task(
                    read_i=ri, kind="gx",
                    hit=Mem(hit.ref_idx - seq_start, hit.query_idx, hit.len),
                    left_pid=lp, right_pid=rp, ref_len=seq_end - seq_start,
                    seq_start=seq_start, abs_hit=hit,
                ))
                # transcriptome candidates (src/aligner.rs:230-258)
                tx_idxs = sorted(set(index.txome.exon_to_tx.find(
                    hit.ref_idx, hit.ref_idx + hit.len).tolist()))
                for tx_idx in tx_idxs:
                    tx = index.txome.txs[tx_idx]
                    tx_seed = extend_seed_match(tx.seq, lift_mem_to_tx(hit, tx),
                                                read)
                    base = int(self.tx_off[tx_idx])
                    y_lo_tx = max(tx_seed.ref_idx - (len(read) + band), 0)
                    lp, rp = self._extend_problems(
                        problems, base + tx_seed.ref_idx, tx_seed.len,
                        base + y_lo_tx, base + len(tx.seq),
                        read_off, tx_seed.query_idx, len(read), band, x_drop,
                    )
                    rtasks.append(_Task(
                        read_i=ri, kind="tx", hit=tx_seed, left_pid=lp,
                        right_pid=rp, ref_len=len(tx.seq), abs_hit=hit,
                        tx_idx=tx_idx,
                    ))
            st.per_read_tasks.append(rtasks)
            st.tasks.extend(rtasks)

        reads_pad = np.zeros((self._reads_bucket(len(reads)), self._RPAD),
                             np.uint8)
        for ri, r in enumerate(reads):
            reads_pad[ri, : len(r)] = np.frombuffer(r, np.uint8)
        st.reads_host = reads_pad
        st.reads_dev = replicate(
            self.mesh, pack_reads_nib_host(reads_pad.reshape(-1)))
        st.meta_all = problems.meta()
        return st, pos

    @staticmethod
    def _extend_problems(problems, seed_y, seed_len, y_lo, y_hi, read_off,
                         q_idx, read_len, band, x_drop):
        """Right and (reversed) left extension problems of a seed
        (reference src/aligner.rs:352-375) as gather offsets; ylen is
        clamped to xlen + band + 1, past which no cell exists."""
        xlen_r = read_len - q_idx - seed_len
        yb_r = seed_y + seed_len
        ylen_r = max(min(y_hi - yb_r, xlen_r + band + 1), 0)
        rp = problems.add(yb_r, 1, ylen_r, read_off + q_idx + seed_len, 1,
                          xlen_r, band, x_drop)
        xlen_l = q_idx
        ylen_l = max(min(seed_y - y_lo, xlen_l + band + 1), 0)
        lp = problems.add(seed_y - 1, -1, ylen_l, read_off + q_idx - 1, -1,
                          xlen_l, band, x_drop)
        return lp, rp

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

    def _shapes(self, meta: np.ndarray) -> Tuple[int, int, int]:
        """Sticky window maxima (XMAX, YMAX), multiples of 32, and the
        reference's lane width W = roundup(2b+1, 128)."""
        self._XMAX = max(_round_up(int(meta[:, 6].max(initial=1)), 32), 32,
                         self._XMAX)
        self._YMAX = max(_round_up(int(meta[:, 3].max(initial=1)), 32), 32,
                         self._YMAX)
        self._W = max(_round_up(2 * int(meta[:, 7].max(initial=1)) + 1, 128),
                      128, self._W)
        return self._XMAX, self._YMAX, self._W

    def _packed_seg(self, bmax: int) -> int:
        """Sticky lane width class of the reference's stream kernels: 64
        (two problems per 128-lane row) while every band is <= 31, else
        0 (W lanes per problem); it only widens.  It sizes dp_cells, the
        padded cells of the reference's kernel batch."""
        seg = 64 if bmax <= PACKED_BAND_MAX and self._seg != 0 else 0
        self._seg = seg
        return seg

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

    @staticmethod
    def _device_rows(meta: np.ndarray) -> np.ndarray:
        """Indices of the nontrivial problems, ordered by column count
        (neighbouring kernel rows get similar work).  Empty-flank
        problems have a known result (score 0, cell (0, 0)) and never
        reach the device."""
        idx = np.flatnonzero((meta[:, 6] > 0) & (meta[:, 3] > 0))
        return idx[np.argsort(meta[idx, 3], kind="stable")]

    def _dispatch_forward(self, st: _ChunkState) -> None:
        """Launch the chunk's device pass on every nontrivial problem,
        once per mesh entry: the stream kernel (scores and walks; headers
        start their copy to the host) with the C++ engine, the
        forward-scores kernel without."""
        meta_all = st.meta_all
        narrowing = self._narrowing()
        meta_dev = self._narrow_meta(meta_all) if narrowing else meta_all
        XMAX, YMAX, W = self._shapes(meta_dev)
        st.fwd_idx = self._device_rows(meta_dev)
        sub = meta_dev[st.fwd_idx]
        bmax = int(sub[:, 7].max(initial=1))
        # shapes, band bound and padding are those of the whole launch:
        # every device of the mesh runs its part at the same shape
        if self.native is None:
            nb = self._NFWD = self._rows_bucket(len(sub), self._NFWD)
            meta = self._pad_meta(sub, nb)
            self.stats.dp_cells += len(meta) * YMAX * W
            st.fwd = _HostCopy(sharded_forward(
                self.mesh, self._ref_text(), st.reads_dev,
                scatter_rows(self.mesh, self._pack_meta(meta)), XMAX, YMAX,
                band_max=bmax), nb)
            return
        seg = self._packed_seg(bmax)
        nb = self._NFWD1 = self._rows_bucket(len(sub), self._NFWD1)
        meta = self._pad_meta(sub, nb)
        self.stats.dp_cells += len(meta) * YMAX * (seg or W)
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
        outs = sharded_stream(
            self.mesh, self._ref_text(), st.reads_dev,
            scatter_rows(self.mesh, self._pack_meta(meta)), XMAX, YMAX,
            self._SMAX, band_max=bmax)
        st.hdr = _HostCopy([hdr for hdr, _ in outs], nb)
        st.fwd_streams = [streams for _, streams in outs]
        inv = np.full(len(meta_all), -1, np.int32)
        inv[st.fwd_idx] = np.arange(len(st.fwd_idx), dtype=np.int32)
        st.inv_rows = inv

    def _forward_results(self, st: _ChunkState):
        """Wait for the device pass; -> pid-indexed (score, max_i, max_j).

        With the C++ engine, certificate failures and flagged walks are
        recomputed exactly at the original band by the C++ scalar SWG and
        spliced into the pid-indexed host rows, which are sized for
        original-band walks."""
        n = len(st.meta_all)
        if self.native is None:
            with self.stats.dsync("arbitrate"):
                sub = st.fwd.wait()[: len(st.fwd_idx)]
            st.fwd = None
            out = np.zeros((n, 3), np.int32)
            out[st.fwd_idx] = sub[:, :3]
            return out[:, 0], out[:, 1], out[:, 2]
        with self.stats.dsync("arbitrate"):
            sub = st.hdr.wait()[: len(st.fwd_idx)]
        st.hdr = None
        pw_host = max(self._SMAX_HOST // 16, int(st.fwd_streams[0].shape[1]))
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
        if self.native is None:
            self._arbitrate_chunk_py(st, scores, max_i, max_j)
            self._dispatch_traceback(st)
            return
        st.selected_arr, st.pid_list = self.native.arbitrate(
            st.native_ch, scores, max_i, max_j
        )
        self.stats.winners += len(st.pid_list)
        self._dispatch_stream_gather(st)

    def _arbitrate_chunk_py(self, st: _ChunkState, scores, max_i, max_j
                            ) -> None:
        """Arbitration on scores and spans only, in Python (reference
        ``batch.py:898-969``): per seed the genome-vs-transcriptome
        choice, then the score filters, the multimap range, the overlap
        filter and the primary; the winners' problem ids go to
        ``st.pid_list``."""
        opts = self.opts
        for task in st.tasks:
            sL, sR = scores[task.left_pid], scores[task.right_pid]
            task.score = int(sL) + MATCH_SCORE * task.hit.len + int(sR)
            l_ye, r_ye = int(max_j[task.left_pid]), int(max_j[task.right_pid])
            l_xe, r_xe = int(max_i[task.left_pid]), int(max_i[task.right_pid])
            task.span = (task.hit.ref_idx - l_ye,
                         task.hit.ref_idx + task.hit.len + r_ye,
                         task.hit.query_idx - l_xe,
                         task.hit.query_idx + task.hit.len + r_xe)
        winner_pids: Dict[int, None] = {}
        for ri, read in enumerate(st.reads):
            min_aln_score = st.read_params[ri][0]
            rtasks = st.per_read_tasks[ri]
            gx_alns: List[Tuple[GenomeAlignment, _Task]] = []
            # tasks per seed: the gx task, then its tx tasks
            i = 0
            while i < len(rtasks):
                gx_task = rtasks[i]
                i += 1
                tx_tasks = []
                while (i < len(rtasks) and rtasks[i].kind == "tx"
                       and rtasks[i].abs_hit == gx_task.abs_hit):
                    tx_tasks.append(rtasks[i])
                    i += 1
                ga, task = self._arbitrate_seed(read, gx_task, tx_tasks)
                if not opts.intron_mode and ga.aln_type != EXONIC:
                    continue
                if (ga.gx_aln.score < opts.min_aln_score
                        or ga.gx_aln.score < min_aln_score):
                    continue
                gx_alns.append((ga, task))
            max_score = max([min_aln_score] + [g.gx_aln.score for g, _ in gx_alns])
            gx_alns = [(g, t) for g, t in gx_alns
                       if g.gx_aln.score >= max_score - opts.multimap_score_range]
            # overlap filter + primary selection on span-only objects
            pair_of = {id(g): t for g, t in gx_alns}
            filtered = filter_overlapping([g for g, _ in gx_alns])
            filtered.sort(key=lambda a: -a.gx_aln.score)
            if filtered:
                filtered[0].primary = True
            sel = [(g, pair_of[id(g)]) for g in filtered]
            st.selected.append(sel)
            for _, t in sel:
                winner_pids[t.left_pid] = None
                winner_pids[t.right_pid] = None
        st.pid_list = list(winner_pids)

    def _arbitrate_seed(self, read, gx_task, tx_tasks):
        """Genome-vs-transcriptome choice for one seed (reference
        src/aligner.rs:263-313), spans only."""
        index = self.index
        aln_ref, _ = index.idx_to_ref(gx_task.abs_hit.ref_idx)
        ref_name, strand = aln_ref.name, aln_ref.strand
        best_tx = None
        for t in tx_tasks:
            if best_tx is None or t.score > best_tx.score:
                best_tx = t
            if t.score >= len(read) * MATCH_SCORE:
                break
        if best_tx is not None and best_tx.score >= gx_task.score:
            tx = index.txome.txs[best_tx.tx_idx]
            ys, ye, xs, xe = best_tx.span
            # trailing soft clip exists iff the query isn't fully consumed
            gys, gye = lift_tx_span_to_gx(ys, ye, tx,
                                          trailing_nonref=xe < len(read))
            chr_aln = _span_to_chr(index, gys, gye, xs, xe, best_tx.score,
                                   len(read))
            return GenomeAlignment(gx_aln=chr_aln, aln_type=EXONIC,
                                   ref_name=ref_name, strand=strand,
                                   tx_idx=best_tx.tx_idx), best_tx
        ys, ye, xs, xe = gx_task.span
        gys, gye = gx_task.seq_start + ys, gx_task.seq_start + ye
        gene_idxs = index.txome.gene_intervals.find(gys, gye)
        chr_aln = _span_to_chr(index, gys, gye, xs, xe, gx_task.score, len(read))
        if len(gene_idxs) == 0:
            return GenomeAlignment(gx_aln=chr_aln, aln_type=INTERGENIC,
                                   ref_name=ref_name, strand=strand), gx_task
        return GenomeAlignment(gx_aln=chr_aln, aln_type=INTRONIC,
                               ref_name=ref_name, strand=strand,
                               gene_idx=int(gene_idxs[0])), gx_task

    def _dispatch_traceback(self, st: _ChunkState) -> None:
        """Walk the winners (without the C++ engine): one launch per mesh
        entry of the stream kernel in the fused form on the nontrivial
        winners, rows copied to the host."""
        if not st.pid_list:
            return
        meta_sub = st.meta_all[np.asarray(st.pid_list, np.int64)]
        st.tb_meta_sub = meta_sub
        self.stats.winners += len(st.pid_list)
        XMAX, YMAX, W = self._shapes(st.meta_all)
        st.tb_idx = self._device_rows(meta_sub)
        sub = meta_sub[st.tb_idx]
        bmax = int(sub[:, 7].max(initial=1))
        seg = self._packed_seg(bmax)
        nb = self._NTB = self._rows_bucket(len(sub), self._NTB)
        meta = self._pad_meta(sub, nb)
        self.stats.dp_cells += len(meta) * YMAX * (seg or W)
        # walk steps of the batch, sticky
        self._SMAX = max(
            _round_up(int((meta_sub[:, 6] + meta_sub[:, 3]).max(initial=1)) + 2,
                      128),
            self._SMAX,
        )
        st.tb = _HostCopy(sharded_stream(
            self.mesh, self._ref_text(), st.reads_dev,
            scatter_rows(self.mesh, self._pack_meta(meta)), XMAX, YMAX,
            self._SMAX, band_max=bmax, fused=True), nb)

    def _traceback_results(self, st: _ChunkState) -> Dict[int, Alignment]:
        """Wait for the winners' rows and decode them; -> pid -> the
        extension's Alignment.  A row the kernel flagged (bad walk) is
        recomputed by the scalar SWG on the host."""
        ops_by_pid: Dict[int, Alignment] = {}
        if not st.pid_list:
            return ops_by_pid
        meta_sub = st.tb_meta_sub
        with self.stats.dsync("finalize"):
            sub = st.tb.wait()[: len(st.tb_idx)]
        st.tb = None
        out = np.zeros((len(st.pid_list), sub.shape[1]), np.int32)
        out[st.tb_idx] = sub
        alns = decode_stream_batch(out, meta_sub[:, 6], meta_sub[:, 3])
        for k, pid in enumerate(st.pid_list):
            aln = alns[k]
            if aln is None:
                self.stats.stream_fallbacks += 1
                x, y = self._problem_bytes(st, meta_sub[k])
                band, xd = int(meta_sub[k, 7]), int(meta_sub[k, 8])
                aln = SwgExtend(band).extend(x, y, band, xd)
            ops_by_pid[pid] = aln
        return ops_by_pid

    def _dispatch_stream_gather(self, st: _ChunkState) -> None:
        """Gather the winners' op streams out of the device-resident
        chunk output, each device its own, and start their copy to the
        host; the rest never leave the card."""
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
        rows = rows[keep].astype(np.int64)
        # row r lives on device r % n at local row r // n
        n = self._nsh
        at = [np.flatnonzero(rows % n == d) for d in range(n)]
        st.gather = _HostCopy(
            [streams[d].index_select(0, _device.upload(rows[at[d]] // n, dev))
             for d, dev in enumerate(self.mesh)], len(rows), at)

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
        """Decode, stitch and lift the chunk's selected alignments (in C++,
        or in Python without the C++ engine) and build the result
        objects."""
        if st.native_ch is None:
            ops_by_pid = self._traceback_results(st)
            return [[self._finalize(read, ga, task, ops_by_pid)
                     for ga, task in st.selected[ri]]
                    for ri, read in enumerate(st.reads)]
        results: List[List[GenomeAlignment]] = [[] for _ in st.reads]
        if len(st.selected_arr):
            fin_data = self.native.finalize(st.native_ch, self._take_tb(st),
                                            st.meta_all)
            self._objects_from_native(st, fin_data, results)
        st.tb_full = None
        self.native.free_chunk(st.native_ch)
        st.native_ch = None
        return results

    def _objects_from_native(self, st: _ChunkState, fin_data, results,
                             want=None) -> None:
        """GenomeAlignment objects of the C++ finalize outputs into
        ``results`` (one list per chunk read).  ``want`` (a set of chunk
        read indices) restricts them to those reads (the paired emit's
        spliced pairs), built in Python; otherwise the C object builder
        builds them all when it is available."""
        sel = st.selected_arr
        fin_runs, fin_off, tx_runs, tx_off, tx_meta, fallback = fin_data
        rl, rn, rs = self._ref_cols()
        if want is None:
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
        # restricted, or the builder is unavailable: the same objects
        # from Python
        sel_rows = sel.tolist()
        fin_runs, fin_off = fin_runs.tolist(), fin_off.tolist()
        tx_runs, tx_off, tx_meta = tx_runs.tolist(), tx_off.tolist(), tx_meta.tolist()
        task_tx = st.tasks_arr[:, 9].tolist()
        for s, row in enumerate(sel_rows):
            (ri, ti, atype, gene, refid, score, ys, ye, xs, xe, prim) = row
            if want is not None and ri not in want:
                continue
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
        return self._finalize(read, ga, task, ops_by_pid)

    def _finalize(self, read, ga, task, ops_by_pid):
        """Attach the walked ops to a span-only winner: stitch the two
        flanks around the seed, lift through the transcript's exons, and
        map to chromosome coordinates."""
        stitched = stitch(ops_by_pid[task.left_pid], ops_by_pid[task.right_pid],
                          task.hit, task.ref_len, len(read))
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
    if fmt_bam == 2:
        return b"".join(
            (paf_line(name, seq, aln, len(alns)) + "\n").encode()
            for (name, seq, qual), alns in zip(recs, results) for aln in alns
        )
    ref_ids = {name: i for i, (name, _) in enumerate(unique_refs(index))}

    def ser(rec):
        if strip_tags:
            rec.tags = [t for t in rec.tags if t[0] not in STRIP_TAGS]
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


def _span_to_chr(index, gys, gye, xs, xe, score, read_len):
    """Concatenated span -> chromosome-coordinate span-only Alignment
    (reference src/aligner.rs:429-449, spans only)."""
    aln_ref, _ = index.idx_to_ref(gys)
    if aln_ref.strand:
        ystart = gys - aln_ref.start_idx
        yend = gye - aln_ref.start_idx
    else:
        ystart = aln_ref.len - (gye - aln_ref.start_idx)
        yend = aln_ref.len - (gys - aln_ref.start_idx)
    return Alignment(score=score, ystart=ystart, xstart=xs, yend=yend,
                     xend=xe, ylen=aln_ref.len, xlen=read_len, operations=[])
