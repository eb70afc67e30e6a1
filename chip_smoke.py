#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (thermite_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # phases 1, 2, 2b, 2c and 2d
    python3 chip_smoke.py --time-kernels OUT.json  # no phases: kernel times
    python3 chip_smoke.py --mesh-only     # phases 1, 3 and 3f: for a host
                                          # with several cards
    python3 chip_smoke.py --genome-only   # phases 1 and 7
    python3 chip_smoke.py --fuzz-only     # phases 1 and 8

Phases, each printed with its own timing; any failure exits non-zero
before the result lines are printed:

1. require CUDA; print the card's name and power limit; build the CUDA
   kernels (one nvcc for each source, in parallel, sm_90a; both stream
   kernels are one source) and the port's own
   C++ host engine (g++, into thermite_tpu_torch/_build/); print the
   registers and spills of every kernel.
2. swg_stream's packed kernel (bands <= 31) == swg_stream_plain
   (bit-exact, tolerance 0) on the same CUDA inputs: fuzz shapes for both
   band classes and meta forms, shapes that cross the sub-warp groups'
   boundaries (bands 7, 8, 15, 16, 31 and mixed in one launch, xlen of 1
   and of XMAX, row counts that fill no last warp, problems that end by
   X-drop at the first columns beside problems that run all theirs), the
   narrow-band certificate shapes, and one full main-path chunk shape
   (65536 rows, XMAX 96, YMAX 128, band <= 15, SMAX 208), with both
   times, the bound and the ragged-warp idle share.
2b. the general-band stream kernel (swg_stream_wide) == swg_stream_plain,
   bit-exact: group-boundary shapes at bands 32, 47, 48, 63 and mixed,
   and at small windows where the narrow groups serve it; fuzz shapes at
   bands <= 63, <= 127 and <= 255 in both meta forms (windows up to 512
   for the widest), bands above XMAX (up to 1023 slots), and the
   full-band chunk shape (65536 rows, XMAX 96, YMAX 160, band 60, SMAX
   256), with both times and the bound.
2c. the forward-scores kernel (swg_forward) == swg_forward_plain,
   bit-exact, on the same kinds of shapes and on shapes that cross its
   per-warp group shapes (a warp's four rows run at 8, 16 or 32 lanes:
   xlen of 1, of XMAX and random and bands mixed in one launch, as
   generated and ordered by ylen, odd row counts, both meta forms), with
   both times at the full-band chunk shape as generated and with its rows
   ordered by ylen, each beside its bound, the share of warps at each
   shape and the idle share of their groups.
2d. the run-length traceback kernel (swg_traceback, swg_traceback_dense)
   == its plain versions, bit-exact: gather fuzz shapes for every group
   shape and slot class in both meta forms, dense shapes (bands above
   XMAX among them), RMAX 1, 4, 24 and 64 with overflow rows and rows of
   exactly RMAX runs, the per-warp group shapes of 2c in both input forms
   (which must agree), and the full-band chunk shape (65536 rows, XMAX 96,
   YMAX 160, band 60, RMAX 24) as generated and, in both input forms, with
   its rows ordered by ylen, with both times.
3. syn45 in memory: a 45 Mbp synthetic spliced chromosome, indexed, and
   49152 truth reads through BatchAligner(device="cuda")
   .align_batch_emit(fmt_bam=True); asserts the packed kernel ran once
   per chunk or more and that more than 90% of reads mapped.
3b. the same reads at full band (narrow_band 0): the BAM bytes equal
   phase 3's, the general-band kernel ran once per chunk or more and the
   packed kernel never; reads/s over 5 runs and the stage split.
3c. the path without the C++ engine (use_native=False) on the first 4096
   reads: the BAM bytes equal the C++ engine's on those reads; the
   forward-scores and general-band kernels each ran once per chunk or
   more.
3f. the mesh path at full width (BatchAligner(mesh=...),
   parallel/mesh.py): the 49152 reads through a mesh of every local card
   (make_mesh(torch.cuda.device_count())) and through a mesh that names
   cuda:0 four times, so that the row split, the four launches a chunk,
   the per-device winners gather and the merge run with the real kernel
   on one card; the BAM bytes equal phase 3's, the packed kernel's launch
   count is 1x and 4x phase 3's, reads/s over 5 runs printed beside phase
   3's, and a profiled run's busy share.  Then 4096 reads at full band and
   4096 without the C++ engine on the four-entry mesh (and, on a host with
   several cards, on the mesh of all of them): the bytes of phases 3b and
   3c on those reads, one launch a mesh entry and chunk of each kernel on
   the path.
4. C++ referee: every row of one syn45 chunk that the kernel certified
   equals the full-band scalar SWG of the C++ engine (native.patch_rows);
   the kernel's time and bound on that chunk in the pipeline's row order,
   and its time with the rows shuffled (what ragged warps cost).
5. oracle referee: the SAM records of the first 200 reads equal the
   sequential oracle's (align/driver.py) through the Python SAM writers.
3d. paired syn45: 24576 FR pairs of 90 bp mates from 300 bp fragments
   (bench.py:138-166) through align_paired_emit to BAM; asserts the
   packed kernel ran once per chunk or more, no chunk fell back to
   Python and more than 90% of primary records are proper pairs; reads/s
   (both mates) over 5 runs; the first 2000 pairs and a mixed set (junk
   and rescuable mates, rescue on) equal the referee: align_batch on the
   interleaved mates, pair_records and the Python writers.
3e. the cpp engine (CppAligner): the first 4096 reads' BAM and the first
   2000 pairs' BAM equal the batch path's; reads/s on the 49152 reads at
   1 thread and at every core (the same-host C++ baseline).
4b. kernel 4 on its own path, the differential check: the phase 4 chunk
   at its original band (60) through the run-length traceback kernel
   (RMAX 24); every row with nruns >= 0 decodes to kernel 2's decoded
   stream row, 2000 sampled rows to the scalar oracle SwgExtend; the
   dense form on the same windows gives the same rows.
6. the user entry points: the index saved and loaded, and the port's CLI
   aligning 2000 reads to SAM, equal to the in-memory emit; the CLI with
   --paired and with --engine cpp, two host shards joined by merge, and
   the wrapper's record surfaces, each equal to its in-memory
   counterpart; the CLI with -v after the subcommand, with --mesh -1, with
   --profile DIR (one trace file that holds a stream_kernel event on the
   card), with --coordinator on two host shards joined by merge, and
   under THERMITE_NO_EMIT=1, each with the bytes of the plain CLI run.
7. genome scale: thermite_tpu_torch.tools.genome_scale at 1.2 Gbp, a
   fwd+rc text of 2.4e9 nibbles, past 2^31: a
   synthetic genome of 200 Mbp chromosomes indexed with a stride-4 seed
   table, its text resident on the card, 16384 truth reads through
   align_batch and align_batch_emit (BAM; the packed kernel must run),
   truth overlap >= 0.99 and 100 reads == the oracle; sampled words of the
   resident text == the host's; one real chunk of that run through the
   packed kernel == swg_stream_plain bit for bit, with rows whose y
   anchor lies at 2^31 nibbles or past, timed beside its bound and beside
   syn45's chunk of phase 4; 4096 of the reads at full band (the
   general-band kernel must run) with the narrowed run's BAM bytes.
8. the adversarial parity fuzz (thermite_tpu_torch.tools.fuzz_parity) on
   phase 3's syn45 index: 2000 mutated 90 bp reads (seed 777) then 2000
   of 40-150 bp (seed 778), with substitutions, indels and N on both
   strands and five edge reads each, in one batch, against the
   sequential oracle (computed once per option set), every read
   identical, each regime on a fresh aligner: a. -s0 narrowed at the
   default budget and at 4096 (align_batch and align_batch_emit's SAM;
   at 4096 after a batch of the 90 bp reads alone, so that the pinned
   shapes grow between batches);
   b. -s0 at full band, where the 32 x 8 group of the general-band
   kernel must be reached; c. -s0 without the C++ engine on 500 + 500 of
   the reads (forward and general-band kernels); d. -s0.66 narrowed on
   the long reads.  One real chunk of long reads of a and one of b
   through the stream kernel == swg_stream_plain bit for bit, timed beside
   its bound, with the pinned shapes and the group shape printed.

Every timed kernel is printed beside its bound: the larger of its
integer operations (cells the plain version computes on the same inputs x
OPS_PER_CELL) over the card's INT32 rate at the SM clock read under load,
and its bytes over the memory rate.  The last lines are one JSON object of
kernel records and one JSON object naming the device.  The packed stream
kernel's record carries its time, plain time and bound on the real syn45
chunk of phase 4, the shape and row order the main path launches it at
(with --kernels-only, phase 2's synthetic chunk shape); the others carry
those of their 65536-row synthetic chunk shape (the forward kernel and
both input forms of the run-length traceback kernel with its rows ordered
by ylen, as a pipeline submits them).  Nothing of JAX or of the JAX
package is imported.

--time-kernels runs no phase and prints no result lines: it builds the
kernels, reads the instruction mix of every kernel's column loops from
the machine code, and times every kernel over 20 launches after 3
warm-up launches on the synthetic chunk shapes (as generated and with
rows ordered by ylen) and on one real syn45 chunk (narrowed and at full
band, in the pipeline's row order and shuffled), into OUT.json.
kernel_ab.py runs that mode of two checkouts in turns on one card.

--genome-only runs phases 1 and 7 and prints no result lines.

--fuzz-only runs phases 1 and 8 (on its own syn45 index) and prints no
result lines.

--mesh-only runs phases 1, 3 and 3f and prints no result lines.  On a host
with several cards phase 3f's first mesh is all of them, so this mode is
the check that launches, copies and events go to the right card.
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SYN_BP = 45_000_000
N_READS = 49152
N_ORACLE = 200
N_NO_NATIVE = 4096
GENOME_GBP = 1.2  # phase 7: a fwd+rc text of 2.4e9 nibbles, past 2^31
N_GENOME_READS = 16384
N_GENOME_SPOT = 100
N_GENOME_FULL = 4096
N_FUZZ = 2000  # phase 8: of each read length class (seeds 777, 778)
N_FUZZ_NO_NATIVE = 1000
FUZZ_BUDGET = 4096


def log(msg: str) -> None:
    print(msg, flush=True)


class PhaseFailed(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


# ---------------------------------------------------------------------------
# synthetic extension problems (numpy, seeded)


def _text_reads(rng, text_len, n_reads, rpad, read_len, indel_every=0):
    """ACGT text with a few N, and reads copied from it with 0-3
    substitutions (some non-ACGTN bytes) and, every `indel_every`-th
    read, a 25-base deletion; -> (text, reads (n, rpad), source pos)."""
    text = rng.choice(np.frombuffer(b"ACGT", np.uint8), text_len)
    text[rng.integers(0, text_len, max(text_len // 250, 1))] = ord("N")
    reads = np.zeros((n_reads, rpad), np.uint8)
    src = rng.integers(200, text_len - 400 - read_len, n_reads)
    for i in range(n_reads):
        p = int(src[i])
        r = text[p : p + read_len].copy()
        for _ in range(int(rng.integers(0, 4))):
            r[int(rng.integers(0, read_len))] = ord("ACGTNX"[int(rng.integers(0, 6))])
        if indel_every and i % indel_every == 0:
            cut = int(rng.integers(20, read_len - 30))
            r = np.concatenate([r[:cut], text[p + cut + 25 : p + 25 + read_len]])
        reads[i, :read_len] = r[:read_len]
    return text, reads, src


def fuzz_problems(seed, n, band_max, XMAX=64, YMAX=96, band_min=0):
    """The reference's kernel fuzz shapes (by default XMAX 64, YMAX 96):
    random windows in both directions, some running into the padding,
    bands drawn from [band_min, band_max]; reads are RPAD = XMAX wide."""
    from thermite_tpu_torch.ops.layout import meta_row

    rng = np.random.default_rng(seed)
    RPAD = XMAX
    text, reads, src = _text_reads(rng, 5000 + 2 * YMAX, 32, RPAD, RPAD)
    rows = []
    for _ in range(n):
        band = int(rng.integers(band_min, band_max + 1))
        xd = int(rng.integers(1, 40))
        q = int(rng.integers(0, RPAD - 1))
        xdir = 1 if rng.random() < 0.5 else -1
        xlen = int(rng.integers(1, XMAX + 1))
        xlen = min(xlen, RPAD - q) if xdir == 1 else min(xlen, q + 1)
        ri = int(rng.integers(0, len(reads)))
        if rng.random() < 0.5:  # y where the read came from: long walks
            p, ydir = int(src[ri]) + q + int(rng.integers(-3, 4)), xdir
        else:
            p = int(rng.integers(0, len(text)))
            ydir = 1 if rng.random() < 0.5 else -1
        ylen = int(rng.integers(1, YMAX + 1))
        if rng.random() < 0.8:
            ylen = max(min(ylen, len(text) - p if ydir == 1 else p + 1), 1)
        rows.append(meta_row(p, ydir, ylen, ri * RPAD + q, xdir, xlen, band, xd))
    return text, reads, np.asarray(rows, np.int32), XMAX, YMAX


def chunk_problems(seed, n, wide=60, narrow=15):
    """Main-path chunk shape: 90 bp flanks built at band `wide` (some
    reads carry a 25-base deletion) and narrowed to `narrow`, as
    BatchAligner._narrow_meta submits them (narrow == wide: the full-band
    path's chunk)."""
    from thermite_tpu_torch.ops.layout import meta_row

    rng = np.random.default_rng(seed)
    RPAD = 96
    text, reads, src = _text_reads(rng, 1 << 20, 4096, RPAD, 90, indel_every=8)
    meta = np.zeros((n, 9), np.int32)
    xlen = rng.integers(1, 91, n)
    ri = rng.integers(0, len(reads), n)
    d = np.where(rng.random(n) < 0.5, 1, -1)
    for i in range(n):
        q = int(rng.integers(0, 91 - xlen[i]))
        if d[i] < 0:  # a left flank: both windows end at q + xlen - 1
            q += int(xlen[i]) - 1
        meta[i] = meta_row(int(src[ri[i]]) + q, int(d[i]),
                           min(int(xlen[i]) + wide + 1, 200),
                           int(ri[i]) * RPAD + q, int(d[i]), int(xlen[i]),
                           wide, wide)
    np.minimum(meta[:, 7], narrow, out=meta[:, 7])
    np.minimum(meta[:, 3], meta[:, 6] + meta[:, 7] + 1, out=meta[:, 3])
    return text, reads, meta, 96, 32 * ((90 + narrow + 1 + 31) // 32)


def boundary_problems(seed, n, bands, XMAX=96, YMAX=128):
    """Problems that cross the kernels' group boundaries: bands drawn from
    `bands` (mixed in one launch), xlen of 1, of XMAX or random, and three
    kinds of y window side by side: where the read came from with a wide
    X-drop (the problem runs all its columns, up to YMAX), the same with
    X-drop 1, and an unrelated window with X-drop 1 (ends at the first
    columns).  `n` is best odd: a last warp carries fewer problems than
    its groups."""
    from thermite_tpu_torch.ops.layout import meta_row

    rng = np.random.default_rng(seed)
    RPAD = XMAX
    text, reads, src = _text_reads(rng, 20000 + 2 * YMAX, 64, RPAD, RPAD)
    rows = []
    for _ in range(n):
        band = int(rng.choice(bands))
        kind = rng.random()
        xlen = 1 if kind < 0.2 else XMAX if kind < 0.45 else \
            int(rng.integers(1, XMAX + 1))
        q = int(rng.integers(0, RPAD - xlen + 1))
        ri = int(rng.integers(0, len(reads)))
        ylen = min(xlen + band + 1, YMAX)
        where = rng.random()
        if where < 0.5:
            p, xd = int(src[ri]) + q, 4000
        elif where < 0.75:
            p, xd = int(src[ri]) + q + int(rng.integers(-2, 3)), 1
        else:
            p, xd = int(rng.integers(0, len(text) - YMAX)), 1
        rows.append(meta_row(p, 1, ylen, ri * RPAD + q, 1, xlen, band, xd))
    return text, reads, np.asarray(rows, np.int32), XMAX, YMAX


def _to_dev(text, reads, meta, dev):
    import torch

    from thermite_tpu_torch.ops.layout import pack_reads_nib_host, pack_text_nib_host

    words = torch.from_numpy(pack_text_nib_host(text)).to(dev)
    rnib = torch.from_numpy(pack_reads_nib_host(reads.reshape(-1))).to(dev)
    return words, rnib, torch.from_numpy(np.ascontiguousarray(meta)).to(dev)


def time_launches(launch, reps=20, warm=0) -> float:
    """ms per call of `launch` by CUDA events over `reps` calls, after
    `warm` calls that are not timed."""
    import torch

    for _ in range(warm):
        launch()
    start, stop = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(reps):
        launch()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def compare_kernel(args, reps, kernel, plain=None):
    """A kernel's wrapper and its plain version on the same CUDA inputs
    -> (rows that differ, max_abs_err, kernel ms or None, plain ms, the
    kernel's output rows on the host).  Stream outputs (hdr, streams)
    are compared as one row of int32 words."""
    import torch

    from thermite_tpu_torch.ops.swg_stream import swg_stream_plain

    plain = plain or swg_stream_plain

    def rows(out):
        return torch.cat(out, 1) if isinstance(out, tuple) else out

    got = rows(kernel(*args))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = rows(plain(*args))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
        if got.numel() else 0
    nbad = int((got != want).any(1).sum())
    ms = time_launches(lambda: kernel(*args), reps) if reps else None
    return nbad, err, ms, plain_ms, got.cpu().numpy()


# Integer operations of the recurrence for one band cell, as the DP core
# (csrc/swg_dp.cuh) writes it.  Without directions 12: C = max(C' + e,
# D' + (e + o)) is 3; x == y, the select of +1 or -1 and its add are 3;
# A = max(diag, C) 1; A - s*e and the running max 2; the insertion chain's
# max(prefix, running) 1 and o + s*e + prefix 1; D = max(A, R) 1; the
# column max 1.  With directions 15: two compares against D and the
# packing shift-or.
OPS_PER_CELL = {True: 15, False: 12}
INT32_LANES_PER_SM = 64  # Hopper white paper: INT32 units per SM
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def sm_clock_mhz(launch, ms):
    """The SM clock that nvidia-smi reads while `launch` keeps the card
    busy: about a second of launches is queued, nvidia-smi runs beside
    them, then the queue is drained; -> (MHz, SM count)."""
    import torch

    for _ in range(max(int(1000 / max(ms, 0.05)), 20)):
        launch()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60)
    torch.cuda.synchronize()
    mhz = float(smi.stdout.strip().splitlines()[0])
    return mhz, torch.cuda.get_device_properties(0).multi_processor_count


def kernel_bound(work_args, meta_np, out_words_per_row, walk, mhz, sms,
                 dense=False):
    """The least time the card could take for this launch -> a dict with
    bound_ms, bound_by and the counts behind them.  Operations: the cells
    the plain version computes on these inputs (columns until each
    problem ends x computed slots) x OPS_PER_CELL, over sms x 64 INT32
    lanes x the SM clock read under load.  Bytes: meta, the window words
    of text and reads (`dense`: the window bytes of x and y and the params
    rows), and the output rows, each once, over the memory rate."""
    import torch

    from thermite_tpu_torch.ops.swg_stream import dp_work_plain, meta9

    cols, cells = dp_work_plain(*work_args)
    cols, cells = cols.cpu().numpy(), cells.cpu().numpy()
    m9 = meta9(torch.from_numpy(np.ascontiguousarray(meta_np))).numpy()
    if dense:
        in_bytes = int((m9[:, 6] + m9[:, 3]).sum()) + 16 * len(m9)
    else:
        in_bytes = 4 * (meta_np.size + int(((m9[:, 6] + 7) // 8
                                            + (m9[:, 3] + 7) // 8).sum()))
    nbytes = in_bytes + 4 * out_words_per_row * len(meta_np)
    ops = int(cells.sum()) * OPS_PER_CELL[walk]
    ops_ms = 1e3 * ops / (sms * INT32_LANES_PER_SM * mhz * 1e6)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops_ms": ops_ms, "bytes_ms": bytes_ms, "cells": int(cells.sum()),
            "cols": cols, "cells_by_row": cells, "band": m9[:, 7],
            "xlen": m9[:, 6], "sm_mhz": mhz}


def ragged_idle(cols: np.ndarray, per_warp: int) -> float:
    """Share of group-columns that idle when `per_warp` neighbouring rows
    share a warp and every group runs the columns of the warp's longest
    problem (the loop's every-eighth-column vote not counted)."""
    n = len(cols) // per_warp * per_warp
    c = cols[:n].reshape(-1, per_warp)
    total = int(c.max(1).sum()) * per_warp
    return 1.0 - float(c.sum()) / total if total else 0.0


def stream_note(b, per_warp: int, order=None) -> str:
    """The ragged-warp idle share of a stream-kernel launch whose warps
    carry `per_warp` problems, in the launch's row order (or `order`)."""
    cols = b["cols"] if order is None else b["cols"][order]
    return (f"{per_warp} problems a warp idle "
            f"{100 * ragged_idle(cols, per_warp):.1f}% of group-columns")


def rows_note(b, order=None) -> str:
    """How a per-warp launch of kernel 3 or 4 fills its warps in the
    launch's row order (or `order`): the share of warps at each group
    shape, the group-columns that idle while a pass runs the columns of
    its longest problem, and the share of a pass's 128 lane-slots that
    hold a band cell, beside that share at one warp a problem."""
    from thermite_tpu_torch.ops.swg_stream import ROWS_PER_WARP, warp_lanes

    cols, cells, band, xlen = (
        b[k] if order is None else b[k][order]
        for k in ("cols", "cells_by_row", "band", "xlen"))
    lanes = warp_lanes(band, xlen)
    c4 = np.concatenate([cols, np.zeros(-len(cols) % ROWS_PER_WARP, cols.dtype)])
    c4 = c4.reshape(-1, ROWS_PER_WARP)
    share, group_cols, pass_cols = [], 0, 0
    for n_lanes in (8, 16, 32):
        g = 32 // n_lanes
        longest = c4[lanes == n_lanes].reshape(-1, ROWS_PER_WARP // g, g).max(2)
        share.append(100 * float(np.mean(lanes == n_lanes)))
        pass_cols += int(longest.sum())
        group_cols += g * int(longest.sum())
    idle = 1.0 - float(cols.sum()) / group_cols if group_cols else 0.0
    fill = float(cells.sum()) / (128 * pass_cols) if pass_cols else 0.0
    alone = float(cells.sum()) / (128 * float(cols.sum())) if cols.sum() else 0.0
    return ("warps at 8/16/32 lanes " + "/".join(f"{v:.1f}" for v in share)
            + f"%, idle {100 * idle:.1f}% of group-columns, "
            f"{100 * fill:.1f}% of lane-slots hold a cell "
            f"({100 * alone:.1f}% at one warp a problem)")


def log_bound(name, ms, b, note=""):
    """One line: the time beside its bound, and `note` on how full the
    warps run in the launch's row order."""
    log(f"  {name}: {ms:.4f} ms; bound {b['bound_ms']:.4f} ms by "
        f"{b['bound_by']} ({b['cells']} cells, operations {b['ops_ms']:.4f} ms "
        f"at {b['sm_mhz']:.0f} MHz, bytes {b['bytes_ms']:.4f} ms); share of "
        f"bound {100 * b['bound_ms'] / ms:.1f}%" + (f"; {note}" if note else ""))


def _nsteps(rows: np.ndarray) -> np.ndarray:
    """nsteps of split stream rows (int16 halves in the first 2 words)."""
    return np.ascontiguousarray(rows[:, :2]).view(np.int16)[:, 3]


def run_cases(dev, cases, kernel, plain=None, stream=True):
    """Each case through compare_kernel (the 65536-row ones timed), the
    kernel's wrapper given the case's band bound as the batch pipeline
    gives it (no device read per launch); -> (worst max_abs_err,
    (ms, plain_ms, bound) of the last timed case)."""
    import torch

    from thermite_tpu_torch.ops.swg_stream import meta9, rows_launch, stream_group

    worst, timing = 0, (None, None, None)
    for name, t, r, m, xm, ym, extra in cases:
        words, rnib, mt = _to_dev(t, r, m, dev)
        bmax = int(meta9(torch.from_numpy(np.ascontiguousarray(m)))[:, 7].max())
        args = (words, words.shape[0], rnib, mt, xm, ym, *extra)
        launch = functools.partial(kernel, band_max=bmax)
        nbad, err, ms, plain_ms, got = compare_kernel(
            args, reps=20 if len(m) == 65536 else 0, kernel=launch, plain=plain)
        if ms is not None:
            mhz, sms = sm_clock_mhz(lambda: launch(*args), ms)
            bound = kernel_bound(args[:6], m, got.shape[1], stream, mhz, sms)
            if stream:
                note = stream_note(bound, 32 // stream_group(bmax, xm)[0])
            else:
                note = rows_note(bound) if rows_launch(bmax, xm) else ""
            log_bound(name, ms, bound, note)
            timing = (ms, plain_ms, bound)
        info = f"XMAX {xm} YMAX {ym}"
        if stream:
            ns = _nsteps(got)
            info += (f" SMAX {extra[0]}, certified {(ns >= 0).sum()}, cert "
                     f"failures {(ns <= -2).sum()}, bad walks {(ns == -1).sum()}")
        else:
            info += f", best score {got[:, 0].max()}"
        t_ms = f", kernel {ms:.4f} ms, plain {plain_ms:.1f} ms" if ms else ""
        log(f"  {name}: {len(m)} rows, {info}; {nbad} differ, "
            f"max_abs_err {err}{t_ms}")
        check(nbad == 0, f"kernel != plain on {name}")
        if name.startswith("certificate"):
            check((_nsteps(got) <= -2).any(),
                  "certificate shapes produced no -2-c rows")
        worst = max(worst, err)
    return worst, timing


def both_meta_forms(name, t, r, m, xm, ym, extra):
    from thermite_tpu_torch.ops.layout import pack_meta_host

    return [(f"{name} 9-col", t, r, m, xm, ym, extra),
            (f"{name} 4-col", t, r, pack_meta_host(m), xm, ym, extra)]


def boundary_cases(specs, smax):
    """(name, seed, n, bands) -> cases of boundary_problems at XMAX 96,
    YMAX 128, the odd ones in the packed meta form."""
    from thermite_tpu_torch.ops.layout import pack_meta_host

    cases = []
    for k, (name, seed, n, bands) in enumerate(specs):
        t, r, m, xm, ym = boundary_problems(seed, n, bands)
        cases.append((f"group boundaries, {name}, {n} rows", t, r,
                      pack_meta_host(m) if k % 2 else m, xm, ym, (smax,)))
    return cases


def phase_kernel(dev):
    """The packed kernel == plain on synthetic cases; -> (worst
    max_abs_err, (ms, plain_ms, bound) at the main-path chunk shape)."""
    from thermite_tpu_torch.ops.layout import pack_meta_host
    from thermite_tpu_torch.ops.swg_stream import swg_stream

    cases = []
    for seed, bmax in ((0, 15), (1, 31)):
        cases += both_meta_forms(f"fuzz band<={bmax}",
                                 *fuzz_problems(seed, 4096, bmax), (256,))
    # 8 lanes x 4 slots up to band 15 (four problems a warp), 16 x 4 up
    # to band 31 (two); row counts that fill no last warp, and fewer
    # problems than one warp holds
    cases += boundary_cases([
        ("band 7", 40, 4099, [7]), ("band 8", 41, 4097, [8]),
        ("band 15", 42, 4099, [15]), ("band 16", 43, 4097, [16]),
        ("band 31", 44, 4099, [31]),
        ("bands 0/1/7/8/15 mixed", 45, 4101, [0, 1, 7, 8, 15]),
        ("bands 7/16/31 mixed", 46, 4099, [7, 16, 31]),
        ("band 15", 47, 1, [15]), ("band 15", 48, 3, [15]),
        ("band 31", 49, 1, [31]), ("bands 3/15 mixed", 50, 5, [3, 15]),
    ], 240)
    t, r, m, xm, ym = chunk_problems(7, 4096)
    cases.append(("certificate shapes (band 60->15)", t, r, m, xm, ym, (384,)))
    t, r, m, xm, ym = chunk_problems(8, 65536)
    cases.append(("main-path chunk shape (65536 rows, band<=15)", t, r,
                  pack_meta_host(m), xm, ym, (208,)))
    return run_cases(dev, cases, swg_stream)


def general_band_cases():
    """(name, problems, SMAX) of phases 2b and 2c: fuzz shapes per slot
    class, bands above XMAX (4 and 32 slots per lane), and the full-band
    chunk shape of the main path (65536 rows, band 60)."""
    from thermite_tpu_torch.ops.layout import pack_meta_host

    specs = [  # name, seed, n, band_min, band_max, XMAX, YMAX, SMAX
        ("fuzz band<=63", 10, 4096, 0, 63, 64, 96, 176),
        ("fuzz band<=127", 11, 4096, 0, 127, 128, 192, 336),
        ("fuzz band<=255 (windows 512)", 12, 2048, 128, 255, 512, 512, 1040),
        ("band>XMAX (XMAX 96)", 13, 4096, 97, 1023, 96, 160, 272),
        ("band>XMAX (XMAX 512, 1024 slots)", 14, 1024, 513, 1023, 512, 512, 1040),
    ]
    cases = []
    for name, seed, n, lo, hi, xm, ym, smax in specs:
        t, r, m, _, _ = fuzz_problems(seed, n, hi, xm, ym, band_min=lo)
        cases += both_meta_forms(name, t, r, m, xm, ym, (smax,))
    t, r, m, xm, ym = chunk_problems(9, 65536, wide=60, narrow=60)
    cases.append(("full-band chunk shape (65536 rows, band 60)", t, r,
                  pack_meta_host(m), xm, ym, (256,)))
    return cases


def phase_kernel_wide(dev, cases):
    """The general-band stream kernel == plain; -> (worst max_abs_err,
    (ms, plain_ms, bound) at the full-band chunk shape)."""
    from thermite_tpu_torch.ops.swg_stream import swg_stream_wide

    # bands past 31 at XMAX 96: 32 lanes x 4 slots cover the 97 slots;
    # small windows bring the narrow groups to these bands too
    edge = boundary_cases([
        ("band 32", 60, 4099, [32]), ("band 47", 61, 4097, [47]),
        ("band 48", 62, 4099, [48]), ("band 63", 63, 4097, [63]),
        ("bands 32/60/100 mixed", 64, 4099, [32, 60, 100]),
        ("band 60", 65, 1, [60]), ("band 60", 66, 3, [60]),
    ], 240)
    for name, seed, xm in (("band 40 at XMAX 32 (16 x 4)", 67, 32),
                           ("band 40 at XMAX 16 (8 x 4)", 68, 16)):
        t, r, m, _, ym = boundary_problems(seed, 2051, [40], xm, 96)
        edge.append((f"group boundaries, {name}, 2051 rows", t, r, m, xm, ym,
                     (160,)))
    launches = swg_stream_wide.launches
    worst, timing = run_cases(dev, edge + cases, swg_stream_wide)
    check(swg_stream_wide.launches - launches >= len(edge) + len(cases),
          "the general-band kernel did not launch on every case")
    return worst, timing


def by_ylen(m9: np.ndarray) -> np.ndarray:
    """(N, 9) meta rows in the order BatchAligner._device_rows submits
    them: by ylen, stable."""
    return m9[np.argsort(m9[:, 3], kind="stable")]


def row_shape_cases():
    """Problems that cross the per-warp group shapes of kernels 3 and 4
    (a warp's four rows run at 8, 16 or 32 lanes x 4 slots by the largest
    min(2*band + 1, xlen + 1) among them), at XMAX 96, YMAX 160:
    boundary_problems with xlen of 1, of XMAX and random and bands mixed
    in one launch, as generated (most warps lifted to 32 lanes by one long
    row) and ordered by ylen (short rows side by side in narrow groups,
    xlen 31/32 and 63/64 in neighbouring warps), odd row counts and fewer
    rows than one warp owns; the odd cases in the packed meta form.
    -> [(name, text, reads, meta, XMAX, YMAX)]."""
    from thermite_tpu_torch.ops.layout import pack_meta_host

    specs = [  # name, seed, n, bands, ordered by ylen
        ("band 60", 70, 4099, [60], False),
        ("band 60, rows by ylen", 71, 4097, [60], True),
        ("bands 7/15/16/31/60 mixed", 72, 4099, [7, 15, 16, 31, 60], False),
        ("bands 7/15/16/31/60 mixed, rows by ylen", 73, 4101,
         [7, 15, 16, 31, 60], True),
        ("bands 0/1/15 (every warp 8 x 4)", 74, 4099, [0, 1, 15], False),
        ("bands 16/31, rows by ylen (8 x 4 and 16 x 4)", 75, 4097, [16, 31], True),
        ("band 60", 76, 1, [60], False), ("band 60", 77, 3, [60], False),
        ("band 60", 78, 5, [60], True), ("bands 15/60 mixed", 79, 7, [15, 60], False),
    ]
    cases = []
    for k, (name, seed, n, bands, ordered) in enumerate(specs):
        t, r, m, xm, ym = boundary_problems(seed, n, bands, 96, 160)
        m = by_ylen(m) if ordered else m
        cases.append((f"group shapes, {name}, {n} rows", t, r,
                      pack_meta_host(m) if k % 2 else m, xm, ym))
    return cases


def chunk_by_ylen():
    """The full-band chunk shape with its rows ordered by ylen, as the
    pipeline submits a chunk: (name, text, reads, packed meta, XMAX, YMAX)."""
    from thermite_tpu_torch.ops.layout import pack_meta_host

    t, r, m, xm, ym = chunk_problems(9, 65536, wide=60, narrow=60)
    return ("full-band chunk shape, rows by ylen (65536 rows, band 60)", t, r,
            pack_meta_host(by_ylen(m)), xm, ym)


def phase_kernel_forward(dev, cases):
    """The forward-scores kernel == plain; -> (worst max_abs_err,
    (ms, plain_ms, bound) at the full-band chunk shape with rows ordered
    by ylen, the order its pipeline launches it in)."""
    from thermite_tpu_torch.ops.swg_forward import swg_forward, swg_forward_plain

    extra = both_meta_forms("fuzz band<=15", *fuzz_problems(15, 4096, 15), ())
    extra += [c + ((),) for c in row_shape_cases()]
    cases = extra + [c[:6] + ((),) for c in cases] + [chunk_by_ylen() + ((),)]
    launches = swg_forward.launches
    out = run_cases(dev, cases, swg_forward, plain=swg_forward_plain,
                    stream=False)
    check(swg_forward.launches - launches >= len(cases),
          "the forward kernel did not launch on every case")
    return out


def dense_problems(seed, n, band_lo, band_hi, XMAX, YMAX, runs_near):
    """Kernel 4's dense inputs (the reference kernel's own arrays): y a
    random ACGT window and x, one in five, unrelated; else its prefix
    with substitutions at a rate drawn per problem from [0, 0.3) (so run
    counts spread from 1 to hundreds) and a few indels; or, one in four,
    with k substitutions five bases apart from base 0 or 2 (2k or 2k+1
    runs), k near runs_near / 2.  Bands from [band_lo, band_hi], X-drops
    up to 100.  -> (x (n, XW) pre-shifted, y (n, YMAX), params (n, 4))
    uint8/uint8/int32 numpy arrays."""
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    rot = np.zeros(256, np.uint8)  # a base -> another base
    rot[acgt] = np.frombuffer(b"CGTA", np.uint8)
    XW = max(2 * band_hi + 1, XMAX + 1)
    x = np.zeros((n, XW), np.uint8)
    y = np.zeros((n, YMAX), np.uint8)
    params = np.zeros((n, 4), np.int32)
    for k in range(n):
        band = int(rng.integers(band_lo, band_hi + 1))
        xlen = int(rng.integers(1, XMAX + 1))
        mode = rng.random()
        if mode < 0.25:
            nsub = int(rng.integers(max(runs_near // 2 - 2, 1), runs_near // 2 + 3))
            xlen = min(max(xlen, 5 * nsub + 3), XMAX)
        ylen = int(min(xlen + rng.integers(0, 40), YMAX))
        yw = rng.choice(acgt, ylen)
        if mode < 0.25:
            xw = np.resize(yw, xlen).copy()
            pos = np.arange(int(rng.integers(0, 2)) * 2, xlen - 1, 5)[:nsub]
            xw[pos] = rot[xw[pos]]
        elif mode < 0.45:
            xw = rng.choice(acgt, xlen)
        else:
            xw = np.resize(yw, xlen).copy()
            sub = rng.random(xlen) < rng.random() * 0.3
            xw[sub] = rng.choice(acgt, int(sub.sum()))
            for _ in range(int(rng.integers(0, 3))):
                c = int(rng.integers(0, xlen))
                xw = np.concatenate([xw[:c], rng.choice(acgt, 3), xw[c:]])[:xlen]
        x[k, 1 : 1 + xlen] = xw
        y[k, :ylen] = yw
        params[k] = (xlen, ylen, band, int(rng.integers(1, 101)))
    return x, y, params


def traceback_cases():
    """(name, form, inputs, XMAX, YMAX, RMAX) of phase 2d: gather fuzz
    shapes for every group shape and slot class in both meta forms, dense
    shapes (bands above XMAX among them), RMAX 1, 4, 24 and 64, the shapes
    that cross the per-warp groups in both input forms (RMAX 24, and 4 for
    overflow rows), and the full-band chunk shape (65536 rows, XMAX 96,
    YMAX 160, band 60, RMAX 24) as generated and, in both input forms,
    with its rows ordered by ylen.  The form "both" runs the gather form,
    then the dense form on the same windows, which must give the same
    rows."""
    from thermite_tpu_torch.ops.layout import pack_meta_host

    gather = [  # name, seed, n, band_min, band_max, XMAX, YMAX, RMAX
        ("fuzz band<=15 (8 x 4)", 20, 4096, 0, 15, 64, 96, 24),
        ("fuzz band 16-31 (up to 16 x 4)", 21, 4096, 16, 31, 64, 96, 4),
        ("fuzz band 32-63 (up to 32 x 4)", 22, 4096, 32, 63, 64, 96, 64),
        ("fuzz band 64-127 (32 x 8)", 23, 2048, 64, 127, 128, 192, 1),
        ("fuzz band 128-255 (32 x 16, windows 512)", 24, 1024, 128, 255,
         512, 512, 24),
        ("fuzz band 256-511 (32 x 32, windows 512)", 25, 512, 256, 511,
         512, 512, 4),
        ("band>XMAX (XMAX 96)", 26, 4096, 97, 1023, 96, 160, 24),
    ]
    cases = []
    for name, seed, n, lo, hi, xm, ym, rmax in gather:
        t, r, m, _, _ = fuzz_problems(seed, n, hi, xm, ym, band_min=lo)
        for form, mm in (("9-col", m), ("4-col", pack_meta_host(m))):
            cases.append((f"{name} {form}", "gather", (t, r, mm), xm, ym, rmax))
    dense = [  # name, seed, n, band_min, band_max, XMAX, YMAX, RMAX
        ("dense band<=31", 30, 4096, 0, 31, 128, 160, 64),
        ("dense band>XMAX (XMAX 96)", 31, 2048, 97, 400, 96, 160, 24),
        ("dense windows 512 (32 slots)", 32, 1024, 256, 600, 512, 512, 64),
        ("dense band<=15", 33, 4096, 0, 15, 96, 128, 4),
    ]
    for name, seed, n, lo, hi, xm, ym, rmax in dense:
        cases.append((name, "dense",
                      dense_problems(seed, n, lo, hi, xm, ym, rmax),
                      xm, ym, rmax))
    for k, (name, t, r, m, xm, ym) in enumerate(row_shape_cases()):
        cases.append((name, "both", (t, r, m), xm, ym, 4 if k == 3 else 24))
    t, r, m, xm, ym = chunk_problems(9, 65536, wide=60, narrow=60)
    cases.append(("full-band chunk shape (65536 rows, band 60, RMAX 24)",
                  "gather", (t, r, pack_meta_host(m)), xm, ym, 24))
    name, t, r, m, xm, ym = chunk_by_ylen()
    cases.append((f"{name}, RMAX 24", "both", (t, r, m), xm, ym, 24))
    return cases


def dense_from_gather(words, rnib, meta, XMAX, YMAX):
    """The dense form's inputs of the gather form's problems, on the
    meta's device: x (N, XMAX + 1) uint8 rows [0, codes...], y (N, YMAX)
    uint8 codes, params (N, 4) int32 [xlen, ylen, band, x_drop]."""
    import torch

    from thermite_tpu_torch.ops.swg_stream import _windows, meta9

    m9 = meta9(meta)
    x, y = _windows(words, rnib, m9, XMAX, YMAX)
    x = torch.cat([torch.zeros_like(x[:, :1]), x], 1).to(torch.uint8)
    return (x.contiguous(), y.to(torch.uint8).contiguous(),
            m9[:, [6, 3, 7, 8]].contiguous())


def phase_kernel_traceback(dev):
    """Kernel 4 (swg_traceback, swg_traceback_dense) == its plain
    versions, bit-exact, on every case; for each RMAX both overflow rows
    (-1) and rows with exactly RMAX runs occur.  -> (worst max_abs_err,
    (ms, plain_ms, bound) of the gather form and of the dense form at the
    chunk shape with rows ordered by ylen)."""
    import torch

    from thermite_tpu_torch.ops.swg_stream import meta9, rows_launch
    from thermite_tpu_torch.ops.swg_traceback import (
        swg_traceback,
        swg_traceback_dense,
        swg_traceback_dense_plain,
        swg_traceback_plain,
    )

    worst, seen = 0, {}
    timing = {"gather": (None, None, None), "dense": (None, None, None)}
    launches = swg_traceback.launches + swg_traceback_dense.launches
    n_launched = 0

    def one(name, form, args, bmax, work_args, meta_np):
        """One form of one case -> the kernel's rows; the 65536-row cases
        timed beside their bound."""
        nonlocal worst, n_launched
        xm, ym, rmax = args[-3:]
        kernel, plain = ((swg_traceback, swg_traceback_plain) if form == "gather"
                         else (swg_traceback_dense, swg_traceback_dense_plain))
        launch = functools.partial(kernel, band_max=bmax)
        rows = len(meta_np)
        nbad, err, ms, plain_ms, got = compare_kernel(
            args, reps=20 if rows == 65536 else 0, kernel=launch, plain=plain)
        n_launched += 1
        if ms is not None:
            mhz, sms = sm_clock_mhz(lambda: launch(*args), ms)
            bound = kernel_bound(work_args, meta_np, 4 + rmax, True, mhz, sms,
                                 dense=form == "dense")
            log_bound(f"{name}, {form} form", ms, bound,
                      rows_note(bound) if rows_launch(bmax, xm) else "")
            timing[form] = (ms, plain_ms, bound)
        nr = got[:, 3]
        over, exact = int((nr == -1).sum()), int((nr == rmax).sum())
        s = seen.setdefault(rmax, [0, 0])
        s[0] += over
        s[1] += exact
        t_ms = f", kernel {ms:.4f} ms, plain {plain_ms:.1f} ms" if ms else ""
        log(f"  {name}, {form} form: {len(got)} rows, XMAX {xm} YMAX {ym} "
            f"RMAX {rmax}, nruns -1: {over}, == RMAX: {exact}, max nruns "
            f"{nr.max()}; {nbad} differ, max_abs_err {err}{t_ms}")
        check(nbad == 0, f"kernel 4 != plain on {name}, {form} form")
        worst = max(worst, err)
        return got

    for name, form, inputs, xm, ym, rmax in traceback_cases():
        if form == "dense":
            args = tuple(torch.from_numpy(a).to(dev) for a in inputs)
            one(name, form, args + (xm, ym, rmax), int(inputs[2][:, 2].max()),
                None, inputs[2])
            continue
        words, rnib, mt = _to_dev(*inputs, dev)
        meta_np = inputs[2]
        bmax = int(meta9(torch.from_numpy(np.ascontiguousarray(meta_np)))
                   [:, 7].max())
        work_args = (words, words.shape[0], rnib, mt, xm, ym)
        got = one(name, "gather", work_args + (rmax,), bmax, work_args, meta_np)
        if form == "both":
            dense = dense_from_gather(words, rnib, mt, xm, ym)
            got_d = one(name, "dense", dense + (xm, ym, rmax), bmax, work_args,
                        meta_np)
            check((got_d == got).all(),
                  f"kernel 4's two input forms differ on {name}")
    for rmax, (over, exact) in sorted(seen.items()):
        check(over > 0 and exact > 0,
              f"RMAX {rmax}: {over} overflow rows, {exact} rows of RMAX runs")
    check(swg_traceback.launches + swg_traceback_dense.launches - launches
          >= n_launched, "kernel 4 did not launch on every case")
    return worst, timing["gather"], timing["dense"]


def _bam_primary_flags(raw: bytes) -> np.ndarray:
    """FLAG of every primary record in a blob of BAM records."""
    flags, off = [], 0
    while off < len(raw):
        size = int.from_bytes(raw[off : off + 4], "little")
        flag = int.from_bytes(raw[off + 18 : off + 20], "little")
        if not flag & 0x900:
            flags.append(flag)
        off += 4 + size
    check(off == len(raw), "BAM record blob does not parse")
    return np.asarray(flags)


def _wrappers() -> dict:
    """Every kernel wrapper of the port by the name its launches are
    counted under."""
    from thermite_tpu_torch.ops.swg_forward import swg_forward
    from thermite_tpu_torch.ops.swg_stream import swg_stream, swg_stream_wide
    from thermite_tpu_torch.ops.swg_traceback import (
        swg_traceback,
        swg_traceback_dense,
    )

    return {f.__name__: f for f in (swg_stream, swg_stream_wide, swg_forward,
                                    swg_traceback, swg_traceback_dense)}


def reset_launches():
    for fn in _wrappers().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in _wrappers().items()}


def timed_runs(run_batch, n_reads, first_s):
    """Four more runs of ``run_batch()`` (one batch of ``n_reads``
    reads, synchronized) after one of ``first_s`` seconds; logs the five
    reads/s and returns their median."""
    import torch

    rates = [n_reads / first_s]
    for _ in range(4):
        t = time.perf_counter()
        run_batch()
        torch.cuda.synchronize()
        rates.append(n_reads / (time.perf_counter() - t))
    med = float(np.median(rates))
    log("  reads/s over 5 runs of the batch: "
        + " ".join(f"{r:.1f}" for r in rates) + f"; median {med:.1f}")
    return med


def syn45_index(tmp):
    """The 45 Mbp synthetic spliced chromosome, written under `tmp` and
    indexed, and the options every phase aligns with (the bench's)."""
    from thermite_tpu_torch.index.build import Index
    from thermite_tpu_torch.testing.synth import write_synth_genome
    from thermite_tpu_torch.tools.workloads import bench_opts

    fasta, gtf = write_synth_genome(tmp, SYN_BP, seed=1234, basename="syn45")
    index = Index.create_from_files(fasta, gtf)
    return index, bench_opts()


def chunk_launch(aligner, st):
    """The stream-kernel launch of a built chunk as the pipeline submits
    it (BatchAligner._dispatch_forward): the nontrivial problems in the
    pipeline's row order (by ylen), narrowed to aligner.narrow_band while
    that is on, padded to the batch's pinned row count, at its pinned
    shapes; -> (args of swg_stream, band bound, problems, meta rows)."""
    meta_dev = aligner._narrow_meta(st.meta_all) if aligner._narrowing() \
        else st.meta_all
    sub = meta_dev[aligner._device_rows(meta_dev)]
    meta_np = aligner._pack_meta(aligner._pad_meta(sub, aligner._NFWD1))
    from thermite_tpu_torch.device import upload

    words = aligner._ref_text()[0]
    args = (words, words.shape[0], st.reads_dev[0],
            upload(meta_np, aligner.device),
            aligner._XMAX, aligner._YMAX, aligner._SMAX)
    return args, int(sub[:, 7].max(initial=1)), len(sub), meta_np


def phase_syn45(tmp):
    """Index syn45 in memory and run the main path once, counted."""
    import torch

    from thermite_tpu_torch.testing.synth import make_truth_reads
    from thermite_tpu_torch.align.batch import BatchAligner

    t0 = time.perf_counter()
    index, opts = syn45_index(tmp)
    t1 = time.perf_counter()
    aligner = BatchAligner(index, opts, device="cuda")
    t2 = time.perf_counter()
    log(f"  syn45: {len(index.seq)} bp fwd+rc, {len(index.txome.txs)} "
        f"transcripts; FASTA+index {t1 - t0:.1f} s, aligner (seed table, "
        f"C++ engine) {t2 - t1:.1f} s")
    recs = [(n.encode(), s, b"I" * len(s))
            for n, s in make_truth_reads(index, N_READS, seed=3)]
    warm = [(n.encode(), s, b"I" * len(s))
            for n, s in make_truth_reads(index, 8192, seed=4)]
    t3 = time.perf_counter()
    aligner.align_batch_emit(warm, True)  # text upload, first launches
    torch.cuda.synchronize()
    log(f"  warm-up: 8192 reads in {time.perf_counter() - t3:.2f} s "
        f"(resident text {aligner._ref_text()[0].numel() * 4 / 1e6:.1f} MB)")

    aligner.stats.reset()
    reset_launches()
    t4 = time.perf_counter()
    raw = aligner.align_batch_emit(recs, True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t4
    launches = read_launches()
    stats = aligner.stats
    report = stats.report()
    flags = _bam_primary_flags(raw)
    mapped = float(np.mean((flags & 4) == 0)) if len(flags) else 0.0
    log(f"  main path: {N_READS} reads, {stats.chunks} chunks, "
        f"launches {launches}, {len(raw)} BAM bytes, "
        f"mapped {100 * mapped:.2f}%, cert patches {stats.cert_patches}, "
        f"wall {wall:.3f} s = {N_READS / wall:.1f} reads/s")
    log(report)
    check(len(flags) == N_READS, f"{len(flags)} primary records for {N_READS} reads")
    check(stats.chunks >= 1 and launches["swg_stream"] >= stats.chunks,
          f"{launches} kernel launches for {stats.chunks} chunks")
    check(mapped > 0.9, f"only {100 * mapped:.2f}% of reads mapped")
    rate = timed_runs(lambda: aligner.align_batch_emit(recs, True), len(recs),
                      wall)
    _profile_run(aligner, recs)
    return index, opts, aligner, recs, warm, raw, launches["swg_stream"], rate


def phase_full_band(index, opts, recs, warm, raw_narrow):
    """The same reads at full band: the general-band kernel on band 60,
    the same BAM bytes as the narrowed run."""
    import torch

    from thermite_tpu_torch.align.batch import BatchAligner

    aligner = BatchAligner(index, opts, device="cuda")
    aligner.narrow_band = 0
    aligner.align_batch_emit(warm, True)
    torch.cuda.synchronize()
    aligner.stats.reset()
    reset_launches()
    t0 = time.perf_counter()
    raw = aligner.align_batch_emit(recs, True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = aligner.stats
    log(f"  full band: {N_READS} reads, {stats.chunks} chunks, launches "
        f"{launches}, XMAX {aligner._XMAX} YMAX {aligner._YMAX} SMAX "
        f"{aligner._SMAX}, {len(raw)} BAM bytes, == narrowed run: "
        f"{raw == raw_narrow}, cert patches {stats.cert_patches}, "
        f"wall {wall:.3f} s = {N_READS / wall:.1f} reads/s")
    log(stats.report())
    check(raw == raw_narrow, "full-band BAM bytes differ from the narrowed run's")
    check(launches["swg_stream_wide"] >= stats.chunks >= 1,
          f"{launches} kernel launches for {stats.chunks} chunks")
    check(launches["swg_stream"] == 0, "the packed kernel ran at full band")
    timed_runs(lambda: aligner.align_batch_emit(recs, True), len(recs), wall)
    return launches["swg_stream_wide"]


def phase_no_native(index, opts, aligner, recs):
    """The path without the C++ engine on the first N_NO_NATIVE reads:
    the same BAM bytes as the C++ engine's path."""
    import torch

    from thermite_tpu_torch.align.batch import BatchAligner

    sub = recs[:N_NO_NATIVE]
    want = aligner.align_batch_emit(sub, True)
    py = BatchAligner(index, opts, device="cuda", use_native=False)
    py.align_batch_emit(sub[:256], True)  # text upload
    torch.cuda.synchronize()
    py.stats.reset()
    reset_launches()
    t0 = time.perf_counter()
    got = py.align_batch_emit(sub, True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = py.stats
    log(f"  no C++ engine: {len(sub)} reads, {stats.chunks} chunks, "
        f"{stats.problems} problems, {stats.winners} winners, launches "
        f"{launches}, {len(got)} BAM bytes, == C++ engine path: "
        f"{got == want}, wall {wall:.3f} s = {len(sub) / wall:.1f} reads/s")
    log(stats.report())
    check(got == want, "BAM bytes without the C++ engine differ")
    check(launches["swg_forward"] >= stats.chunks >= 1
          and launches["swg_stream_wide"] >= stats.chunks,
          f"{launches} kernel launches for {stats.chunks} chunks")
    return launches["swg_forward"]


def _profile_run(aligner, recs):
    """One more run under torch.profiler: each card's busy time (the
    union of its kernel and copy intervals) against the run's wall time
    (traced, so slower), and the device time by kernel or copy.  A
    profiler that fails, or records no device time, fails the phase."""
    import torch

    from thermite_tpu_torch.utils.profile import device_busy, profiled

    with profiled(cuda=True) as prof:
        t0 = time.perf_counter()
        aligner.align_batch_emit(recs, True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy_us, by_name = device_busy(prof)
    cards = {d.index for d in aligner.mesh}
    check(all(busy_us.get(card) for card in cards),
          f"profiler recorded device time on cards {sorted(busy_us)}, the "
          f"run used {sorted(cards)}")
    for card, us in sorted(busy_us.items()):
        busy = us / 1e6
        log(f"  profiled run: wall {wall:.3f} s, card {card} busy "
            f"{1e3 * busy:.3f} ms ({100 * busy / wall:.2f}% of wall, idle "
            f"{100 - 100 * busy / wall:.2f}%)")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"    {name[:70]}: {t / 1e3:.3f} ms over {n} calls")


def phase_mesh(index, opts, aligner, recs, warm, raw, base_launches,
               base_rate):
    """The mesh path: phase 3's reads through a mesh of every local card
    and through cuda:0 named four times (bytes == phase 3's, the packed
    kernel's launches 1x and 4x phase 3's, reads/s beside phase 3's), then
    4096 reads at full band and without the C++ engine on the four-entry
    mesh (bytes == the single-device paths')."""
    import torch

    from thermite_tpu_torch.align.batch import BatchAligner
    from thermite_tpu_torch.parallel.mesh import make_mesh

    n_cards = torch.cuda.device_count()
    four = (torch.device("cuda", 0),) * 4
    for name, mesh in ((f"make_mesh({n_cards})", make_mesh(n_cards)),
                       ("cuda:0 four times", four)):
        meshed = BatchAligner(index, opts, mesh=mesh)
        meshed.align_batch_emit(warm, True)  # as phase 3: text, first launches
        torch.cuda.synchronize()
        meshed.stats.reset()
        reset_launches()
        t0 = time.perf_counter()
        got = meshed.align_batch_emit(recs, True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        stats = meshed.stats
        log(f"  mesh {name}: {len(recs)} reads, {stats.chunks} chunks, "
            f"launches {launches} (phase 3: swg_stream {base_launches}), "
            f"rows a launch {meshed._NFWD1 // len(mesh)}, {len(got)} BAM "
            f"bytes, == phase 3: {got == raw}, cert patches "
            f"{stats.cert_patches}, wall {wall:.3f} s")
        log(stats.report())
        check(got == raw, f"mesh {name}: BAM bytes differ from phase 3's")
        check(launches["swg_stream"] == len(mesh) * base_launches,
              f"mesh {name}: {launches['swg_stream']} launches, phase 3 made "
              f"{base_launches} on one device")
        check(launches["swg_stream_wide"] == 0 and launches["swg_forward"] == 0,
              f"mesh {name}: {launches}")
        rate = timed_runs(lambda: meshed.align_batch_emit(recs, True),
                          len(recs), wall)
        log(f"  mesh {name}: median {rate:.1f} reads/s beside phase 3's "
            f"{base_rate:.1f} (one device, mesh not given)")
        _profile_run(meshed, recs)
        del meshed

    sub = recs[:N_NO_NATIVE]
    want = aligner.align_batch_emit(sub, True)
    meshes = [("cuda:0 four times", four)]
    if n_cards > 1:
        meshes.append((f"make_mesh({n_cards})", make_mesh(n_cards)))
    for (mesh_name, mesh), (name, kw, narrow, counted) in (
            (m, c) for m in meshes for c in (
                ("full band", {}, 0, ("swg_stream_wide",)),
                ("no C++ engine", {"use_native": False}, 15,
                 ("swg_forward", "swg_stream_wide")))):
        meshed = BatchAligner(index, opts, mesh=mesh, **kw)
        meshed.narrow_band = narrow
        reset_launches()
        t0 = time.perf_counter()
        got = meshed.align_batch_emit(sub, True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_launches()
        chunks = meshed.stats.chunks
        log(f"  mesh {mesh_name}, {name}: {len(sub)} reads, {chunks} "
            f"chunks, launches {launches}, == the single-device path: "
            f"{got == want}, wall {wall:.3f} s (first run, with the uploads)")
        check(got == want, f"mesh {mesh_name}, {name}: BAM bytes differ")
        check(chunks >= 1 and launches["swg_stream"] == 0
              and all(launches[k] == len(mesh) * chunks for k in counted),
              f"mesh {mesh_name}, {name}: {launches} launches for {chunks} "
              "chunks")


def chunk_vs_plain(aligner, st, label):
    """The stream-kernel launch of the built chunk ``st`` as the pipeline
    submits it (chunk_launch) against swg_stream_plain on the same CUDA
    inputs, bit for bit, timed over 20 launches beside its bound, with the
    pinned shapes and the group shape logged; -> (max_abs_err, (ms,
    plain_ms, bound), launch args, the wrapper with its band bound,
    problems a warp)."""
    from thermite_tpu_torch.ops.swg_stream import stream_group, swg_stream

    args, bmax, nsub, meta_np = chunk_launch(aligner, st)
    kernel = functools.partial(swg_stream, band_max=bmax)
    nbad, err, ms, plain_ms, got = compare_kernel(args, reps=20, kernel=kernel)
    lanes, slots = stream_group(bmax, aligner._XMAX)
    log(f"  kernel vs plain on {label} ({nsub} rows padded to "
        f"{aligner._NFWD1}, XMAX {aligner._XMAX} YMAX {aligner._YMAX} "
        f"SMAX {aligner._SMAX}, band <= {bmax}, group {lanes} x {slots}): "
        f"{nbad} differ, max_abs_err {err}, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.1f} ms")
    check(nbad == 0, f"kernel != plain on {label}")
    mhz, sms = sm_clock_mhz(lambda: kernel(*args), ms)
    bound = kernel_bound(args[:6], meta_np, got.shape[1], True, mhz, sms)
    per_warp = 32 // lanes
    log_bound(f"{label} in the pipeline's row order", ms, bound,
              stream_note(bound, per_warp))
    return err, (ms, plain_ms, bound), args, kernel, per_warp


def stream_groups():
    """A context in which every stream-kernel launch the pipeline makes
    (through parallel/mesh.py) is counted by its group shape: yields a
    Counter of (lanes, slots) -> launches."""
    import collections
    import contextlib

    import thermite_tpu_torch.parallel.mesh as mesh
    from thermite_tpu_torch.ops.swg_stream import stream_group

    @contextlib.contextmanager
    def ctx():
        seen = collections.Counter()
        real = mesh.swg_stream

        def counted(*args, band_max, **kw):
            seen[stream_group(band_max, args[4])] += 1
            return real(*args, band_max=band_max, **kw)

        mesh.swg_stream = counted
        try:
            yield seen
        finally:
            mesh.swg_stream = real

    return ctx()


def fuzz_run(aligner, reads, want, label):
    """``reads`` through the fuzz tool's ``fuzz_parity`` on ``aligner``,
    counted, against the oracle's alignments ``want``: every read must be
    identical.  -> (launches, group shapes of the stream launches)."""
    from thermite_tpu_torch.tools.fuzz_parity import fuzz_parity

    reset_launches()
    with stream_groups() as groups:
        res = fuzz_parity(aligner, reads, want)
    launches = read_launches()
    same = res["identical"]
    log(f"  {label}: {same}/{len(reads)} identical to the oracle; "
        f"{res['chunks']} chunks of budget {aligner.PROBLEM_BUDGET}, cert "
        f"patches {res['cert_patches']}, XMAX {res['XMAX']} YMAX "
        f"{res['YMAX']} SMAX {res['SMAX']}, stream groups (lanes, slots): "
        f"launches {dict(groups)}, launches {launches}, wall "
        f"{res['batch_s']:.3f} s")
    for k, r, g, w in res["mismatches"]:
        log(f"    MISMATCH read {k} ({len(r)} bp): {r[:50]!r}\n"
            f"      got  {g}\n      want {w}")
    check(same == len(reads), f"{label}: {len(reads) - same} reads differ "
          "from the oracle")
    check(res["chunks"] >= 1, f"{label}: no chunk ran")
    return launches, groups


def long_chunk(aligner, reads, label):
    """One chunk of ``reads`` built and launched on ``aligner`` as its
    pipeline does, at its pinned shapes, then chunk_vs_plain; -> (max_abs_err,
    (ms, plain_ms, bound))."""
    aligner._pin_shapes(reads)
    st, _ = aligner._build_chunk(reads, 0)
    aligner._dispatch_forward(st)
    st.hdr.wait()
    aligner.native.free_chunk(st.native_ch)
    st.native_ch = None
    err, timing, *_ = chunk_vs_plain(aligner, st, label)
    return err, timing


def phase_fuzz(index):
    """The adversarial parity fuzz on the card (tools/fuzz_parity.py):
    N_FUZZ mutated 90 bp reads (seed 777) then N_FUZZ of 40-150 bp
    (seed 778), each set with the five edge reads, against the oracle,
    each regime on a fresh aligner without a fallback:
    a. -s0 narrowed (the main path): align_batch at the default budget and
       at FUZZ_BUDGET (there after a batch of the 90 bp reads alone, so the
       pinned shapes grow), each read identical, and align_batch_emit's
       SAM == the oracle's; one real chunk of long reads through the
       packed kernel == plain, timed;
    b. -s0 at full band: the general-band kernel, the 32 x 8 group reached;
       one real chunk of long reads through it == plain, timed;
    c. -s0 without the C++ engine, on N_FUZZ_NO_NATIVE reads (half of them
       90 bp, half long): the forward and general-band kernels;
    d. -s0.66 narrowed on the long reads.
    -> {regime: launches}."""
    from thermite_tpu_torch.align.batch import BatchAligner
    from thermite_tpu_torch.align.driver import OracleAligner
    from thermite_tpu_torch.tools.fuzz_parity import (fuzz_reads,
                                                      oracle_alignments,
                                                      oracle_sam)
    from thermite_tpu_torch.tools.workloads import bench_opts, first_chrom

    chrom = first_chrom(index)
    short = fuzz_reads(chrom, N_FUZZ, 777)
    long = fuzz_reads(chrom, N_FUZZ, 778, long_reads=True)
    reads = short + long
    lens = [len(r) for r in long]
    log(f"  reads: {len(short)} of 90 bp, then {len(long)} of {min(lens)}-"
        f"{max(lens)} bp (substitutions, indels, N; five edge reads each)")
    opts0, opts66 = bench_opts(0.0), bench_opts(0.66)
    t0 = time.perf_counter()
    seeder = OracleAligner(index, opts0).seeder
    want0 = oracle_alignments(index, opts0, reads, seeder)
    t1 = time.perf_counter()
    want66 = oracle_alignments(index, opts66, long, seeder)
    t2 = time.perf_counter()
    log(f"  oracle: {len(reads)} reads at -s0 in {t1 - t0:.1f} s, "
        f"{len(long)} at -s0.66 in {t2 - t1:.1f} s")
    out = {}

    for b in (None, FUZZ_BUDGET):
        aligner = BatchAligner(index, opts0, device="cuda")
        if b:
            # a batch pins its shapes up front, so they grow between
            # batches: the 90 bp reads alone first, then the whole batch
            aligner.PROBLEM_BUDGET = b
            fuzz_run(aligner, short, want0[:len(short)],
                     f"a. -s0 narrowed, budget {b}, the 90 bp reads alone")
            before = (aligner._XMAX, aligner._YMAX, aligner._SMAX)
        label = f"a. -s0 narrowed, budget {aligner.PROBLEM_BUDGET}"
        launches, groups = fuzz_run(aligner, reads, want0, label)
        if b:
            after = (aligner._XMAX, aligner._YMAX, aligner._SMAX)
            log(f"  (XMAX, YMAX, SMAX) grew from {before} to {after}")
            check(after[0] > before[0], f"{label}: the shapes did not grow")
        check(launches["swg_stream"] >= aligner.stats.chunks
              and launches["swg_stream_wide"] == 0,
              f"{label}: launches {launches}")
        out[label] = launches
        recs = [(b"f%d" % i, r, b"I" * len(r)) for i, r in enumerate(reads)]
        got = aligner.align_batch_emit(recs, False)
        same = got == oracle_sam(index, recs, want0)
        log(f"  {label}: align_batch_emit SAM == the oracle's: {same} "
            f"({len(got)} bytes)")
        check(same, f"{label}: SAM differs from the oracle's")
        if not b:
            err_a = long_chunk(aligner, long,
                               "a long-read chunk (-s0 narrowed)")[0]

    aligner = BatchAligner(index, opts0, device="cuda")
    aligner.narrow_band = 0
    label = "b. -s0 full band"
    launches, groups = fuzz_run(aligner, reads, want0, label)
    check(launches["swg_stream_wide"] >= 1, f"{label}: launches {launches}")
    check(groups[(32, 8)] >= 1, f"{label}: the 32 x 8 group was not reached "
          f"({dict(groups)})")
    out[label] = launches
    err_b = long_chunk(aligner, long, "a long-read chunk (-s0 full band)")[0]

    half = N_FUZZ_NO_NATIVE // 2
    sub = reads[:half] + long[:half]
    sub_want = want0[:half] + want0[len(short):len(short) + half]
    aligner = BatchAligner(index, opts0, device="cuda", use_native=False)
    label = "c. -s0 without the C++ engine"
    launches, _ = fuzz_run(aligner, sub, sub_want, label)
    check(launches["swg_forward"] >= aligner.stats.chunks
          and launches["swg_stream_wide"] >= aligner.stats.chunks,
          f"{label}: launches {launches}")
    out[label] = launches

    aligner = BatchAligner(index, opts66, device="cuda")
    label = "d. -s0.66 narrowed, long reads"
    launches, _ = fuzz_run(aligner, long, want66, label)
    check(launches["swg_stream"] >= aligner.stats.chunks,
          f"{label}: launches {launches}")
    out[label] = launches
    log(f"  long-read chunks bit-exact: max_abs_err {max(err_a, err_b)}")
    return out


def phase_cpp_referee(aligner, recs):
    """One syn45 chunk: kernel == plain on its real rows (timed), and
    every certified row == the C++ full-band scalar SWG.  -> (max_abs_err,
    (ms, plain_ms, bound) of the main path's launch on this chunk, the
    chunk)."""
    import torch

    from thermite_tpu_torch.ops.layout import expand_stream_hdr

    reads = [r[1] for r in recs]
    aligner._pin_shapes(reads)
    st, _ = aligner._build_chunk(reads, 0)
    aligner._dispatch_forward(st)
    hdr = expand_stream_hdr(st.hdr.wait()[: len(st.fwd_idx)])
    dev_streams = st.fwd_streams[0][: len(st.fwd_idx)].cpu().numpy()
    n = len(st.meta_all)
    pw_host = aligner._SMAX_HOST // 16
    kern = np.zeros((n, 4 + pw_host), np.int32)
    kern[st.fwd_idx, :4] = hdr
    kern[st.fwd_idx, 4 : 4 + dev_streams.shape[1]] = dev_streams
    t0 = time.perf_counter()
    ref = np.zeros_like(kern)
    aligner.native.patch_rows(st.meta_all, st.fwd_idx, st.reads_host,
                              aligner._ref_text_host, ref)
    cpp_s = time.perf_counter() - t0
    rows = st.fwd_idx[kern[st.fwd_idx, 3] >= 0]
    differ = int((kern[rows] != ref[rows]).any(1).sum())
    log(f"  chunk: {n} problems, {len(st.fwd_idx)} on the card, "
        f"{len(rows)} certified, {len(st.fwd_idx) - len(rows)} left to the "
        f"full-band patch; certified rows != C++ full band: {differ} "
        f"(C++ referee {cpp_s:.1f} s)")
    check(differ == 0, f"{differ} certified rows differ from the C++ referee")

    # the same launch again, against the plain version, timed; then what
    # the ragged warps cost: the pipeline's row order (by ylen) against
    # the same rows shuffled
    err, (ms, plain_ms, bound), args, kernel, per_warp = chunk_vs_plain(
        aligner, st, "the syn45 chunk")
    meta = args[3]
    perm = torch.from_numpy(np.random.default_rng(0).permutation(len(meta)))
    shuffled = (*args[:3], meta[perm.to(meta.device)].contiguous(), *args[4:])
    _, _, ms_sh, _, _ = compare_kernel(shuffled, reps=20, kernel=kernel)
    log(f"  the same rows shuffled: kernel {ms_sh:.4f} ms ({ms_sh / ms:.2f} x), "
        f"{stream_note(bound, per_warp, perm.numpy())}")
    aligner.native.free_chunk(st.native_ch)
    st.native_ch = None
    return err, (ms, plain_ms, bound), st


def phase_genome(gbp: float, syn45_chunk=None):
    """Genome scale on the card: ``tools/genome_scale.run_genome_scale``
    at ``gbp`` Gbp, stride 4, N_GENOME_READS reads, no artifact, with an
    N_GENOME_SPOT-read oracle check, counted; the resident text against
    the host words; one real chunk of that run through the packed kernel
    against its plain version bit for bit, on rows whose largest y anchor
    lies at 2^31 nibbles or past, timed beside its bound and beside
    syn45's chunk (``syn45_chunk``: phase 4's (ms, plain_ms, bound));
    N_GENOME_FULL of the reads at full band, with the narrowed run's BAM.
    -> (the tool's result, (ms, plain_ms, bound) of the chunk)."""
    import torch

    from thermite_tpu_torch.align.batch import BatchAligner
    from thermite_tpu_torch.ops.swg_stream import swg_stream_wide
    from thermite_tpu_torch.tools.genome_scale import run_genome_scale

    keep = {}
    os.makedirs(os.path.join(ROOT, "data", "out"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "data", "out")) as d:
        reset_launches()
        res = run_genome_scale(
            int(gbp * 1e9), N_GENOME_READS, 4, d, device="cuda",
            artifact=False, n_spot=N_GENOME_SPOT,
            log=lambda msg: log(f"  {msg}"), keep=keep)
        launches = read_launches()
    log(f"  launches {launches}")
    log(json.dumps(res))
    check(res["oracle_spot_mismatches"] == 0,
          f"{res['oracle_spot_mismatches']} reads differ from the oracle")
    check(res["truth_overlap_primary"] >= 0.99,
          f"truth overlap {res['truth_overlap_primary']}")
    check(launches["swg_stream"] >= 1, "the packed kernel never ran")
    aligner, recs = keep["aligner"], keep["recs"]

    # the resident text == the host words at both ends, around 2^31
    # nibbles (word 2^28), at every staging-buffer seam and at random
    from thermite_tpu_torch.device import STAGE_BYTES

    words = aligner._ref_text()[0]
    lw = words.shape[0]
    seams = np.arange(STAGE_BYTES // 4, lw, STAGE_BYTES // 4)
    at = np.unique(np.concatenate([
        np.arange(4096), lw - 1 - np.arange(4096),
        (1 << 28) + np.arange(-2048, 2048), seams - 1, seams,
        np.random.default_rng(1).integers(0, lw, 1 << 16)]))
    at = at[(at >= 0) & (at < lw)]
    ref_words = _host_words(aligner._ref_text_host, at)
    got = words[torch.from_numpy(at).to(words.device)].cpu().numpy()
    check((got == ref_words).all(),
          f"{int((got != ref_words).sum())} resident text words differ")
    log(f"  resident text: {lw} words ({4 * lw / 1e9:.3f} GB) on the card; "
        f"{len(at)} sampled words == the host's")

    reads = [r[1] for r in recs]
    aligner._pin_shapes(reads)
    st, _ = aligner._build_chunk(reads, 0)
    args, bmax, nsub, meta_np = chunk_launch(aligner, st)
    y_anchor = 8 * meta_np[:nsub, 0].astype(np.int64) + (meta_np[:nsub, 3] & 7)
    y_max = int(y_anchor.max())
    log(f"  chunk: {len(st.meta_all)} problems, {nsub} on the card; largest y "
        f"anchor {y_max} nibbles (2^31 = {1 << 31}), "
        f"{int((y_anchor >= 1 << 31).sum())} rows past 2^31")
    check(y_max >= 1 << 31, "no row of the chunk reaches 2^31 nibbles")
    _, (ms, plain_ms, bound), *_ = chunk_vs_plain(aligner, st, "the genome chunk")
    if syn45_chunk is not None:
        s_ms, _, s_b = syn45_chunk
        log(f"  syn45's chunk (phase 4): {s_ms:.4f} ms, share of bound "
            f"{100 * s_b['bound_ms'] / s_ms:.1f}%; the genome chunk "
            f"{ms:.4f} ms, {100 * bound['bound_ms'] / ms:.1f}%")
    aligner.native.free_chunk(st.native_ch)
    st.native_ch = None

    sub = recs[:N_GENOME_FULL]
    narrow = aligner.align_batch_emit(sub, True)
    wide = BatchAligner(keep["index"], keep["opts"], device="cuda")
    wide.narrow_band = 0
    n0 = swg_stream_wide.launches
    t0 = time.perf_counter()
    raw = wide.align_batch_emit(sub, True)
    torch.cuda.synchronize()
    log(f"  full band on {len(sub)} reads: {swg_stream_wide.launches - n0} "
        f"launches of the general-band kernel, {len(raw)} BAM bytes in "
        f"{time.perf_counter() - t0:.2f} s (text upload included), "
        f"== the narrowed run: {raw == narrow}")
    check(swg_stream_wide.launches > n0, "the general-band kernel never ran")
    check(raw == narrow, "full-band BAM differs from the narrowed run's")
    return res, (ms, plain_ms, bound)


def _host_words(text: np.ndarray, at: np.ndarray) -> np.ndarray:
    """Words ``at`` of the nibble-packed ``text`` (ops/layout.py), each
    packed from its own eight bytes."""
    from thermite_tpu_torch.ops.layout import _NIB_LUT, _WPAD

    pos = 8 * at[:, None].astype(np.int64) + np.arange(8) - _WPAD
    ok = (pos >= 0) & (pos < len(text))
    codes = np.where(ok, _NIB_LUT[text[np.clip(pos, 0, len(text) - 1)]], 0)
    return (codes.astype(np.uint32) << (4 * np.arange(8, dtype=np.uint32))
            ).sum(1, dtype=np.uint32).view(np.int32)


def phase_traceback_path(aligner, st):
    """Kernel 4 on its own path, the differential check: the phase 4
    chunk's nontrivial problems at their original band (60), through the
    run-length traceback kernel (RMAX 24) and the general-band stream
    kernel (fused rows).  Every row with nruns >= 0 decodes to the stream
    walk's Alignment, and 2000 sampled rows to the scalar oracle's; the
    dense form on the same windows gives the gather form's rows.
    -> the launches of both forms in this run."""
    import torch

    from thermite_tpu_torch.device import upload
    from thermite_tpu_torch.ops.runs import decode_runs_one, decode_stream_batch
    from thermite_tpu_torch.ops.swg_ref import SwgExtend
    from thermite_tpu_torch.ops.swg_stream import swg_stream
    from thermite_tpu_torch.ops.swg_traceback import (
        swg_traceback,
        swg_traceback_dense,
    )

    def up32(v):
        return 32 * ((int(v) + 31) // 32)

    sub = st.meta_all[st.fwd_idx]
    XMAX, YMAX = up32(sub[:, 6].max()), up32(sub[:, 3].max())
    SMAX = 16 * ((int((sub[:, 6] + sub[:, 3]).max()) + 2 + 15) // 16)
    bmax = int(sub[:, 7].max())
    meta = upload(aligner._pack_meta(sub), aligner.device)
    words, reads = aligner._ref_text()[0], st.reads_dev[0]
    dense = dense_from_gather(words, reads, meta, XMAX, YMAX)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    out, runs = swg_traceback(words, words.shape[0], reads, meta, XMAX,
                              YMAX, 24, band_max=bmax)
    torch.cuda.synchronize()
    k_ms = (time.perf_counter() - t0) * 1e3
    out_d, runs_d = swg_traceback_dense(*dense, XMAX, YMAX, 24, band_max=bmax)
    torch.cuda.synchronize()
    launches = read_launches()
    check(bool((out_d == out).all()) and bool((runs_d == runs).all()),
          "kernel 4's dense form differs from its gather form on the chunk")
    fused = swg_stream(words, words.shape[0], reads, meta, XMAX, YMAX,
                       SMAX, band_max=bmax, fused=True).cpu().numpy()
    out, runs = out.cpu().numpy(), runs.cpu().numpy()
    check((out[:, :3] == fused[:, :3]).all(),
          "kernel 4's scores and best cells differ from kernel 2's")
    xlen, ylen = sub[:, 6], sub[:, 3]
    stream = decode_stream_batch(fused, xlen, ylen)
    ok = np.flatnonzero(out[:, 3] >= 0)
    alns = {}
    differ = 0
    for k in ok.tolist():
        alns[k] = decode_runs_one(runs[k], int(out[k, 3]), int(out[k, 0]),
                                  int(out[k, 1]), int(out[k, 2]),
                                  int(xlen[k]), int(ylen[k]))
        differ += alns[k] != stream[k]
    sample = np.random.default_rng(0).choice(ok, min(2000, len(ok)),
                                             replace=False)
    t1 = time.perf_counter()
    oracle_differ = 0
    for k in sample.tolist():
        x, y = aligner._problem_bytes(st, sub[k])
        band, xd = int(sub[k, 7]), int(sub[k, 8])
        oracle_differ += alns[k] != SwgExtend(band).extend(x, y, band, xd)
    log(f"  chunk at full band: {len(sub)} problems, XMAX {XMAX} YMAX {YMAX} "
        f"RMAX 24 (stream SMAX {SMAX}); launches {launches}, gather form "
        f"{k_ms:.3f} ms wall with sync, dense form == gather form; "
        f"nruns = -1 rows: "
        f"{len(sub) - len(ok)}; rows with nruns >= 0: {len(ok)}, decoded "
        f"!= kernel 2's decoded stream: {differ}; {len(sample)} sampled "
        f"rows != SwgExtend: {oracle_differ} "
        f"(oracle {time.perf_counter() - t1:.1f} s)")
    check(launches["swg_traceback"] >= 1
          and launches["swg_traceback_dense"] >= 1,
          "kernel 4 did not launch in both forms on its path")
    check(differ == 0, f"{differ} decoded runs differ from kernel 2's streams")
    check(oracle_differ == 0, f"{oracle_differ} sampled rows differ from "
          "the scalar oracle")
    return launches["swg_traceback"], launches["swg_traceback_dense"]


def mixed_pairs(index, n=240, seed=11):
    """tests/test_paired_emit.py::make_mixed_pairs on this genome: FR
    pairs, every sixth with a junk mate (unmapped, not rescuable), every
    sixth with a mate mutated at every 15th base (no seed, rescuable),
    and one pair of two junk reads."""
    from thermite_tpu_torch.io.fastx import revcomp

    ref = index.refs[0]
    chrom = index.seq[ref.start_idx : ref.end_idx - 1]
    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    rot = {65: 67, 67: 71, 71: 84, 84: 65}
    q = b"I" * 90
    pairs = []
    for i in range(n):
        p = int(rng.integers(0, len(chrom) - 300))
        frag = chrom[p : p + 300]
        r1, r2 = frag[:90], revcomp(frag[-90:])
        if i % 2:
            r1, r2 = r2, r1
        if i % 6 == 3:
            r2 = rng.choice(acgt, 90).tobytes()
        elif i % 6 == 5:
            r2 = bytes(rot.get(b, 65) if k >= 10 and (k - 10) % 15 == 0 else b
                       for k, b in enumerate(r2))
        pairs.append(((b"m%d" % i, r1, q), (b"m%d" % i, r2, q)))
    pairs.append(((b"junkpair", rng.choice(acgt, 90).tobytes(), q),
                  (b"junkpair", rng.choice(acgt, 90).tobytes(), q)))
    return pairs


def paired_referee(index, aligner, pairs, rescue_opts) -> bytes:
    """tests/test_paired_emit.py:82-103 on the card: the port's
    align_batch on the interleaved mates, then pair_records and the
    Python writers."""
    from thermite_tpu_torch.align.paired import pair_records
    from thermite_tpu_torch.io.bam import encode_bam_record
    from thermite_tpu_torch.io.sam import unique_refs
    from thermite_tpu_torch.align.paired import _Rec

    res = aligner.align_batch([m[1] for pair in pairs for m in pair])
    ref_ids = {n: i for i, (n, _) in enumerate(unique_refs(index))}
    return b"".join(
        encode_bam_record(rec, ref_ids)
        for k, (r1, r2) in enumerate(pairs)
        for rec in pair_records(index, _Rec(*r1), _Rec(*r2), res[2 * k],
                                res[2 * k + 1], 1000, rescue_opts=rescue_opts))


def _paired_counters(stats):
    return {k: getattr(stats, k, 0)
            for k in ("emit_cpp_chunks", "spliced_pairs", "emit_py_chunks")}


def phase_paired(index, opts, aligner):
    """The paired syn45 workload through align_paired_emit (BAM): counted
    launches, proper pairs, reads/s (both mates) over 5 runs; the first
    2000 pairs and a mixed set (junk and rescuable mates, rescue on)
    equal the referee.  -> (pairs, BAM of the first 2000 pairs).  The pairs
    are bench.py:138-166's (tools/workloads.py::fr_pairs)."""
    import torch

    from thermite_tpu_torch.tools.workloads import first_chrom, fr_pairs

    pairs = fr_pairs(first_chrom(index), N_READS // 2)
    aligner.align_paired_emit(pairs[:1024], True)  # warm-up
    torch.cuda.synchronize()
    aligner.stats.reset()
    for k in _paired_counters(aligner.stats):
        setattr(aligner.stats, k, 0)
    reset_launches()
    t0 = time.perf_counter()
    raw = aligner.align_paired_emit(pairs, True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    stats = aligner.stats
    counters = _paired_counters(stats)
    flags = _bam_primary_flags(raw)
    proper = float(np.mean((flags & 2) != 0)) if len(flags) else 0.0
    log(f"  paired: {len(pairs)} pairs ({2 * len(pairs)} reads), "
        f"{stats.chunks} chunks, launches {launches}, {counters}, "
        f"{len(raw)} BAM bytes, primary records {len(flags)}, proper "
        f"pairs (0x2) {100 * proper:.2f}%, cert patches {stats.cert_patches}, "
        f"wall {wall:.3f} s = {2 * len(pairs) / wall:.1f} reads/s")
    log(stats.report())
    check(len(flags) == 2 * len(pairs),
          f"{len(flags)} primary records for {2 * len(pairs)} reads")
    check(launches["swg_stream"] >= stats.chunks >= 1,
          f"{launches} kernel launches for {stats.chunks} chunks")
    check(counters["emit_py_chunks"] == 0, "a paired chunk fell back to Python")
    check(proper > 0.9, f"only {100 * proper:.2f}% proper pairs")
    timed_runs(lambda: aligner.align_paired_emit(pairs, True), 2 * len(pairs),
               wall)

    sub = pairs[:2000]
    got_sub = aligner.align_paired_emit(sub, True)
    same = got_sub == paired_referee(index, aligner, sub, opts)
    mixed = mixed_pairs(index)
    before = _paired_counters(aligner.stats)["spliced_pairs"]
    got_mixed = aligner.align_paired_emit(mixed, True)
    spliced = _paired_counters(aligner.stats)["spliced_pairs"] - before
    same_mixed = got_mixed == paired_referee(index, aligner, mixed, opts)
    log(f"  referee (align_batch + pair_records + Python writers): first "
        f"2000 pairs equal: {same}; {len(mixed)} mixed pairs equal: "
        f"{same_mixed}, spliced (rescue) pairs {spliced}")
    check(same, "paired BAM differs from the referee on the first 2000 pairs")
    check(same_mixed and spliced >= 2,
          "paired BAM differs from the referee on the mixed pairs")
    return pairs, got_sub


def phase_cpp(index, opts, aligner, recs, pairs, paired_sub):
    """The port's CppAligner: phase 3's BAM bytes on the first 4096
    reads at N threads, the paired BAM of phase 3d on 2000 pairs, and
    reads/s on the 49152 reads at 1 thread and at N threads (the
    same-host C++ baseline)."""
    from thermite_tpu_torch.align.cpu import CppAligner

    n = os.cpu_count() or 1
    cpp_n = CppAligner(index, opts, threads=n)
    cpp_1 = CppAligner(index, opts, threads=1)
    sub = recs[:4096]
    same = cpp_n.align_records(sub, True) == aligner.align_batch_emit(sub, True)
    same_p = cpp_n.align_records_paired(pairs[:2000], True) == paired_sub
    log(f"  CppAligner at {n} threads: first 4096 reads' BAM == batch path: "
        f"{same}; 2000 pairs' BAM == phase 3d: {same_p}")
    check(same and same_p, "the cpp engine's BAM differs from the batch path")
    for cpp in (cpp_1, cpp_n):
        rates = []
        for _ in range(3):
            t0 = time.perf_counter()
            cpp.align_records(recs, True)
            rates.append(len(recs) / (time.perf_counter() - t0))
        log(f"  cpp engine, {cpp.threads} thread(s), {len(recs)} reads: "
            f"reads/s " + " ".join(f"{r:.1f}" for r in rates)
            + f"; median {float(np.median(rates)):.1f}")


def phase_oracle(index, opts, aligner, recs):
    """SAM records of the first reads == the sequential oracle's."""
    from thermite_tpu_torch.tools.fuzz_parity import oracle_alignments, oracle_sam

    sub = recs[:N_ORACLE]
    got = aligner.align_batch_emit(sub, False)
    want = oracle_sam(index, sub, oracle_alignments(
        index, opts, [r[1] for r in sub], aligner.seeder))
    n_lines = want.count(b"\n")
    log(f"  {len(sub)} reads: {n_lines} SAM records, port == oracle: "
        f"{got == want}")
    check(got == want, "SAM records differ from the oracle's")


def phase_cli(index, tmp, recs):
    """The user entry points: save the index, then the port's CLI aligns
    a FASTQ to SAM from the loaded artifact; == the in-memory emit."""
    from thermite_tpu_torch.io.sam import build_sam_header
    from thermite_tpu_torch.testing.synth import write_fastq
    from thermite_tpu_torch.cli import main as cli_main

    sub = recs[:2000]
    fq = os.path.join(tmp, "reads.fq")
    write_fastq([(n.decode(), s) for n, s, _ in sub], fq)
    art = os.path.join(tmp, "syn45.tai.npz")
    t0 = time.perf_counter()
    index.build_seed_table(stride=1)
    index.save(art)
    t1 = time.perf_counter()
    out = os.path.join(tmp, "out.sam")
    rc = cli_main(["align", art, fq, "-a", "-o", out, "-k", "20", "-s", "0",
                   "--intron-mode"])
    t2 = time.perf_counter()
    with open(out, "rb") as f:
        got = f.read()
    return got, t1 - t0, t2 - t1, rc, build_sam_header(index).encode()


def phase_entry_points(opts, aligner, tmp, recs, pairs, header, single_sam):
    """The other entry points on the phase 6 artifact, 2000 reads or
    pairs each, against their in-memory counterparts: the CLI with
    --paired, with --engine cpp, two host shards joined by merge (== the
    single CLI run), and the wrapper's two record surfaces."""
    from thermite_tpu_torch.testing.synth import write_fastq
    from thermite_tpu_torch.cli import main as cli_main
    from thermite_tpu_torch.wrapper import ThermiteAligner

    art = os.path.join(tmp, "syn45.tai.npz")
    flags = ["-a", "-k", "20", "-s", "0", "--intron-mode"]
    fq = os.path.join(tmp, "reads.fq")
    sub, psub = recs[:2000], pairs[:2000]
    fq1, fq2 = os.path.join(tmp, "r1.fq"), os.path.join(tmp, "r2.fq")
    write_fastq([(m[0].decode(), m[1]) for m, _ in psub], fq1)
    write_fastq([(m[0].decode(), m[1]) for _, m in psub], fq2)

    def cli(out, *args):
        t0 = time.perf_counter()
        rc = cli_main(["align", art, *args, "-o", out, *flags])
        with open(out, "rb") as f:
            return rc, f.read(), time.perf_counter() - t0

    results = {}
    rc, got, s = cli(os.path.join(tmp, "paired.sam"), fq1, fq2, "--paired")
    results["CLI --paired"] = (rc, got == header + aligner.align_paired_emit(
        psub, False), s)
    rc, got, s = cli(os.path.join(tmp, "cpp.sam"), fq, "--engine", "cpp")
    results["CLI --engine cpp"] = (rc, got == single_sam, s)
    shard_out = os.path.join(tmp, "sharded.sam")
    t0 = time.perf_counter()
    rcs = [cli_main(["align", art, fq, "-o", shard_out, *flags, "--num-hosts",
                     "2", "--host-id", h]) for h in ("0", "1")]
    merged = os.path.join(tmp, "merged.sam")
    rcs.append(cli_main(["merge", "-o", merged, shard_out + ".shard000",
                         shard_out + ".shard001"]))
    with open(merged, "rb") as f:
        results["2 host shards + merge"] = (max(rcs), f.read() == single_sam,
                                            time.perf_counter() - t0)
    t0 = time.perf_counter()
    w = ThermiteAligner(art, device="cuda")
    w.set_opts(opts)
    names, seqs, quals = ([r[k] for r in sub] for k in range(3))
    same = w.align_reads_records(names, seqs, quals) == \
        aligner.align_batch_emit(sub, False, strip_tags=True)
    results["wrapper align_reads_records"] = (0, same, time.perf_counter() - t0)
    t0 = time.perf_counter()
    same = w.align_read_pairs_records(
        [m[0] for m, _ in psub], [m[1] for m, _ in psub],
        [m[2] for m, _ in psub], [m[1] for _, m in psub],
        [m[2] for _, m in psub]) == aligner.align_paired_emit(
            psub, False, strip_tags=True)
    results["wrapper align_read_pairs_records"] = (0, same,
                                                   time.perf_counter() - t0)
    rc, got, s = cli(os.path.join(tmp, "v_after.sam"), fq, "-v")
    results["CLI -v after the subcommand"] = (rc, got == single_sam, s)
    rc, got, s = cli(os.path.join(tmp, "mesh.sam"), fq, "--mesh", "-1")
    results["CLI --mesh -1"] = (rc, got == single_sam, s)
    trace_dir = os.path.join(tmp, "trace")
    rc, got, s = cli(os.path.join(tmp, "profiled.sam"), fq, "--profile",
                     trace_dir)
    traces = os.listdir(trace_dir)
    with open(os.path.join(trace_dir, traces[0])) as f:
        events = json.load(f)["traceEvents"]
    on_card = [e for e in events if "stream_kernel" in e.get("name", "")]
    log(f"  --profile: {traces}, {len(events)} events, {len(on_card)} "
        f"stream_kernel events (categories "
        f"{sorted({e.get('cat') for e in on_card})})")
    results["CLI --profile"] = (rc, got == single_sam and len(traces) == 1
                                and len(on_card) >= 1, s)
    coord_out = os.path.join(tmp, "coord.sam")
    t0 = time.perf_counter()
    rcs = [cli_main(["align", art, fq, "-o", coord_out, *flags, "--num-hosts",
                     "2", "--host-id", h, "--coordinator", "localhost:9876"])
           for h in ("0", "1")]
    merged = os.path.join(tmp, "coord_merged.sam")
    rcs.append(cli_main(["merge", "-o", merged, coord_out + ".shard000",
                         coord_out + ".shard001"]))
    with open(merged, "rb") as f:
        results["--coordinator, 2 host shards + merge"] = (
            max(rcs), f.read() == single_sam, time.perf_counter() - t0)
    os.environ["THERMITE_NO_EMIT"] = "1"
    try:
        rc, got, s = cli(os.path.join(tmp, "no_emit.sam"), fq)
    finally:
        del os.environ["THERMITE_NO_EMIT"]
    results["CLI under THERMITE_NO_EMIT=1"] = (rc, got == single_sam, s)
    for name, (rc, same, s) in results.items():
        log(f"  {name}: rc {rc}, == in-memory: {same} ({s:.1f} s)")
        check(rc == 0 and same, f"{name} differs from its in-memory counterpart")


def sass_column_loops(lib_path: str) -> dict:
    """{kernel entry: [instruction counts of each column loop]} from
    `cuobjdump -sass`: the innermost loops (a predicated backward branch
    and its target, with no other such loop inside; an unpredicated one
    returns from a cold block placed after the code) that hold SHFL, REDUX
    or VOTE instructions, counted by kind, in address order.  A stream
    kernel has one; a per-warp kernel one for each of its three group
    shapes (16, 32 and 8 lanes in the order the compiler lays them out,
    told apart by their 1 + log2(lanes) scan shuffles).  A loop holds both
    forms of the column, anchored and sliding; a column runs one."""
    import re
    import shutil

    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out = subprocess.run([exe, "-sass", lib_path], capture_output=True,
                         text=True, timeout=300).stdout
    kinds = ("SHFL", "REDUX", "VOTE", "LDS", "STS")
    mix = {}
    for block in out.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        ins = [(int(a, 16), t) for a, t in re.findall(
            r"/\*([0-9a-f]{4,})\*/\s+([^;]+);", block)]
        loops = {}  # loop head -> its last backward branch
        for addr, text in ins:
            m = re.search(r"^@.*\bBRA\b.*?0x([0-9a-f]+)", text.strip())
            if m and int(m.group(1), 16) < addr:
                loops[int(m.group(1), 16)] = addr
        mix[name] = []
        for head, end in sorted(loops.items()):
            if any(head <= h and e <= end and (h, e) != (head, end)
                   for h, e in loops.items()):
                continue
            body = [t for a, t in ins if head <= a <= end]
            if any(k in t for t in body for k in kinds[:3]):
                mix[name].append({**{k: sum(k in t for t in body)
                                     for k in kinds}, "all": len(body)})
    return mix


def time_kernels(out_path: str) -> None:
    """The --time-kernels mode: every kernel's ms per launch (20 launches
    after 3 warm-up launches) at the synthetic chunk shapes, as generated
    and with rows ordered by ylen, and on one real syn45 chunk, and the
    instruction mix of every kernel's column loops, printed and written to
    `out_path` as one JSON object."""
    import torch

    from thermite_tpu_torch.align.batch import BatchAligner
    from thermite_tpu_torch.ops import _build
    from thermite_tpu_torch.ops.layout import pack_meta_host
    from thermite_tpu_torch.ops.swg_forward import swg_forward
    from thermite_tpu_torch.ops.swg_stream import swg_stream
    from thermite_tpu_torch.ops.swg_traceback import (
        swg_traceback,
        swg_traceback_dense,
    )
    from thermite_tpu_torch.testing.synth import make_truth_reads

    dev = torch.device("cuda", 0)
    res = {"sass": {}, "ms": {}}
    for path in _build.build_kernels().values():
        res["sass"].update(sass_column_loops(path))

    def timed(name, launch):
        res["ms"][name] = time_launches(launch, 20, warm=3)
        log(f"  {name}: {res['ms'][name]:.4f} ms")

    t, r, m, xm, ym = chunk_problems(8, 65536)
    for order, rows in (("", m), (", rows by ylen", by_ylen(m))):
        w, rn, mt = _to_dev(t, r, pack_meta_host(rows), dev)
        timed(f"kernel 1, synthetic chunk shape (band<=15){order}",
              lambda: swg_stream(w, w.shape[0], rn, mt, xm, ym, 208, band_max=15))
        timed(f"kernel 3, synthetic chunk shape (band<=15){order}",
              lambda: swg_forward(w, w.shape[0], rn, mt, xm, ym, band_max=15))
        timed(f"kernel 4, synthetic chunk shape (band<=15, RMAX 24){order}",
              lambda: swg_traceback(w, w.shape[0], rn, mt, xm, ym, 24, band_max=15))
    t, r, m, xm, ym = chunk_problems(9, 65536, wide=60, narrow=60)
    for order, rows in ((", rows by ylen", by_ylen(m)), ("", m)):
        w, rn, mt = _to_dev(t, r, pack_meta_host(rows), dev)
        timed(f"kernel 2, synthetic chunk shape (band 60){order}",
              lambda: swg_stream(w, w.shape[0], rn, mt, xm, ym, 256, band_max=60))
        timed(f"kernel 3, synthetic chunk shape (band 60){order}",
              lambda: swg_forward(w, w.shape[0], rn, mt, xm, ym, band_max=60))
        timed(f"kernel 4, synthetic chunk shape (band 60, RMAX 24){order}",
              lambda: swg_traceback(w, w.shape[0], rn, mt, xm, ym, 24, band_max=60))
        dense = dense_from_gather(w, rn, mt, xm, ym)
        timed(f"kernel 4 dense form, synthetic chunk shape (band 60, RMAX 24){order}",
              lambda: swg_traceback_dense(*dense, xm, ym, 24, band_max=60))

    os.makedirs(os.path.join(ROOT, "data", "out"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "data", "out")) as tmp:
        index, opts = syn45_index(tmp)
    aligner = BatchAligner(index, opts, device="cuda")
    reads = [s for _, s in make_truth_reads(index, N_READS, seed=3)]
    aligner._RPAD = 96  # the read block's row width, as the pipeline sets it
    st = None
    rng = np.random.default_rng(0)
    # narrowed first: the pinned shapes only grow
    for name, narrow_band in (("syn45 chunk narrowed to band 15", 15),
                              ("syn45 chunk at band 60", 0)):
        aligner.narrow_band = narrow_band
        aligner._pin_shapes(reads)
        if st is None:
            st, _ = aligner._build_chunk(reads, 0)
        args, bmax, nsub, _ = chunk_launch(aligner, st)
        perm = torch.from_numpy(rng.permutation(args[3].shape[0])).to(dev)
        stream_k = 1 if narrow_band else 2
        for order, meta in (("pipeline order", args[3]),
                            ("shuffled", args[3][perm].contiguous())):
            rows = f"{nsub} rows of {meta.shape[0]}, {order}"
            timed(f"kernel {stream_k}, {name}, {rows}",
                  lambda: swg_stream(*args[:3], meta, *args[4:], band_max=bmax))
            timed(f"kernel 3, {name}, {rows}",
                  lambda: swg_forward(*args[:3], meta, *args[4:6], band_max=bmax))
            timed(f"kernel 4, {name}, RMAX 24, {rows}",
                  lambda: swg_traceback(*args[:3], meta, *args[4:6], 24,
                                        band_max=bmax))
    aligner.native.free_chunk(st.native_ch)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    with open(out_path, "w") as f:
        json.dump(res, f, indent=1)


def run_fuzz(index) -> None:
    t = time.perf_counter()
    log(f"phase 8: adversarial parity fuzz on syn45 ({N_FUZZ} reads of 90 bp "
        f"and {N_FUZZ} of 40-150 bp against the oracle, four regimes)")
    phase_fuzz(index)
    log(f"phase 8 done in {time.perf_counter() - t:.1f} s")


def run(kernels_only: bool = False, mesh_only: bool = False,
        genome_only: bool = False, fuzz_only: bool = False) -> dict:
    import torch

    t = time.perf_counter()
    log("phase 1: card and build")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "unknown"
    log("  nvidia-smi --query-gpu=name,power.limit --format=csv,noheader:")
    log(card)
    log(f"  torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    from thermite_tpu_torch.ops import _build

    t0 = time.perf_counter()
    paths = _build.build_kernels()
    log(f"  kernels built in parallel in {time.perf_counter() - t0:.1f} s")
    for name, path in paths.items():
        log(f"  {name}: {os.path.relpath(path, ROOT)}")
        for line in _build.build_log.get(name, "").splitlines():
            if any(k in line for k in ("entry function", "registers", "spill")):
                log(f"    {line.strip()}")
    t0 = time.perf_counter()
    engine = _build.native_engine()
    log(f"  C++ host engine {os.path.relpath(engine, ROOT)} ready in "
        f"{time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    log(f"phase 1 done in {time.perf_counter() - t:.1f} s")
    if mesh_only:
        os.makedirs(os.path.join(ROOT, "data", "out"), exist_ok=True)
        with tempfile.TemporaryDirectory(
                dir=os.path.join(ROOT, "data", "out")) as tmp:
            log("phase 3: syn45 main path (BatchAligner.align_batch_emit, BAM)")
            index, opts, aligner, recs, warm, raw, n3, rate3 = phase_syn45(tmp)
            log("phase 3f: syn45 under a mesh (BatchAligner(mesh=...))")
            phase_mesh(index, opts, aligner, recs, warm, raw, n3, rate3)
        return {}
    if genome_only:
        t = time.perf_counter()
        log(f"phase 7: genome scale, {GENOME_GBP} Gbp, stride 4")
        phase_genome(GENOME_GBP)
        log(f"phase 7 done in {time.perf_counter() - t:.1f} s")
        return {}
    if fuzz_only:
        os.makedirs(os.path.join(ROOT, "data", "out"), exist_ok=True)
        with tempfile.TemporaryDirectory(
                dir=os.path.join(ROOT, "data", "out")) as tmp:
            t = time.perf_counter()
            index, _ = syn45_index(tmp)
            log(f"  syn45 indexed in {time.perf_counter() - t:.1f} s")
        run_fuzz(index)
        return {}

    t = time.perf_counter()
    log("phase 2: packed stream kernel vs swg_stream_plain (bit-exact)")
    worst1, time1 = phase_kernel(dev)
    log(f"phase 2 done in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    log("phase 2b: general-band stream kernel vs swg_stream_plain (bit-exact)")
    cases = general_band_cases()
    worst2, time2 = phase_kernel_wide(dev, cases)
    log(f"phase 2b done in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    log("phase 2c: forward-scores kernel vs swg_forward_plain (bit-exact)")
    worst3, time3 = phase_kernel_forward(dev, cases)
    log(f"phase 2c done in {time.perf_counter() - t:.1f} s")
    del cases

    t = time.perf_counter()
    log("phase 2d: run-length traceback kernel vs its plain versions "
        "(bit-exact)")
    worst4, time4, time4d = phase_kernel_traceback(dev)
    log(f"phase 2d done in {time.perf_counter() - t:.1f} s")

    launches = dict.fromkeys(_wrappers())
    err = 0
    if not kernels_only:
        os.makedirs(os.path.join(ROOT, "data", "out"), exist_ok=True)
        with tempfile.TemporaryDirectory(
                dir=os.path.join(ROOT, "data", "out")) as tmp:
            t = time.perf_counter()
            log("phase 3: syn45 main path (BatchAligner.align_batch_emit, BAM)")
            (index, opts, aligner, recs, warm, raw, launches["swg_stream"],
             rate3) = phase_syn45(tmp)
            log(f"phase 3 done in {time.perf_counter() - t:.1f} s")

            t = time.perf_counter()
            log("phase 3b: syn45 at full band (narrow_band 0)")
            launches["swg_stream_wide"] = phase_full_band(index, opts, recs,
                                                          warm, raw)
            log(f"phase 3b done in {time.perf_counter() - t:.1f} s")

            t = time.perf_counter()
            log(f"phase 3c: syn45 without the C++ engine on {N_NO_NATIVE} reads")
            launches["swg_forward"] = phase_no_native(index, opts, aligner, recs)
            log(f"phase 3c done in {time.perf_counter() - t:.1f} s")

            t = time.perf_counter()
            log("phase 3f: syn45 under a mesh (BatchAligner(mesh=...))")
            phase_mesh(index, opts, aligner, recs, warm, raw,
                       launches["swg_stream"], rate3)
            log(f"phase 3f done in {time.perf_counter() - t:.1f} s")
            del warm, raw

            t = time.perf_counter()
            log(f"phase 3d: paired syn45, {N_READS // 2} FR pairs "
                "(BatchAligner.align_paired_emit, BAM)")
            pairs, paired_sub = phase_paired(index, opts, aligner)
            log(f"phase 3d done in {time.perf_counter() - t:.1f} s")

            t = time.perf_counter()
            log("phase 3e: the cpp engine (CppAligner)")
            phase_cpp(index, opts, aligner, recs, pairs, paired_sub)
            log(f"phase 3e done in {time.perf_counter() - t:.1f} s")

            t = time.perf_counter()
            log("phase 4: C++ full-band referee on one syn45 chunk")
            err, time1, st = phase_cpp_referee(aligner, recs)
            log(f"phase 4 done in {time.perf_counter() - t:.1f} s")

            t = time.perf_counter()
            log("phase 4b: kernel 4 on its path, the phase 4 chunk at full "
                "band against kernel 2 and the scalar oracle")
            launches["swg_traceback"], launches["swg_traceback_dense"] = \
                phase_traceback_path(aligner, st)
            del st
            log(f"phase 4b done in {time.perf_counter() - t:.1f} s")

            t = time.perf_counter()
            log(f"phase 5: oracle referee on the first {N_ORACLE} reads")
            phase_oracle(index, opts, aligner, recs)
            log(f"phase 5 done in {time.perf_counter() - t:.1f} s")

            t = time.perf_counter()
            log("phase 6: CLI (index save/load, align to SAM) on 2000 reads")
            got, save_s, align_s, rc, header = phase_cli(index, tmp, recs)
            want = header + aligner.align_batch_emit(recs[:2000], False)
            log(f"  index save {save_s:.1f} s, CLI align {align_s:.1f} s, "
                f"rc {rc}, CLI SAM == in-memory emit: {got == want}")
            check(rc == 0 and got == want,
                  "CLI SAM differs from the in-memory emit")
            phase_entry_points(opts, aligner, tmp, recs, pairs, header, got)
            log(f"phase 6 done in {time.perf_counter() - t:.1f} s")
        del aligner, recs, pairs
        run_fuzz(index)
        del index

        t = time.perf_counter()
        log(f"phase 7: genome scale, {GENOME_GBP} Gbp, stride 4")
        phase_genome(GENOME_GBP, time1)
        log(f"phase 7 done in {time.perf_counter() - t:.1f} s")

    def record(name, source, replaces, worst, timing):
        """One kernel's line: its time, the plain version's and its bound
        (the packed stream kernel's on the real syn45 chunk of phase 4,
        the others' at the 65536-row synthetic chunk shape of their path,
        phases 2b-2d; kernels 3 and 4 with its rows ordered by ylen, as a
        pipeline submits them), its launches on its path's run.  No single
        PyTorch call computes a banded affine-gap SWG with X-drop and
        traceback, so there is no library time."""
        k_ms, p_ms, bound = timing
        return {"name": name, "route": "cuda",
                "source": f"thermite_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms,
                "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                "library_ms": None}

    return {"kernels": [
        record("swg_stream", "swg_stream.cu",
               "thermite_tpu/ops/swg_pallas_packed.py:88",
               max(worst1, err), time1),
        record("swg_stream_wide", "swg_stream.cu",
               "thermite_tpu/ops/swg_pallas.py:409", worst2, time2),
        record("swg_forward", "swg_forward.cu",
               "thermite_tpu/ops/swg_pallas.py:185", worst3, time3),
        record("swg_traceback", "swg_traceback.cu",
               "thermite_tpu/ops/swg_pallas.py:244", worst4, time4),
        record("swg_traceback_dense", "swg_traceback.cu",
               "thermite_tpu/ops/swg_pallas.py:244", worst4, time4d),
    ]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    try:
        if "--time-kernels" in sys.argv[1:]:
            time_kernels(sys.argv[sys.argv.index("--time-kernels") + 1])
            return 0
        if "--mesh-only" in sys.argv[1:]:
            run(mesh_only=True)
            print("chip_smoke: phases 1, 3 and 3f passed on "
                  f"{torch.cuda.device_count()} card(s)")
            return 0
        if "--genome-only" in sys.argv[1:]:
            run(genome_only=True)
            print("chip_smoke: phases 1 and 7 passed")
            return 0
        if "--fuzz-only" in sys.argv[1:]:
            run(fuzz_only=True)
            print("chip_smoke: phases 1 and 8 passed")
            return 0
        result = run(kernels_only="--kernels-only" in sys.argv[1:])
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    except Exception:  # a phase that raised: report it and fail the run
        import traceback

        traceback.print_exc()
        return 1
    print(json.dumps(result))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
