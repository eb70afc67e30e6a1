#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (thermite_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py                 # every phase
    python3 chip_smoke.py --kernels-only  # phases 1, 2, 2b, 2c and 2d

Phases, each printed with its own timing; any failure exits non-zero
before the result lines are printed:

1. require CUDA; print the card's name and power limit; build the four
   CUDA kernels (one nvcc each, in parallel, sm_90a) and the C++ host
   engine (g++); print the registers and spills of every kernel.
2. swg_stream's packed kernel (bands <= 31) == swg_stream_plain
   (bit-exact, tolerance 0) on the same CUDA inputs: fuzz shapes for both
   band classes and meta forms, the narrow-band certificate shapes, and
   one full main-path chunk shape (65536 rows, XMAX 96, YMAX 128,
   band <= 15, SMAX 208), with both times.
2b. the general-band stream kernel (swg_stream_wide) == swg_stream_plain,
   bit-exact: fuzz shapes at bands <= 63, <= 127 and <= 255 in both meta
   forms (windows up to 512 for the widest), bands above XMAX (up to
   1023 slots), and the full-band chunk shape (65536 rows, XMAX 96,
   YMAX 160, band 60, SMAX 256), with both times.
2c. the forward-scores kernel (swg_forward) == swg_forward_plain,
   bit-exact, on the same kinds of shapes, with both times at the
   full-band chunk shape.
2d. the run-length traceback kernel (swg_traceback, swg_traceback_dense)
   == its plain versions, bit-exact: gather fuzz shapes for every slot
   class in both meta forms, dense shapes (bands above XMAX among them),
   RMAX 1, 4, 24 and 64 with overflow rows and rows of exactly RMAX runs,
   and the full-band chunk shape (65536 rows, XMAX 96, YMAX 160, band 60,
   RMAX 24), with both times.
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
4. C++ referee: every row of one syn45 chunk that the kernel certified
   equals the full-band scalar SWG of the C++ engine (native.patch_rows).
5. oracle referee: the SAM records of the first 200 reads equal the
   reference OracleAligner's through the reference SAM writers.
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
   stream row, 2000 sampled rows to the scalar oracle SwgExtend.
6. the user entry points: the index saved and loaded, and the port's CLI
   aligning 2000 reads to SAM, equal to the in-memory emit; the CLI with
   --paired and with --engine cpp, two host shards joined by merge, and
   the wrapper's record surfaces, each equal to its in-memory
   counterpart.

The last lines are one JSON object of kernel records and one JSON object
naming the device.  Nothing of JAX is imported.
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


def _to_dev(text, reads, meta, dev):
    import torch

    from thermite_tpu_torch.ops.layout import pack_reads_nib_host, pack_text_nib_host

    words = torch.from_numpy(pack_text_nib_host(text)).to(dev)
    rnib = torch.from_numpy(pack_reads_nib_host(reads.reshape(-1))).to(dev)
    return words, rnib, torch.from_numpy(np.ascontiguousarray(meta)).to(dev)


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
    ms = None
    if reps:
        start, stop = torch.cuda.Event(True), torch.cuda.Event(True)
        start.record()
        for _ in range(reps):
            kernel(*args)
        stop.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(stop) / reps
    return nbad, err, ms, plain_ms, got.cpu().numpy()


def _nsteps(rows: np.ndarray) -> np.ndarray:
    """nsteps of split stream rows (int16 halves in the first 2 words)."""
    return np.ascontiguousarray(rows[:, :2]).view(np.int16)[:, 3]


def run_cases(dev, cases, kernel, plain=None, stream=True):
    """Each case through compare_kernel (the 65536-row ones timed), the
    kernel's wrapper given the case's band bound as the batch pipeline
    gives it (no device read per launch); -> (worst max_abs_err, (ms,
    plain_ms) of the last timed case)."""
    import torch

    from thermite_tpu_torch.ops.swg_stream import meta9

    worst, timing = 0, (None, None)
    for name, t, r, m, xm, ym, extra in cases:
        words, rnib, mt = _to_dev(t, r, m, dev)
        bmax = int(meta9(torch.from_numpy(np.ascontiguousarray(m)))[:, 7].max())
        nbad, err, ms, plain_ms, got = compare_kernel(
            (words, words.shape[0], rnib, mt, xm, ym, *extra),
            reps=20 if len(m) == 65536 else 0,
            kernel=functools.partial(kernel, band_max=bmax), plain=plain,
        )
        timing = (ms, plain_ms) if ms is not None else timing
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


def phase_kernel(dev):
    """The packed kernel == plain on synthetic cases; -> (worst
    max_abs_err, (ms, plain_ms) at the main-path chunk shape)."""
    from thermite_tpu_torch.ops.layout import pack_meta_host
    from thermite_tpu_torch.ops.swg_stream import swg_stream

    cases = []
    for seed, bmax in ((0, 15), (1, 31)):
        cases += both_meta_forms(f"fuzz band<={bmax}",
                                 *fuzz_problems(seed, 4096, bmax), (256,))
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
    (ms, plain_ms) at the full-band chunk shape)."""
    from thermite_tpu_torch.ops.swg_stream import swg_stream_wide

    launches = swg_stream_wide.launches
    out = run_cases(dev, cases, swg_stream_wide)
    check(swg_stream_wide.launches - launches >= len(cases),
          "the general-band kernel did not launch on every case")
    return out


def phase_kernel_forward(dev, cases):
    """The forward-scores kernel == plain; -> (worst max_abs_err,
    (ms, plain_ms) at the full-band chunk shape)."""
    from thermite_tpu_torch.ops.swg_forward import swg_forward, swg_forward_plain

    extra = both_meta_forms("fuzz band<=15", *fuzz_problems(15, 4096, 15), ())
    launches = swg_forward.launches
    out = run_cases(dev, extra + [c[:6] + ((),) for c in cases],
                    swg_forward, plain=swg_forward_plain, stream=False)
    check(swg_forward.launches - launches >= len(cases) + len(extra),
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
    shapes for every slot class in both meta forms, dense shapes (bands
    above XMAX among them), RMAX 1, 4, 24 and 64, and the full-band
    chunk shape (65536 rows, XMAX 96, YMAX 160, band 60, RMAX 24)."""
    from thermite_tpu_torch.ops.layout import pack_meta_host

    gather = [  # name, seed, n, band_min, band_max, XMAX, YMAX, RMAX
        ("fuzz band<=15 (1 slot)", 20, 4096, 0, 15, 64, 96, 24),
        ("fuzz band 16-31 (2 slots)", 21, 4096, 16, 31, 64, 96, 4),
        ("fuzz band 32-63 (4 slots)", 22, 4096, 32, 63, 64, 96, 64),
        ("fuzz band 64-127 (8 slots)", 23, 2048, 64, 127, 128, 192, 1),
        ("fuzz band 128-255 (16 slots, windows 512)", 24, 1024, 128, 255,
         512, 512, 24),
        ("fuzz band 256-511 (32 slots, windows 512)", 25, 512, 256, 511,
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
    t, r, m, xm, ym = chunk_problems(9, 65536, wide=60, narrow=60)
    cases.append(("full-band chunk shape (65536 rows, band 60, RMAX 24)",
                  "gather", (t, r, pack_meta_host(m)), xm, ym, 24))
    return cases


def phase_kernel_traceback(dev):
    """Kernel 4 (swg_traceback, swg_traceback_dense) == its plain
    versions, bit-exact, on every case; for each RMAX both overflow rows
    (-1) and rows with exactly RMAX runs occur.  -> (worst max_abs_err,
    (ms, plain_ms) at the chunk shape)."""
    import torch

    from thermite_tpu_torch.ops.swg_stream import meta9
    from thermite_tpu_torch.ops.swg_traceback import (
        swg_traceback,
        swg_traceback_dense,
        swg_traceback_dense_plain,
        swg_traceback_plain,
    )

    worst, timing, seen = 0, (None, None), {}
    launches = swg_traceback.launches + swg_traceback_dense.launches
    cases = traceback_cases()
    for name, form, inputs, xm, ym, rmax in cases:
        if form == "gather":
            words, rnib, mt = _to_dev(*inputs, dev)
            bmax = int(meta9(torch.from_numpy(np.ascontiguousarray(inputs[2])))
                       [:, 7].max())
            args = (words, words.shape[0], rnib, mt, xm, ym, rmax)
            rows = mt.shape[0]
            kernel, plain = swg_traceback, swg_traceback_plain
        else:
            args = tuple(torch.from_numpy(a).to(dev) for a in inputs) + (
                xm, ym, rmax)
            bmax = int(inputs[2][:, 2].max())
            rows = len(inputs[2])
            kernel, plain = swg_traceback_dense, swg_traceback_dense_plain
        nbad, err, ms, plain_ms, got = compare_kernel(
            args, reps=20 if rows == 65536 else 0,
            kernel=functools.partial(kernel, band_max=bmax), plain=plain)
        timing = (ms, plain_ms) if ms is not None else timing
        nr = got[:, 3]
        over, exact = int((nr == -1).sum()), int((nr == rmax).sum())
        s = seen.setdefault(rmax, [0, 0])
        s[0] += over
        s[1] += exact
        t_ms = f", kernel {ms:.4f} ms, plain {plain_ms:.1f} ms" if ms else ""
        log(f"  {name}: {len(got)} rows, XMAX {xm} YMAX {ym} RMAX {rmax}, "
            f"nruns -1: {over}, == RMAX: {exact}, max nruns {nr.max()}; "
            f"{nbad} differ, max_abs_err {err}{t_ms}")
        check(nbad == 0, f"kernel 4 != plain on {name}")
        worst = max(worst, err)
    for rmax, (over, exact) in sorted(seen.items()):
        check(over > 0 and exact > 0,
              f"RMAX {rmax}: {over} overflow rows, {exact} rows of RMAX runs")
    check(swg_traceback.launches + swg_traceback_dense.launches - launches
          >= len(cases), "kernel 4 did not launch on every case")
    return worst, timing


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


def reset_launches():
    from thermite_tpu_torch.ops.swg_forward import swg_forward
    from thermite_tpu_torch.ops.swg_stream import swg_stream, swg_stream_wide

    swg_stream.launches = swg_stream_wide.launches = swg_forward.launches = 0


def read_launches() -> dict:
    from thermite_tpu_torch.ops.swg_forward import swg_forward
    from thermite_tpu_torch.ops.swg_stream import swg_stream, swg_stream_wide

    return {"swg_stream": swg_stream.launches,
            "swg_stream_wide": swg_stream_wide.launches,
            "swg_forward": swg_forward.launches}


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


def phase_syn45(tmp):
    """Index syn45 in memory and run the main path once, counted."""
    import torch

    from thermite_tpu.align.driver import AlignOpts
    from thermite_tpu.index.build import Index
    from thermite_tpu.testing.synth import make_truth_reads, write_synth_genome
    from thermite_tpu_torch.align.batch import BatchAligner

    t0 = time.perf_counter()
    fasta, gtf = write_synth_genome(tmp, SYN_BP, seed=1234, basename="syn45")
    index = Index.create_from_files(fasta, gtf)
    t1 = time.perf_counter()
    opts = AlignOpts(min_seed_len=20, min_aln_score_percent=0.0,
                     min_aln_score=30, intron_mode=True)
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
        f"(resident text {aligner._ref_text().numel() * 4 / 1e6:.1f} MB)")

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
    timed_runs(lambda: aligner.align_batch_emit(recs, True), len(recs), wall)
    _profile_run(aligner, recs)
    return index, opts, aligner, recs, warm, raw, launches["swg_stream"]


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
    """One more run under torch.profiler: the device's busy time (the
    union of its kernel and copy intervals) against the run's wall time
    (traced, so slower), and the device time by kernel or copy."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            aligner.align_batch_emit(recs, True)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        spans = sorted((e.time_range.start, e.time_range.end, e.name)
                       for e in prof.events() if e.device_type == DeviceType.CUDA)
    except RuntimeError as e:
        log(f"  profiler unavailable ({e}); device busy share not measured")
        return
    busy_us, reach, by_name = 0, float("-inf"), {}
    for a, b, name in spans:
        busy_us += max(b - max(a, reach), 0)
        reach = max(reach, b)
        t, n = by_name.get(name, (0, 0))
        by_name[name] = (t + b - a, n + 1)
    if not busy_us:
        log("  profiler recorded no device time; device busy share not measured")
        return
    busy = busy_us / 1e6
    log(f"  profiled run: wall {wall:.3f} s, device busy {1e3 * busy:.3f} ms "
        f"({100 * busy / wall:.2f}% of wall, idle {100 - 100 * busy / wall:.2f}%)")
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
        log(f"    {name[:70]}: {t / 1e3:.3f} ms over {n} calls")


def phase_cpp_referee(aligner, recs):
    """One syn45 chunk: kernel == plain on its real rows (timed), and
    every certified row == the C++ full-band scalar SWG."""
    from thermite_tpu_torch.ops.layout import expand_stream_hdr
    from thermite_tpu_torch.ops.swg_stream import swg_stream

    reads = [r[1] for r in recs]
    aligner._pin_shapes(reads)
    st, _ = aligner._build_chunk(reads, 0)
    aligner._dispatch_forward(st)
    hdr = expand_stream_hdr(st.hdr.wait()[: len(st.fwd_idx)])
    dev_streams = st.fwd_streams[: len(st.fwd_idx)].cpu().numpy()
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

    # the same launch again, against the plain version, timed
    sub = aligner._narrow_meta(st.meta_all)[st.fwd_idx]
    meta = aligner._upload(aligner._pack_meta(
        aligner._pad_meta(sub, aligner._NFWD1)))
    words = aligner._ref_text()
    args = (words, words.shape[0], st.reads_dev, meta, aligner._XMAX,
            aligner._YMAX, aligner._SMAX)
    kernel = functools.partial(swg_stream, band_max=int(sub[:, 7].max(initial=1)))
    nbad, err, ms, plain_ms, _ = compare_kernel(args, reps=20, kernel=kernel)
    log(f"  kernel vs plain on this chunk ({len(sub)} rows padded to "
        f"{aligner._NFWD1}, XMAX {aligner._XMAX} YMAX {aligner._YMAX} "
        f"SMAX {aligner._SMAX}): {nbad} differ, max_abs_err {err}, "
        f"kernel {ms:.4f} ms, plain {plain_ms:.1f} ms")
    check(nbad == 0, "kernel != plain on the syn45 chunk")
    aligner.native.free_chunk(st.native_ch)
    st.native_ch = None
    return err, ms, plain_ms, st


def phase_traceback_path(aligner, st):
    """Kernel 4 on its own path, the differential check: the phase 4
    chunk's nontrivial problems at their original band (60), through the
    run-length traceback kernel (RMAX 24) and the general-band stream
    kernel (fused rows).  Every row with nruns >= 0 decodes to the stream
    walk's Alignment, and 2000 sampled rows to the scalar oracle's.
    -> the kernel's launches in this run."""
    import torch

    from thermite_tpu.ops.runs import decode_runs_one, decode_stream_batch
    from thermite_tpu.ops.swg_ref import SwgExtend
    from thermite_tpu_torch.ops.swg_stream import swg_stream
    from thermite_tpu_torch.ops.swg_traceback import swg_traceback

    def up32(v):
        return 32 * ((int(v) + 31) // 32)

    sub = st.meta_all[st.fwd_idx]
    XMAX, YMAX = up32(sub[:, 6].max()), up32(sub[:, 3].max())
    SMAX = 16 * ((int((sub[:, 6] + sub[:, 3]).max()) + 2 + 15) // 16)
    bmax = int(sub[:, 7].max())
    meta = aligner._upload(aligner._pack_meta(sub))
    words = aligner._ref_text()
    torch.cuda.synchronize()
    swg_traceback.launches = 0
    t0 = time.perf_counter()
    out, runs = swg_traceback(words, words.shape[0], st.reads_dev, meta, XMAX,
                              YMAX, 24, band_max=bmax)
    torch.cuda.synchronize()
    k_ms = (time.perf_counter() - t0) * 1e3
    launches = swg_traceback.launches
    fused = swg_stream(words, words.shape[0], st.reads_dev, meta, XMAX, YMAX,
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
        f"RMAX 24 (stream SMAX {SMAX}); kernel 4 launches {launches}, "
        f"{k_ms:.3f} ms wall with sync; nruns = -1 rows: "
        f"{len(sub) - len(ok)}; rows with nruns >= 0: {len(ok)}, decoded "
        f"!= kernel 2's decoded stream: {differ}; {len(sample)} sampled "
        f"rows != SwgExtend: {oracle_differ} "
        f"(oracle {time.perf_counter() - t1:.1f} s)")
    check(launches >= 1, "kernel 4 did not launch on its path")
    check(differ == 0, f"{differ} decoded runs differ from kernel 2's streams")
    check(oracle_differ == 0, f"{oracle_differ} sampled rows differ from "
          "the scalar oracle")
    return launches


def paired_workload(index, n_pairs, seed=51):
    """The paired workload of bench.py:138-166: FR pairs of 90 bp mates
    from 300 bp fragments of the first chromosome, quality I."""
    from thermite_tpu.io.fastx import revcomp

    ref = index.refs[0]
    chrom = index.seq[ref.start_idx : ref.end_idx - 1]
    rng = np.random.default_rng(seed)
    q = b"I" * 90
    pairs = []
    for i in range(n_pairs):
        p = int(rng.integers(0, len(chrom) - 300))
        frag = chrom[p : p + 300]
        pairs.append(((b"p%d" % i, frag[:90], q),
                      (b"p%d" % i, revcomp(frag[-90:]), q)))
    return pairs


def mixed_pairs(index, n=240, seed=11):
    """tests/test_paired_emit.py::make_mixed_pairs on this genome: FR
    pairs, every sixth with a junk mate (unmapped, not rescuable), every
    sixth with a mate mutated at every 15th base (no seed, rescuable),
    and one pair of two junk reads."""
    from thermite_tpu.io.fastx import revcomp

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
    from thermite_tpu.align.paired import pair_records
    from thermite_tpu.io.bam import encode_bam_record
    from thermite_tpu.io.sam import unique_refs
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
    equal the referee.  -> (pairs, BAM of the first 2000 pairs)."""
    import torch

    pairs = paired_workload(index, N_READS // 2)
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
    """SAM records of the first reads == the reference oracle's."""
    from thermite_tpu.align.driver import align_read
    from thermite_tpu.io.sam import aln_to_sam_record, unmapped_sam_record

    sub = recs[:N_ORACLE]
    got = aligner.align_batch_emit(sub, False)
    lines = []
    for name, seq, qual in sub:
        alns = align_read(index, seq, opts, aligner.seeder)
        if not alns:
            lines.append(unmapped_sam_record(name, seq, qual).to_line())
        for i, aln in enumerate(alns):
            lines.append(aln_to_sam_record(index, name, seq, qual, aln,
                                           len(alns), i + 1).to_line())
    want = "".join(line + "\n" for line in lines).encode()
    log(f"  {len(sub)} reads: {len(lines)} SAM records, port == oracle: "
        f"{got == want}")
    check(got == want, "SAM records differ from the oracle's")


def phase_cli(index, tmp, recs):
    """The user entry points: save the index, then the port's CLI aligns
    a FASTQ to SAM from the loaded artifact; == the in-memory emit."""
    from thermite_tpu.io.sam import build_sam_header
    from thermite_tpu.testing.synth import write_fastq
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
    from thermite_tpu.testing.synth import write_fastq
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
    for name, (rc, same, s) in results.items():
        log(f"  {name}: rc {rc}, == in-memory: {same} ({s:.1f} s)")
        check(rc == 0 and same, f"{name} differs from its in-memory counterpart")


def run(kernels_only: bool = False) -> dict:
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
    _build.native_engine()
    log(f"  C++ host engine ready in {time.perf_counter() - t0:.1f} s")
    dev = torch.device("cuda", 0)
    log(f"phase 1 done in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    log("phase 2: packed stream kernel vs swg_stream_plain (bit-exact)")
    worst1, _ = phase_kernel(dev)
    log(f"phase 2 done in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    log("phase 2b: general-band stream kernel vs swg_stream_plain (bit-exact)")
    cases = general_band_cases()
    worst2, (ms2, plain_ms2) = phase_kernel_wide(dev, cases)
    log(f"phase 2b done in {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    log("phase 2c: forward-scores kernel vs swg_forward_plain (bit-exact)")
    worst3, (ms3, plain_ms3) = phase_kernel_forward(dev, cases)
    log(f"phase 2c done in {time.perf_counter() - t:.1f} s")
    del cases

    t = time.perf_counter()
    log("phase 2d: run-length traceback kernel vs its plain versions "
        "(bit-exact)")
    worst4, (ms4, plain_ms4) = phase_kernel_traceback(dev)
    log(f"phase 2d done in {time.perf_counter() - t:.1f} s")

    launches = {"swg_stream": None, "swg_stream_wide": None,
                "swg_forward": None, "swg_traceback": None}
    err = ms = plain_ms = None
    if not kernels_only:
        os.makedirs(os.path.join(ROOT, "data", "out"), exist_ok=True)
        with tempfile.TemporaryDirectory(
                dir=os.path.join(ROOT, "data", "out")) as tmp:
            t = time.perf_counter()
            log("phase 3: syn45 main path (BatchAligner.align_batch_emit, BAM)")
            index, opts, aligner, recs, warm, raw, launches["swg_stream"] = \
                phase_syn45(tmp)
            log(f"phase 3 done in {time.perf_counter() - t:.1f} s")

            t = time.perf_counter()
            log("phase 3b: syn45 at full band (narrow_band 0)")
            launches["swg_stream_wide"] = phase_full_band(index, opts, recs,
                                                          warm, raw)
            log(f"phase 3b done in {time.perf_counter() - t:.1f} s")
            del warm, raw

            t = time.perf_counter()
            log(f"phase 3c: syn45 without the C++ engine on {N_NO_NATIVE} reads")
            launches["swg_forward"] = phase_no_native(index, opts, aligner, recs)
            log(f"phase 3c done in {time.perf_counter() - t:.1f} s")

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
            err, ms, plain_ms, st = phase_cpp_referee(aligner, recs)
            log(f"phase 4 done in {time.perf_counter() - t:.1f} s")

            t = time.perf_counter()
            log("phase 4b: kernel 4 on its path, the phase 4 chunk at full "
                "band against kernel 2 and the scalar oracle")
            launches["swg_traceback"] = phase_traceback_path(aligner, st)
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

    def record(name, source, replaces, worst, k_ms, p_ms):
        return {"name": name, "route": "cuda",
                "source": f"thermite_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches[name],
                "max_abs_err": worst, "ms": k_ms, "plain_ms": p_ms}

    return {"kernels": [
        record("swg_stream", "swg_stream.cu",
               "thermite_tpu/ops/swg_pallas_packed.py:88",
               max(worst1, err or 0), ms, plain_ms),
        record("swg_stream_wide", "swg_stream_wide.cu",
               "thermite_tpu/ops/swg_pallas.py:409", worst2, ms2, plain_ms2),
        record("swg_forward", "swg_forward.cu",
               "thermite_tpu/ops/swg_pallas.py:185", worst3, ms3, plain_ms3),
        record("swg_traceback", "swg_traceback.cu",
               "thermite_tpu/ops/swg_pallas.py:244", worst4, ms4, plain_ms4),
    ]}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs only on a CUDA card", file=sys.stderr)
        return 2
    try:
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
